"""``mfu.prefill``: the useful model operations of the prompts whose prefill
ran in the traced window (``bench/roofline/mfu.py``) over the window's
seconds times the card's bfloat16 dense peak, in percent."""
from bench.roofline import mfu
from bench.roofline.peaks import BF16_FLOPS


def read(ctx):
    w = ctx.work
    if not w.get("prompt_lens") or ctx.trace is None:
        return None
    flop = sum(mfu.prefill_flop(ctx.config, n) for n in w["prompt_lens"])
    return 100.0 * flop / (ctx.trace.window_s * BF16_FLOPS)

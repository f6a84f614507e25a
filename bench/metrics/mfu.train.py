"""``mfu.train``: the useful model operations of the training steps that ran
in the traced window (``bench/roofline/mfu.py``) over the window's seconds
times the card's bfloat16 dense peak, in percent."""
from bench.roofline import mfu
from bench.roofline.peaks import BF16_FLOPS


def read(ctx):
    w = ctx.work
    if not w.get("steps") or ctx.trace is None:
        return None
    flop = w["steps"] * mfu.train_flop(ctx.config, w["batch"], w["seq"])
    return 100.0 * flop / (ctx.trace.window_s * BF16_FLOPS)

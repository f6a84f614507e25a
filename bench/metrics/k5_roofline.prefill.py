"""``k5_roofline.prefill``: K5's launches in the traced window, the sum of
each launch's roofline bound over the rows that hold a routed token
(``bench/roofline/k5.py``, from ``bench/probes/k5.py``'s records) over the
sum of K5's kernels' device time, in percent."""
from bench.roofline import k5
from bench.roofline.peaks import KERNEL_NAMES, bound_s


def read(ctx):
    recs = [r for r in ctx.launches.get("K5", []) if r["kind"] == "fwd"]
    if not recs or ctx.trace is None:
        return None
    bound = sum(bound_s(*k5.fwd(r)) for r in recs)
    device_s, n = ctx.trace.kernel_seconds(KERNEL_NAMES["K5"])
    if not n or device_s <= 0:
        return None
    return 100.0 * bound / device_s

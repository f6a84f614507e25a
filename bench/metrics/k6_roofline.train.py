"""``k6_roofline.train``: K6 and K6's backward together, the sum of each
launch's roofline bound (``bench/roofline/k6.py``, from the launch's
shapes as ``bench/probes/k6.py`` recorded them) over the sum of their
kernels' device time in the traced window, in percent."""
from bench.roofline import k6
from bench.roofline.peaks import KERNEL_NAMES, bound_s


def read(ctx):
    recs = ctx.launches.get("K6", [])
    if not recs or ctx.trace is None:
        return None
    bound = sum(bound_s(*(k6.fwd(r) if r["kind"] == "fwd" else k6.bwd(r)))
                for r in recs)
    device_s, n = ctx.trace.kernel_seconds(KERNEL_NAMES["K6"]
                                           + KERNEL_NAMES["K6 backward"])
    if not n or device_s <= 0:
        return None
    return 100.0 * bound / device_s

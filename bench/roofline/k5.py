"""K5 (the capacity-bundled expert GEMM, ``moe_gemm``) and its backward:
operations and bytes of one launch from a record of ``bench/probes/k5.py``
(nb, cap, d_in, d_out, n_experts, dtype, kept).

What the inputs need, not what the padding costs: the rows of the bundles
that hold a routed token (``kept``), not every slot up to each bundle's
capacity.  Forward: 2·kept·d_in·d_out; the kept rows of x and of the output
once, the expert weights once (every expert meets a bundle) and the int32
expert map.  Backward (dx and dw): twice that; x, w and dy read once, dx
and dw written once.  ``chip_smoke.py``'s counts are the same with every
slot in place of the kept rows.
"""
from __future__ import annotations

from bench.roofline.peaks import ELEMENT_BYTES, peak


def _kept(rec) -> int:
    return int(rec["kept"])


def fwd(rec) -> tuple:
    es = ELEMENT_BYTES[rec["dtype"]]
    kept, d_in, d_out = _kept(rec), rec["d_in"], rec["d_out"]
    flop = 2 * kept * d_in * d_out
    nbytes = (kept * d_in + rec["n_experts"] * d_in * d_out
              + kept * d_out) * es + rec["nb"] * 4
    return flop, nbytes, peak(rec["dtype"])


def bwd(rec) -> tuple:
    es = ELEMENT_BYTES[rec["dtype"]]
    kept, d_in, d_out = _kept(rec), rec["d_in"], rec["d_out"]
    w = rec["n_experts"] * d_in * d_out
    flop = 2 * 2 * kept * d_in * d_out
    nbytes = 2 * (kept * d_in + w) * es + kept * d_out * es
    return flop, nbytes, peak(rec["dtype"])

"""K6 (the chunked RWKV6 WKV, ``rwkv6_scan``) and its backward: operations
and bytes of one launch from its shapes (a record of ``bench/probes/k6.py``:
b, h, t, kk, vv, chunk, r_dtype, w_dtype).

Forward, as ``chip_smoke.py``'s ``k6_times``: 2·B·H·T·K·V for the state
products and 2·B·H·T·C·(K + V) for the chunk-local pairs; r, k, v, w and u
read once, o and the final state (float32) written once.  Backward, as its
``k6_bwd_flop`` and ``k6_backward_times``: per chunk the pairs s < t for A,
dr and dk (6 per channel), the pairs s <= t for dA and Aᵀdo (4 per value
column) and 10·C·K·V for the chunk's state products; r, k, v, w, u and do
read once, dr, dk, dv, dw and du written once.
"""
from __future__ import annotations

from bench.roofline.peaks import ELEMENT_BYTES, peak


def fwd(rec) -> tuple:
    """``(flop, bytes, peak)`` of one forward launch."""
    b, h, t, kk, vv, c = (rec[k] for k in ("b", "h", "t", "kk", "vv",
                                           "chunk"))
    es, ws = ELEMENT_BYTES[rec["r_dtype"]], ELEMENT_BYTES[rec["w_dtype"]]
    flop = 2 * b * h * t * kk * vv + 2 * b * h * t * c * (kk + vv)
    nbytes = (2 * b * h * t * kk + b * h * t * vv) * es \
        + b * h * t * kk * ws + h * kk * 4 + b * h * t * vv * 4 \
        + b * h * kk * vv * 4
    return flop, nbytes, peak(rec["r_dtype"])


def bwd_flop(b: int, h: int, t: int, kk: int, vv: int, chunk: int) -> int:
    c = chunk
    per_chunk = c * (c - 1) // 2 * 6 * kk + c * (c + 1) * 2 * vv \
        + 10 * c * kk * vv
    return b * h * (t // c) * per_chunk


def bwd(rec) -> tuple:
    """``(flop, bytes, peak)`` of one backward launch."""
    b, h, t, kk, vv, c = (rec[k] for k in ("b", "h", "t", "kk", "vv",
                                           "chunk"))
    es, ws = ELEMENT_BYTES[rec["r_dtype"]], ELEMENT_BYTES[rec["w_dtype"]]
    inputs = (2 * b * h * t * kk + b * h * t * vv) * es \
        + b * h * t * kk * ws + h * kk * 4
    nbytes = 2 * inputs + b * h * t * vv * 4
    if rec.get("dstate"):
        nbytes += b * h * kk * vv * 4
    return bwd_flop(b, h, t, kk, vv, c), nbytes, peak(rec["r_dtype"])

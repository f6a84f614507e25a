"""K4 (``flash_attention``) and its backward: operations and bytes of one
launch from its shapes (b, h, hkv, s, d, pairs, dtype), ``pairs`` the
visible (query, key) pairs of one head (``pairs`` of a causal mask of S:
S·(S + 1)/2).

Forward, as ``chip_smoke.py``'s ``time_k4``: 4·B·H·pairs·D; q read and the
output written once, k and v read once.  Backward, as its K4 backward
times: 5·2·B·H·pairs·D (the dq pass and the dk/dv pass, the logits formed
again in each); q, do, out and k, v read once, dq, dk, dv written once.
"""
from __future__ import annotations

from bench.roofline.peaks import ELEMENT_BYTES, peak


def causal_pairs(s: int, window: int = 0) -> int:
    if window and window < s:
        return window * (window + 1) // 2 + (s - window) * window
    return s * (s + 1) // 2


def fwd(rec) -> tuple:
    es = ELEMENT_BYTES[rec["dtype"]]
    b, h, hkv, s, d = (rec[k] for k in ("b", "h", "hkv", "s", "d"))
    flop = 4 * b * h * rec["pairs"] * d
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * es
    return flop, nbytes, peak(rec["dtype"])


def bwd(rec) -> tuple:
    es = ELEMENT_BYTES[rec["dtype"]]
    b, h, hkv, s, d = (rec[k] for k in ("b", "h", "hkv", "s", "d"))
    q, kv = b * h * s * d, b * hkv * s * d
    flop = 5 * 2 * b * h * rec["pairs"] * d
    nbytes = (3 * q + 2 * kv) * es + (q + 2 * kv) * es
    return flop, nbytes, peak(rec["dtype"])

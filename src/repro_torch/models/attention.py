"""Attention: flash attention (train/prefill) and the decode path.

Port of ``repro.models.attention``.  The reference's models call a
blocked pure-jnp flash attention (``flash_attention_jnp``) and name the
Pallas kernel as the hot path on real hardware; here ``flash_attention``
goes through ``kernels.ops.flash_attention``: kernel K4 on the card, its
plain version on the host.  Both compute the same masked softmax.  The
plain version and K4's float32 kernel keep the probabilities in float32
for the PV product, as the Pallas kernel does; K4's bfloat16 kernel rounds
them to bfloat16 first, as ``flash_attention_jnp`` does (equal in float32,
one rounding apart in bfloat16).

Shapes: q (B, H, S, D); k, v (B, Hkv, S, D); GQA by ``h // (H / Hkv)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import ops as kops
from .layers import softcap

NEG_INF = -1e30


class AttnSpec(NamedTuple):
    causal: bool = True
    window: int = 0          # 0 = global
    softcap: float = 0.0
    scale: Optional[float] = None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    spec: AttnSpec, *, bq: int = 1024,
                    bk: int = 1024) -> torch.Tensor:
    """Counterpart of ``flash_attention_jnp``: the same block-size
    assertion (S a multiple of ``min(1024, S)``), then K4 (or its plain
    version on the host) over the whole sequence."""
    s_len = q.shape[2]
    bq, bk = min(bq, s_len), min(bk, s_len)
    if s_len % bq or s_len % bk:
        raise ValueError(f"sequence length {s_len} is not a multiple of the "
                         f"attention blocks ({bq}, {bk}), as the reference "
                         "requires")
    return kops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=spec.causal,
                                window=spec.window, softcap=spec.softcap,
                                scale=spec.scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Single-token attention against a (possibly ring) KV cache.

    q: (B, H, 1, D); caches: (B, Hkv, S_cache, D); ``slot_pos``: (S_cache,)
    or per-row (B, S_cache) absolute position stored in each cache slot
    (-1 = empty; ring caches overwrite slots mod window, so slot index ≠
    position); ``pos``: () scalar or per-row (B,).  Plain torch: the
    reference has no kernel for it.
    """
    b, h, _, d = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    scale = spec.scale if spec.scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) * scale
    if spec.softcap > 0:
        s = softcap(s, spec.softcap)
    s_cache = k_cache.shape[2]
    slot_pos = slot_pos.expand(b, s_cache)
    pos = torch.as_tensor(pos, device=q.device).expand(b)[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if spec.window > 0:
        valid &= slot_pos > pos - spec.window
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(b, h, 1, d).to(q.dtype)

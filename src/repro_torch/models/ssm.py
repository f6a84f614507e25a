"""SSM / linear-recurrence mixers: the chunked RWKV6 WKV and its decode step.

Port of ``repro.models.ssm``.  ``rwkv6_chunked`` is the counterpart of the
reference's ``rwkv6_chunked_jnp`` (which mirrors the Pallas kernel's math
and names it the TPU hot path): it goes through ``kernels.ops.rwkv6``,
kernel K6 on the card (under grad with K6's backward kernel) and its plain
version on the host, and returns the output and the final state.  Hymba's
SSM heads use the same recurrence with ``u = 0``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops as kops


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r,k,w: (B,H,T,K); v: (B,H,T,V); u: (H,K). fp32 out.

    Returns ``(o (B,H,T,V), final state (B,H,K,V))``.  T must be a multiple
    of ``min(chunk, T)``, as the reference asserts."""
    t = r.shape[2]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"T = {t} is not a multiple of chunk {chunk}, as "
                         "the reference requires")
    return kops.rwkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                      w.contiguous(), u, chunk=chunk)


def rwkv6_decode_step(r_t: torch.Tensor, k_t: torch.Tensor,
                      v_t: torch.Tensor, w_t: torch.Tensor, u: torch.Tensor,
                      state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. r_t,k_t,w_t: (B,H,K); v_t: (B,H,V); state: (B,H,K,V)."""
    r32, k32, v32, w32 = (x.float() for x in (r_t, k_t, v_t, w_t))
    kv = k32[..., :, None] * v32[..., None, :]          # (B,H,K,V)
    o = torch.einsum("bhk,bhkv->bhv", r32,
                     state + u.float()[None, :, :, None] * kv)
    state = w32[..., :, None] * state + kv
    return o, state

"""Kernel K6: chunked RWKV6 (Finch) WKV scan.

RWKV6's WKV is a linear recurrence with data-dependent per-channel decay,
per (batch, head):

    o_t = r_t @ (S_{t-1} + (u ⊙ k_t)ᵀ v_t),   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

Time is cut into chunks: the intra-chunk part is a dense (C × C) product,
the state crosses chunks in order.  Every decay factor is the exponential
of a difference of cumulative log decays (never a ratio), so no w ∈ (0, 1)
overflows.  Returns ``(o, final_state)``, both float32: the model fills its
decode cache with the state at prefill.

K6 replaces the Pallas TPU kernel ``rwkv6`` in
``src/repro/kernels/rwkv6_scan.py:67`` (``pl.pallas_call`` at :90), which
returns ``o`` only.  The CUDA C++ source is ``csrc/rwkv6_scan.cu``, built by
``_build`` and bound with ctypes.  Bound on an H100: the Pallas cost
estimate's ``2·T·K·V + 2·T·C·(K+V)`` FLOP per (b, h) against r, k, w, v read
once and o and the state written once; both are microseconds at
hymba-1.5b's SSM heads, so what sets the time is how much of the chunk axis
runs in parallel.  Only the state carry is sequential, and it is linear
(``S_c = diag(d_c) S_{c-1} + U_c``), so K6 runs three kernels: the
chunk-local terms, one block per (b, h, chunk); a scan of the (K × V) state
over the chunks, one thread per state element; the inter-chunk term
``(r·e^{ecum}) S_{c-1}``, one block per (b, h, chunk).  The wrapper
allocates their scratch.

``rwkv6`` dispatches on the tensors' device: CPU tensors run
``rwkv6_plain`` (the torch twin of the reference's ``rwkv6_chunked_jnp``);
CUDA tensors launch K6 or raise.  ``rwkv6.launches`` counts calls that
launched K6: one per call of the wrapper, though K6 is three kernel
launches on the stream.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..device import launch_target
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64      # K6 holds a chunk's C × C and C × K arrays on chip
MAX_K = 64


def _chunk(t: int, chunk: int) -> int:
    """The reference's ``min(chunk, T)``, which must divide T."""
    chunk = min(chunk, t)
    if chunk < 1 or t % chunk:
        raise ValueError(f"T = {t} is not a multiple of chunk {chunk}")
    return chunk


def rwkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: ``rwkv6_chunked_jnp`` in torch ops.

    r, k, w: (B, H, T, K); v: (B, H, T, V); u: (H, K).  Returns
    ``(o (B, H, T, V), state (B, H, K, V))`` in float32."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    chunk = _chunk(t, chunk)
    nc = t // chunk

    def to_chunks(x):
        return x.float().reshape(b, h, nc, chunk, x.shape[-1])

    r_, k_, v_, w_ = map(to_chunks, (r, k, v, w))
    u32 = u.float()
    logw = torch.log(w_)
    cum = torch.cumsum(logw, dim=3)                  # (B,H,NC,C,K) inclusive
    ecum = cum - logw                                # exclusive
    idx = torch.arange(chunk, device=r.device)
    lower = (idx[:, None] > idx[None, :])[:, :, None]    # (C, C, 1): s < t
    state = torch.zeros((b, h, kk, vv), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nc):
        rc, kc, vc = r_[:, :, c], k_[:, :, c], v_[:, :, c]
        cumc, ecumc = cum[:, :, c], ecum[:, :, c]
        o = torch.einsum("bhck,bhkv->bhcv", rc * torch.exp(ecumc), state)
        expo = ecumc[:, :, :, None, :] - cumc[:, :, None, :, :]
        expo = expo.masked_fill(~lower, float("-inf"))
        a = (rc[:, :, :, None, :] * kc[:, :, None, :, :]
             * torch.exp(expo)).sum(-1)                  # (B,H,C,C)
        o = o + torch.einsum("bhts,bhsv->bhtv", a, vc)
        bonus = (rc * u32[None, :, None, :] * kc).sum(-1, keepdim=True)
        o = o + bonus * vc
        decay_all = torch.exp(cumc[:, :, -1, :])         # (B,H,K)
        kd = kc * torch.exp(cumc[:, :, -1:, :] - cumc)
        state = decay_all[..., None] * state + torch.einsum(
            "bhck,bhcv->bhkv", kd, vc)
        outs.append(o)
    return torch.stack(outs, dim=2).reshape(b, h, t, vv), state


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("rwkv6_scan", "rwkv6_scan",
                       [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p,
                        i])


def _launch(r, k, v, w, u, o, state, chunk: int) -> None:
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    if chunk > MAX_CHUNK or kk > MAX_K:
        raise ValueError(f"K6 takes chunk <= {MAX_CHUNK} and K <= {MAX_K}, "
                         f"got chunk {chunk}, K {kk}")
    if r.dtype not in _DTYPE_CODE or not (r.dtype == k.dtype == v.dtype) \
            or w.dtype not in _DTYPE_CODE:
        raise ValueError("K6 takes r, k, v all float32 or all bfloat16 and w "
                         f"float32 or bfloat16, got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}, {w.dtype}")
    for x in (r, k, v, w, u):
        if not x.is_contiguous() or x.device != o.device:
            raise ValueError("K6 operands must be contiguous tensors on one "
                             "device")
    nc = t // chunk
    # r·e^{ecum} (B,H,T,K), each chunk's decay (B,H,NC,K) and its state
    # contribution (B,H,NC,K,V), which the scan overwrites with the state
    # entering the chunk
    scratch = torch.empty(b * h * (t * kk + nc * kk + nc * kk * vv),
                          dtype=torch.float32, device=o.device)
    lib = _lib()
    err = lib.rwkv6_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         w.data_ptr(), u.data_ptr(), o.data_ptr(),
                         state.data_ptr(), scratch.data_ptr(), b, h, t, kk,
                         vv, chunk,
                         _DTYPE_CODE[r.dtype], _DTYPE_CODE[w.dtype],
                         *launch_target(o.device))
    _build.check_launch(lib, err, "rwkv6_scan")
    rwkv6.launches += 1


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *, chunk: int = 32
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r, k, w: (B, H, T, K); v: (B, H, T, V); u: (H, K); T a
    multiple of ``min(chunk, T)``.

    Returns ``(o (B, H, T, V), final state (B, H, K, V))``, float32, on
    r's device.  CPU tensors run the plain version; CUDA tensors launch K6
    or raise (also when a gradient is asked for: K6 has no backward kernel
    yet).
    """
    b, h, t, kk = r.shape
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3] \
            or tuple(u.shape) != (h, kk):
        raise ValueError(f"incompatible r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")
    chunk = _chunk(t, chunk)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    _build.refuse_grad("K6 (rwkv6)", r, k, v, w, u)
    vv = v.shape[-1]
    o = torch.empty((b, h, t, vv), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kk, vv), dtype=torch.float32, device=r.device)
    if o.numel():
        _launch(r, k, v, w, u.to(r.device, torch.float32).contiguous(), o,
                state, chunk)
    return o, state


rwkv6.launches = 0

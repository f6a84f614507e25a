"""Kernel K6: chunked RWKV6 (Finch) WKV scan, and its backward.

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

K6's backward (``rwkv6_bwd``): ``rwkv6`` on CUDA tensors under grad mode
goes through ``_Rwkv6``, a ``torch.autograd.Function`` whose forward
launches K6 as above and whose backward launches the kernels of
``csrc/rwkv6_scan_bwd.cu`` on one of two routes, picked by ``bwd_route``
from the shape before launch and counted in ``rwkv6_bwd.routes``:

* ``"mma"`` (bfloat16 r, k, v, as every training path passes them; K a
  multiple of 8, the chunk a multiple of 16): a light pass for each
  chunk's ``Q_c``, ``U_c`` and decay, the scans of the states forward and of
  their gradients backward, and one fused pass for everything else of the
  chunk on the TF32 tensor cores, every pair term factored through the
  boundaries of 16-token sub-chunks; the intra-chunk partials never leave
  the block;
* ``"fma"`` (float32 r, k, v and other shapes): the first design, a
  chunk-local pass (the intra-chunk parts of dr, dk, dv and dw to scratch),
  the scans, an inter-chunk pass, in IEEE FMAs.

Both end with the sum of du, use no atomics, and form dw without dividing
by w, where the plain version's autograd divides a difference of two sums by
w (see the source's header).  Neither falls back to the other or to the
plain version.  It replaces the XLA autodiff of the reference's
``rwkv6_chunked_jnp`` (``src/repro/models/ssm.py:17``), which the
reference's models train through (the reference has no backward Pallas
kernel).  Its plain version is ``rwkv6_plain``'s autograd
(``rwkv6_bwd_plain``).

``rwkv6`` and ``rwkv6_bwd`` dispatch on the tensors' device: CPU tensors
run ``rwkv6_plain`` (the torch twin of the reference's
``rwkv6_chunked_jnp``) and its autograd; CUDA tensors launch the kernels or
raise.  ``rwkv6.launches`` counts calls that launched K6 (one per call,
though K6 is three kernel launches on the stream), ``rwkv6_bwd.launches``
calls that launched its backward (four kernel launches on either route).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..device import launch_target
from . import _build, _meta

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
    ``(o (B, H, T, V), state (B, H, K, V))`` in float32, or in float64 where
    r is float64 (a reference for the kernels' float32 sums)."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    chunk = _chunk(t, chunk)
    nc = t // chunk
    acc = torch.float64 if r.dtype == torch.float64 else torch.float32

    def to_chunks(x):
        return x.to(acc).reshape(b, h, nc, chunk, x.shape[-1])

    r_, k_, v_, w_ = map(to_chunks, (r, k, v, w))
    u32 = u.to(acc)
    logw = torch.log(w_)
    cum = torch.cumsum(logw, dim=3)                  # (B,H,NC,C,K) inclusive
    ecum = cum - logw                                # exclusive
    idx = torch.arange(chunk, device=r.device)
    lower = (idx[:, None] > idx[None, :])[:, :, None]    # (C, C, 1): s < t
    state = torch.zeros((b, h, kk, vv), dtype=acc, device=r.device)
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


def rwkv6_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                    dstate: Optional[torch.Tensor] = None, *,
                    chunk: int = 32):
    """Plain version of K6's backward: ``(dr, dk, dv, dw, du)`` of
    ``(o, state) = rwkv6_plain(r, k, v, w, u)`` against the cotangents
    ``do`` and ``dstate`` (none: the state is not used), by autograd; each
    in its input's dtype.  The CPU path differentiates the plain version
    itself; this is what ``chip_smoke.py`` and the card tests hold the
    kernel to (on float64 copies, where its dw is exact to float32)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u)]
        o, state = rwkv6_plain(*leaves, chunk=chunk)
        outs, cots = [o], [do.to(o.dtype)]
        if dstate is not None:
            outs.append(state)
            cots.append(dstate.to(state.dtype))
        return torch.autograd.grad(outs, leaves, cots)


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("rwkv6_scan", "rwkv6_scan",
                       [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p,
                        i])


def _bwd_lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    _build.bind("rwkv6_scan_bwd", "rwkv6_scan_bwd_mma",
                [p] * 13 + [i] * 7 + [p, i])
    return _build.bind("rwkv6_scan_bwd", "rwkv6_scan_bwd",
                       [p] * 13 + [i] * 8 + [p, i])


def bwd_route(dtype: torch.dtype, kk: int, chunk: int) -> str:
    """The kernels K6's backward takes, from the shape before launch:
    ``"mma"`` (TF32 tensor cores, sub-chunks of 16 tokens) for bfloat16 r,
    k, v with K a multiple of 8 up to ``MAX_K`` and a chunk a multiple of 16
    up to ``MAX_CHUNK``; ``"fma"`` (the first design, IEEE FMAs) for float32
    r, k, v and other shapes."""
    if dtype == torch.bfloat16 and kk % 8 == 0 and 0 < kk <= MAX_K \
            and chunk % 16 == 0 and 0 < chunk <= MAX_CHUNK:
        return "mma"
    return "fma"


def _check_k6(r, k, v, w, u, device, chunk: int) -> None:
    """What K6's kernels take: chunk <= ``MAX_CHUNK``, K <= ``MAX_K``, r, k,
    v all float32 or all bfloat16, w float32 or bfloat16, u float32,
    contiguous tensors on ``device``."""
    kk = r.shape[-1]
    if chunk > MAX_CHUNK or kk > MAX_K:
        raise ValueError(f"K6 takes chunk <= {MAX_CHUNK} and K <= {MAX_K}, "
                         f"got chunk {chunk}, K {kk}")
    if r.dtype not in _DTYPE_CODE or not (r.dtype == k.dtype == v.dtype) \
            or w.dtype not in _DTYPE_CODE or u.dtype != torch.float32:
        raise ValueError("K6 takes r, k, v all float32 or all bfloat16, w "
                         f"float32 or bfloat16 and u float32, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}, {w.dtype}, {u.dtype}")
    for x in (r, k, v, w, u):
        if not x.is_contiguous() or x.device != device:
            raise ValueError("K6 operands must be contiguous tensors on one "
                             "device")


def _launch(r, k, v, w, u, o, state, chunk: int) -> None:
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    _check_k6(r, k, v, w, u, o.device, chunk)
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


def _k6(r, k, v, w, u, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's ``(o, state)`` on the card (a launch unless o is empty); u
    float32."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    o = torch.empty((b, h, t, vv), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, kk, vv), dtype=torch.float32, device=r.device)
    if o.numel():
        _launch(r, k, v, w, u, o, state, chunk)
    return o, state


def _k6_bwd(r, k, v, w, u, do, dstate, chunk: int, *,
            route: Optional[str] = None):
    """K6's backward on the card: ``(dr, dk, dv, dw, du)``, dr, dk, dv in
    r's dtype, dw in w's, du float32.  u, do and dstate (or None) float32
    and contiguous.  ``route`` is ``bwd_route``'s pick unless given (a
    study may time the ``"fma"`` route on bfloat16 inputs; ``"mma"`` takes
    bfloat16 r, k, v only).  Scratch, float32: each chunk's decay, U_c then
    the state entering it, Q_c then the gradient of the state leaving it,
    and each chunk's share of du; the ``"fma"`` route also the intra-chunk
    parts of dr, dk, dw and dv and db (B·H·T·(3K + V + 1) floats more)."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    _check_k6(r, k, v, w, u, r.device, chunk)
    for x in (do, dstate):
        if x is not None and (x.dtype != torch.float32
                              or not x.is_contiguous()
                              or x.device != r.device):
            raise ValueError("K6's backward takes do and dstate float32 and "
                             "contiguous on r's device")
    route = route or bwd_route(r.dtype, kk, chunk)
    if route == "mma" and bwd_route(r.dtype, kk, chunk) != "mma":
        raise ValueError(f"K6's backward route 'mma' takes bfloat16 r, k, v, "
                         f"K a multiple of 8 and a chunk a multiple of 16, "
                         f"got {r.dtype}, K {kk}, chunk {chunk}")
    if route not in ("mma", "fma"):
        raise ValueError(f"unknown route {route!r}")
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.zeros((h, kk), dtype=torch.float32, device=r.device)
    if not (r.numel() and v.numel()):
        return dr.zero_(), dk.zero_(), dv.zero_(), dw.zero_(), du
    nc = t // chunk
    partials = t * (3 * kk + vv + 1) if route == "fma" else 0
    scratch = torch.empty(b * h * (nc * kk * (1 + 2 * vv) + partials
                                   + nc * kk),
                          dtype=torch.float32, device=r.device)
    lib = _bwd_lib()
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), do.data_ptr(),
            None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            scratch.data_ptr(), b, h, t, kk, vv, chunk)
    if route == "mma":
        err = lib.rwkv6_scan_bwd_mma(*args, _DTYPE_CODE[w.dtype],
                                     *launch_target(r.device))
    else:
        err = lib.rwkv6_scan_bwd(*args, _DTYPE_CODE[r.dtype],
                                 _DTYPE_CODE[w.dtype],
                                 *launch_target(r.device))
    _build.check_launch(lib, err, f"rwkv6_scan_bwd ({route})")
    rwkv6_bwd.launches += 1
    rwkv6_bwd.routes[route] = rwkv6_bwd.routes.get(route, 0) + 1
    return dr, dk, dv, dw, du


def _check_shapes(r, k, v, w, u) -> None:
    b, h, t, kk = r.shape
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3] \
            or tuple(u.shape) != (h, kk):
        raise ValueError(f"incompatible r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}")


def rwkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
              dstate: Optional[torch.Tensor] = None, *, chunk: int = 32):
    """K6's backward: ``(dr, dk, dv, dw, du)`` of ``rwkv6(r, k, v, w, u)``
    whose output met ``do`` (B, H, T, V) and whose final state met
    ``dstate`` (B, H, K, V; None where the state is not used).  CPU tensors
    run ``rwkv6_bwd_plain``; CUDA tensors launch the kernels of
    ``csrc/rwkv6_scan_bwd.cu`` or raise.  Each gradient in its input's
    dtype.  ``rwkv6``'s autograd calls the kernel; ``rwkv6_bwd.launches``
    counts the calls that launched it, ``rwkv6_bwd.routes`` them by route
    (``bwd_route``)."""
    b, h, t, kk = r.shape
    _check_shapes(r, k, v, w, u)
    vv = v.shape[-1]
    if tuple(do.shape) != (b, h, t, vv) or (
            dstate is not None and tuple(dstate.shape) != (b, h, kk, vv)):
        raise ValueError(f"do {tuple(do.shape)} or dstate "
                         f"{None if dstate is None else tuple(dstate.shape)}"
                         f" does not match r {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}")
    chunk = _chunk(t, chunk)
    if r.device.type == "cpu":
        return rwkv6_bwd_plain(r, k, v, w, u, do, dstate, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    dr, dk, dv, dw, du = _k6_bwd(
        r, k, v, w, u.to(r.device, torch.float32).contiguous(),
        do.float().contiguous(),
        None if dstate is None else dstate.float().contiguous(), chunk)
    return dr, dk, dv, dw, du.to(u.dtype)


rwkv6_bwd.launches = 0
rwkv6_bwd.routes = {}


class _Rwkv6(torch.autograd.Function):
    """K6 with its backward kernel: the forward launches K6 as it is (its
    outputs bit-identical to a call without grad, nothing kept but the
    inputs), the backward launches K6's backward (``_k6_bwd``).  An output
    that met no gradient is taken as zero (``dstate`` None: the final state
    unused); inputs that need none get None.  CUDA tensors only; u float32."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, w, u)
        return _k6(r, k, v, w, u, chunk)

    @staticmethod
    def backward(ctx, do, dstate):
        if do is None and dstate is None:
            return None, None, None, None, None, None
        r, k, v, w, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros((*r.shape[:3], v.shape[-1]), dtype=torch.float32,
                             device=r.device)
        grads = _k6_bwd(r, k, v, w, u, do.contiguous(),
                        None if dstate is None else dstate.contiguous(),
                        ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *, chunk: int = 32
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r, k, w: (B, H, T, K); v: (B, H, T, V); u: (H, K); T a
    multiple of ``min(chunk, T)``.

    Returns ``(o (B, H, T, V), final state (B, H, K, V))``, float32, on
    r's device.  CPU tensors run the plain version (autograd differentiates
    it); CUDA tensors launch K6 or raise, and under grad mode with an input
    requiring grad go through ``_Rwkv6``, whose backward is K6's backward
    kernel.  ``meta`` tensors (the dry run) get a fake result of K6's
    shapes and FLOP (``kernels._meta``).
    """
    _check_shapes(r, k, v, w, u)
    chunk = _chunk(r.shape[2], chunk)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type == "meta":
        return _meta.rwkv6(r, k, v, w, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    u32 = u.to(r.device, torch.float32).contiguous()
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, w, u32)):
        return _Rwkv6.apply(r, k, v, w, u32, chunk)
    return _k6(r, k, v, w, u32, chunk)


rwkv6.launches = 0

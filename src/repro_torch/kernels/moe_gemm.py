"""Kernel K5: capacity-bundled expert GEMM (the MoE dispatch executor).

    out[b] = x_bundles[b] @ w[bundle_expert[b]]

``x_bundles`` (nb, cap, d_in) are the RIR bundles a ``MoeDispatchPlan``
packs, ``w`` (E, d_in, d_out) the stacked expert weights, and
``bundle_expert`` (nb,) the plan's schedule: which expert each bundle
meets.  Accumulation is fp32; the output has x's dtype.

Replaces the Pallas TPU kernel ``moe_gemm`` in
``src/repro/kernels/moe_gemm.py:43`` (``pl.pallas_call`` at :65, entry
``moe_gemm_schedule`` at :78).  The CUDA C++ source is ``csrc/moe_gemm.cu``,
built by ``_build`` and bound with ctypes.

Bound on an H100: ``2·nb·cap·d_in·d_out`` FLOP against x and the experts'
weights read once and the output written once.  At DBRX-132B's width
(d_model 6144, d_ff_expert 10752, 16 experts) a prefill of 4096 tokens has
cap = 1280 and is bound by operations (2.7 TFLOP per gate or up product);
a decode step of 64 tokens has cap = 24 and is bound by the 4.2 GB of one
weight stack (1.26 ms at 3.35 TB/s).  So K5 reads every weight element
once per row tile and picks its row tile from cap (16, 32, 64 or 128
rows): the decode step is one 32-row tile per bundle, and the weights
cross the memory bus once.  float32 row tiles of 64 and 128 run in 3xTF32
on ``wgmma`` (each operand split once per block into two TF32 halves,
three TF32 products per product, 32-deep slices through a ``cp.async``
ring, the tensor cores' partial sums carried into the accumulator with
IEEE adds every slice); row tiles of 16 and 32 (decode) stream
the weight rows through IEEE FMAs with many loads in flight.  bfloat16
runs ``mma.sync`` on bfloat16 with fp32 accumulation and one rounding on
store.

``moe_gemm`` / ``moe_gemm_schedule`` dispatch on the tensors' device: CPU
tensors run ``moe_gemm_plain``; CUDA tensors launch the kernel or raise.
``moe_gemm.launches`` counts kernel launches and ``moe_gemm.uploads`` the
uploads of an expert map.  A dispatch plan's schedule bundle keeps the
device copy of its map (as ``K2Schedule.device_ids`` does), so the warm
calls of one plan upload nothing; a bare array is uploaded on every call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.rir import ScheduleBundle
from ..device import launch_target, to_device
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILES = (16, 32, 64, 128)
MAX_BUNDLES = 65535         # the grid's z extent


def row_tile(cap: int) -> int:
    """The smallest row tile that holds ``cap`` rows, at most 128."""
    return next((bm for bm in ROW_TILES if cap <= bm), ROW_TILES[-1])


def moe_gemm_plain(x_bundles: torch.Tensor, w: torch.Tensor,
                   bundle_expert: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: gather the experts, fp32 ``einsum``."""
    return torch.einsum("bcd,bdf->bcf", x_bundles.float(),
                        w[bundle_expert.long()].float()).to(x_bundles.dtype)


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("moe_gemm", "moe_gemm",
                       [p, p, p, i, i, i, i, i, i, p, p, i])


def _device_map(bundle_expert, be: np.ndarray,
                device: torch.device) -> torch.Tensor:
    """``be`` (the host ids of ``bundle_expert``) on ``device``.  A
    schedule bundle keeps its copy per device, uploaded on first use,
    outside its fields; anything else is uploaded now."""
    if not isinstance(bundle_expert, ScheduleBundle):
        moe_gemm.uploads += 1
        return to_device(be, device)
    memo = bundle_expert.__dict__.setdefault("_device_bundle_expert", {})
    key = str(device)
    if key not in memo:
        memo[key] = to_device(be, device)
        moe_gemm.uploads += 1
    return memo[key]


def _launch(x: torch.Tensor, w: torch.Tensor, bundle_expert, be: np.ndarray,
            out: torch.Tensor) -> None:
    nb, cap, d_in = x.shape
    d_out = w.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if d_in % 4 or d_out % 4 or nb > MAX_BUNDLES:
        raise ValueError(f"K5 needs d_in and d_out divisible by 4 and at "
                         f"most {MAX_BUNDLES} bundles, got nb={nb}, "
                         f"d_in={d_in}, d_out={d_out}")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16 \
                or t.device != out.device:
            raise ValueError("K5 operands must be contiguous, 16-byte "
                             "aligned tensors on one device")
    ids = _device_map(bundle_expert, be, out.device)
    lib = _lib()
    err = lib.moe_gemm(x.data_ptr(), w.data_ptr(), ids.data_ptr(), nb, cap,
                       d_in, d_out, row_tile(cap), _DTYPE_CODE[x.dtype],
                       out.data_ptr(), *launch_target(out.device))
    _build.check_launch(lib, err, "moe_gemm")
    moe_gemm.launches += 1


def _host_ids(x) -> np.ndarray:
    if isinstance(x, ScheduleBundle):
        x = x["bundle_expert"]
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x)).astype(np.int32, copy=False)


def moe_gemm(x_bundles: torch.Tensor, w: torch.Tensor, bundle_expert, *,
             bk: int = 512, bf: int = 512) -> torch.Tensor:
    """out[b] = x_bundles[b] @ w[bundle_expert[b]].

    x_bundles: (nb, cap, d_in); w: (E, d_in, d_out) of x's dtype;
    bundle_expert: (nb,) expert ids, read on the host to check their range
    (pass numpy or a CPU tensor), or a dispatch plan's schedule bundle,
    which keeps the ids' device copy.  Returns (nb, cap, d_out) in x's dtype
    on x's device.  ``bk`` / ``bf`` are the reference's tile arguments:
    they must divide d_in / d_out (after clipping to them) as there, and
    K5 does not tile by them.  CPU tensors run the plain version; CUDA
    tensors launch K5 or raise.
    """
    nb, cap, d_in = x_bundles.shape
    n_experts, w_in, d_out = w.shape
    bk, bf = min(bk, d_in), min(bf, d_out)
    if d_in % bk or d_out % bf:
        raise AssertionError((d_in, bk, d_out, bf))
    if w_in != d_in:
        raise ValueError(f"x has d_in {d_in}, w {tuple(w.shape)}")
    if x_bundles.dtype != w.dtype:
        raise ValueError(f"x and w dtypes differ: {x_bundles.dtype}, "
                         f"{w.dtype}")
    be = _host_ids(bundle_expert)
    if be.shape != (nb,):
        raise ValueError(f"bundle_expert must be ({nb},), got {be.shape}")
    if nb and (be.min() < 0 or be.max() >= n_experts):
        raise ValueError(f"bundle_expert must be in [0, {n_experts})")
    if x_bundles.device.type == "cpu":
        return moe_gemm_plain(x_bundles, w, torch.from_numpy(be))
    if x_bundles.device.type != "cuda":
        raise ValueError(f"unsupported device {x_bundles.device}")
    out = torch.empty((nb, cap, d_out), dtype=x_bundles.dtype,
                      device=x_bundles.device)
    if out.numel():
        _launch(x_bundles, w, bundle_expert, be, out)
    return out


moe_gemm.launches = 0
moe_gemm.uploads = 0


def moe_gemm_schedule(schedule, x_bundles: torch.Tensor, w: torch.Tensor, *,
                      bk: int = 512, bf: int = 512) -> torch.Tensor:
    """Drive K5 from a ``MoeDispatchPlan``'s schedule bundle: its
    ``bundle_expert`` array is the kernel's expert map, so a cached
    dispatch plan replays onto fresh bundles with no re-routing (and, on
    the card, with no upload: the bundle keeps the map's device copy)."""
    return moe_gemm(x_bundles, w, schedule, bk=bk, bf=bf)

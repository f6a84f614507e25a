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
the weight rows through IEEE FMAs with many loads in flight.

bfloat16 (fp32 accumulation, one rounding on store) takes one of three
routes, picked from the shape by ``bf16_route`` before launch and counted
in ``moe_gemm.routes``:

* ``wgmma_tiles`` (cap > 32; DBRX's prefill, bound by operations): TMA
  loads x and w into a 4-stage ring of 64-deep slices (128-byte swizzle,
  rows past cap read as zeros), one producer warp, two consumer
  warpgroups on ``wgmma`` m64n256k16 with w's [k][n] tiles taken as they
  are (MN-major B); a block computes two 64-row tiles of one expert (from
  one bundle or two) by 256 columns, persistent blocks walk the
  expert-grouped work list.
* ``wgmma_decode`` (cap <= 32; decode, bound by the weights' bytes): A and
  B swapped, w's 64-column boxes as ``wgmma``'s A and x^T as its B, up to
  32 rows of the bundles that meet one expert side by side; 128 columns a
  block (256 contiguous bytes of each weight row a slice), a 5-stage ring,
  two blocks an SM.
* ``mma_sync`` (d_in or d_out not a multiple of 8: TMA needs 16-byte row
  strides): ``mma.sync`` m16n8k16 on 8-byte ``cp.async`` copies.

Every width of the port's MoE configs takes a TMA route: dbrx-132b 6144 /
10752, kimi-k2 7168 / 2048, and their reduced configs 64 / 64.

The TMA routes walk an expert-grouped order (``pack_schedule``): the
bundles sorted by expert, and for each expert its column tiles in turn,
each with every row tile of every bundle that meets the expert side by
side, so an expert's weights cross the memory bus about once per product
rather than once per bundle.  The expert map and that order are one int32
buffer on the card (``bundle_expert`` first, which the other routes read).

``moe_gemm`` / ``moe_gemm_schedule`` dispatch on the tensors' device: CPU
tensors run ``moe_gemm_plain``; CUDA tensors launch the kernel or raise.
``moe_gemm.launches`` counts kernel launches, ``moe_gemm.routes`` them by
route, and ``moe_gemm.uploads`` the uploads of a schedule buffer.  A
dispatch plan's schedule bundle keeps the device copy of its buffer (as
``K2Schedule.device_ids`` does), so the warm calls of one plan upload
nothing; a bare array is uploaded on every call.

K5's backward (``moe_gemm_bwd``): ``moe_gemm`` on CUDA tensors under grad
mode goes through ``_MoeGemm``, a ``torch.autograd.Function`` whose forward
is K5's call as above and whose backward launches the kernels of
``csrc/moe_gemm_bwd.cu``: ``dx[b] = dy[b] @ w[e_b]ᵀ`` (w read through its
transpose, no transposed copy) and ``dw[e] = Σ_{b: e_b = e} x[b]ᵀ dy[b]``
(one writer per output tile walking its expert's bundles in a fixed order,
fp32 sums, zeros for an expert with no bundle; no atomics).  dw walks the
CSR ``bwd_schedule`` of the ids: ``[ptr (E + 1) | bundles by expert
(nb)]``, kept on a schedule bundle as the forward's buffer is.  bfloat16
takes one of two routes, picked by ``bwd_route`` from the widths:
``wgmma`` (d_in and d_out multiples of 8, every cap) is K5's forward tile
route turned round, TMA-fed ``wgmma`` m64n256k16 on persistent blocks: dx
walks the forward's expert-grouped units (``pack_schedule``; ``tile_order``
with d_in's column tiles), dw owns (expert, 128 × 256) tiles, experts
outermost, each walking its expert's bundles in ``bwd_schedule``'s order;
``mma_sync`` (other widths) is ``mma.sync`` on 8-byte ``cp.async`` copies.  It replaces the XLA autodiff of the reference's
expert einsums (``src/repro/models/moe.py:313-317``; the reference has no
backward Pallas kernel).  Its plain version is ``moe_gemm_bwd_plain``.
``moe_gemm_bwd.launches`` counts the calls that launched it,
``moe_gemm_bwd.routes`` the launches of each entry (``dx``, ``dw``) and
``moe_gemm_bwd.bf16_routes`` the bfloat16 calls by route.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.rir import ScheduleBundle
from ..device import launch_target, to_device
from . import _build, _meta

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILES = (16, 32, 64, 128)
MAX_BUNDLES = 65535         # the grid's z extent (float32, mma_sync, bwd)
# the bfloat16 TMA routes: a tile-route block's columns and rows a unit
# (two 64-row tiles), a decode block's columns and its x^T width
TILE_COLS, TILE_ROWS, TILE_UNIT = 256, 64, 2
DECODE_COLS, DECODE_ROWS = 128, 32
_TMA_ROUTES = {"wgmma_tiles": 1, "wgmma_decode": 2}


def row_tile(cap: int) -> int:
    """The smallest row tile that holds ``cap`` rows, at most 128."""
    return next((bm for bm in ROW_TILES if cap <= bm), ROW_TILES[-1])


def bf16_route(cap: int, d_in: int, d_out: int) -> str:
    """The kernel a bfloat16 call of these widths takes: ``wgmma_tiles``
    (cap > 32), ``wgmma_decode`` (cap <= 32) or, where TMA's 16-byte row
    strides rule it out (d_in or d_out not a multiple of 8), ``mma_sync``."""
    if d_in % 8 or d_out % 8:
        return "mma_sync"
    return "wgmma_decode" if cap <= DECODE_ROWS else "wgmma_tiles"


def bwd_route(d_in: int, d_out: int) -> str:
    """The kernels a bfloat16 backward call of these widths takes: ``wgmma``
    (TMA-fed, d_in and d_out multiples of 8, any cap) or, where TMA's
    16-byte row strides rule it out, ``mma_sync``.  The cap does not choose:
    at decode-sized caps both entries are bound by bytes (dx reading w, dw
    writing it), which the TMA ring moves as fast as ``cp.async`` does
    (``scripts/card_studies.py k5-bwd-routes``)."""
    return "mma_sync" if d_in % 8 or d_out % 8 else "wgmma"


def pack_schedule(be: np.ndarray, grouped: bool = True):
    """The TMA routes' schedule as one int32 buffer, and its group count G:
    ``[bundle_expert (nb) | order (nb) | starts (G + 1)]``, ``order`` the
    bundles sorted by expert (stably) and group g, one expert,
    ``order[starts[g]:starts[g + 1]]``.  ``grouped=False`` makes every
    bundle a group of its own, in bundle order: the walk without the
    expert grouping (``scripts/card_studies.py k5-bf16``)."""
    be = np.asarray(be, np.int32)
    nb = be.size
    if grouped:
        order = np.argsort(be, kind="stable").astype(np.int32)
        starts = np.r_[0, np.flatnonzero(np.diff(be[order])) + 1, nb] \
            if nb else np.zeros(1, np.int64)
    else:
        order = np.arange(nb, dtype=np.int32)
        starts = np.arange(nb + 1)
    return np.concatenate([be, order, starts]).astype(np.int32), \
        starts.size - 1


def _walk(route: str, cap: int):
    """(slots a bundle, slots a unit) of a TMA route: 64-row tiles paired
    on the tile route; on the decode route whole bundles, as many as fit
    in 32 rows at cap rounded up to 8."""
    if route == "wgmma_tiles":
        return -(-cap // TILE_ROWS), TILE_UNIT
    return 1, DECODE_ROWS // (-(-cap // 8) * 8)


def _units(buf: np.ndarray, nb: int, route: str, cap: int) -> int:
    """The schedule's units: each group's slots cut into units."""
    per, span = _walk(route, cap)
    sizes = np.diff(buf[2 * nb:]).astype(np.int64)
    return int((-(-sizes * per // span)).sum())


def tile_order(buf: np.ndarray, nb: int, route: str, cap: int, d_out: int):
    """The work items of a TMA route in the order its persistent blocks
    take them (``csrc/moe_gemm.cu``'s ``Walk`` and ``item_at``): a list of
    ``(expert, column tile, ((bundle, row tile), ...))``, row tiles of 64
    rows on the tile route, 0 (the whole bundle) on the decode route."""
    per, span = _walk(route, cap)
    cols = -(-d_out // (TILE_COLS if route == "wgmma_tiles"
                        else DECODE_COLS))
    be, order, starts = buf[:nb], buf[nb:2 * nb], buf[2 * nb:]
    items = []
    for g in range(starts.size - 1):
        members = order[starts[g]:starts[g + 1]]
        slots = [(int(b), i) for b in members for i in range(per)]
        units = [tuple(slots[u:u + span]) for u in range(0, len(slots), span)]
        items += [(int(be[members[0]]), col, unit) for col in range(cols)
                  for unit in units]
    return items


def moe_gemm_plain(x_bundles: torch.Tensor, w: torch.Tensor,
                   bundle_expert: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: gather the experts, fp32 ``einsum``."""
    return torch.einsum("bcd,bdf->bcf", x_bundles.float(),
                        w[bundle_expert.long()].float()).to(x_bundles.dtype)


def moe_gemm_bwd_plain(x_bundles: torch.Tensor, w: torch.Tensor,
                       bundle_expert: torch.Tensor, dy: torch.Tensor):
    """Plain PyTorch version of K5's backward: ``(dx, dw)`` of
    ``out = moe_gemm(x_bundles, w, bundle_expert)`` against ``dy``.
    ``dx[b] = dy[b] @ w[e_b]ᵀ``; ``dw[e] = Σ_{b: e_b = e} x[b]ᵀ @ dy[b]``,
    zeros for an expert with no bundle; float32 products, each result in
    x's dtype.  One expert at a time, so no gathered copy of the weights is
    made."""
    be = torch.as_tensor(bundle_expert).to(x_bundles.device).long()
    nb, cap, d_in = x_bundles.shape
    n_experts, _, d_out = w.shape
    dx = torch.zeros((nb, cap, d_in), dtype=torch.float32,
                     device=x_bundles.device)
    dw = torch.zeros((n_experts, d_in, d_out), dtype=torch.float32,
                     device=w.device)
    for e in torch.unique(be).tolist():
        sel = torch.nonzero(be == e).flatten()
        d_e = dy[sel].float()
        dx[sel] = d_e @ w[e].float().T
        dw[e] = x_bundles[sel].float().reshape(-1, d_in).T \
            @ d_e.reshape(-1, d_out)
    return dx.to(x_bundles.dtype), dw.to(x_bundles.dtype)


def bwd_schedule(be: np.ndarray, n_experts: int) -> np.ndarray:
    """dw's walk as one int32 CSR buffer: ``[ptr (E + 1) | ids (nb)]``,
    expert e's bundles ``ids[ptr[e]:ptr[e + 1]]`` in bundle order (a stable
    sort by expert); an expert with no bundle has ``ptr[e] == ptr[e + 1]``."""
    be = np.asarray(be, np.int64)
    ids = np.argsort(be, kind="stable")
    ptr = np.searchsorted(be[ids], np.arange(n_experts + 1), side="left")
    return np.concatenate([ptr, ids]).astype(np.int32)


def _lib(entry: str = "moe_gemm") -> ctypes.CDLL:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = {"moe_gemm": [p, p, p, i, i, i, i, i, i, p, p, i],
            "moe_gemm_bf16_tma": [p, p, p, i, i, i, i, i, i, q, i, p, p, i]}
    return _build.bind("moe_gemm", entry, args[entry])


def _bwd_lib() -> ctypes.CDLL:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    args = [p, p, p, i, i, i, i, i, p, p, i]
    _build.bind("moe_gemm_bwd", "moe_gemm_bwd_dx", args)
    _build.bind("moe_gemm_bwd", "moe_gemm_bwd_dx_tma",
                [p, p, p, i, i, i, i, i, i, q, p, p, i])
    _build.bind("moe_gemm_bwd", "moe_gemm_bwd_dw_tma",
                [p, p, p, i, i, i, i, i, p, p, i])
    return _build.bind("moe_gemm_bwd", "moe_gemm_bwd_dw", args)


def _memo(bundle_expert, name: str, key, make):
    """``make()``, kept per ``key`` on a schedule bundle (outside its
    fields) under ``name``; anything else makes it anew."""
    if not isinstance(bundle_expert, ScheduleBundle):
        return make()
    memo = bundle_expert.__dict__.setdefault(name, {})
    if key not in memo:
        memo[key] = make()
    return memo[key]


def _device_schedule(bundle_expert, be: np.ndarray, device: torch.device):
    """``(buffer on device, its host copy, G)``: ``pack_schedule(be)``.  A
    schedule bundle keeps it per device, uploaded on first use, outside its
    fields; anything else is packed and uploaded now."""
    def upload():
        moe_gemm.uploads += 1
        buf, n_groups = pack_schedule(be)
        return to_device(buf, device), buf, n_groups

    return _memo(bundle_expert, "_device_schedule", str(device), upload)


def _device_bwd_schedule(bundle_expert, be: np.ndarray, n_experts: int,
                         device: torch.device) -> torch.Tensor:
    """``bwd_schedule(be, n_experts)`` on the card, kept on a schedule
    bundle per (device, E) as the forward's buffer is."""
    def upload():
        moe_gemm_bwd.uploads += 1
        return to_device(bwd_schedule(be, n_experts), device)

    return _memo(bundle_expert, "_device_bwd_schedule",
                 (str(device), n_experts), upload)


def _check_operands(what: str, device: torch.device, nb: int, d_in: int,
                    d_out: int, *tensors) -> None:
    """What K5 and its backward take: float32 or bfloat16, d_in and d_out
    multiples of 4, at most ``MAX_BUNDLES`` bundles, contiguous 16-byte
    aligned tensors on ``device``."""
    if tensors[0].dtype not in _DTYPE_CODE:
        raise ValueError(f"{what} takes float32 or bfloat16, got "
                         f"{tensors[0].dtype}")
    if d_in % 4 or d_out % 4 or nb > MAX_BUNDLES:
        raise ValueError(f"{what} needs d_in and d_out divisible by 4 and "
                         f"at most {MAX_BUNDLES} bundles, got nb={nb}, "
                         f"d_in={d_in}, d_out={d_out}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 \
                or t.device != device:
            raise ValueError(f"{what} operands must be contiguous, 16-byte "
                             "aligned tensors on one device")


def _launch(x: torch.Tensor, w: torch.Tensor, bundle_expert, be: np.ndarray,
            out: torch.Tensor) -> None:
    nb, cap, d_in = x.shape
    d_out = w.shape[-1]
    _check_operands("K5", out.device, nb, d_in, d_out, x, w)
    sched, host, n_groups = _device_schedule(bundle_expert, be, out.device)
    route = "float32" if x.dtype == torch.float32 \
        else bf16_route(cap, d_in, d_out)
    if route in _TMA_ROUTES:
        lib = _lib("moe_gemm_bf16_tma")
        err = lib.moe_gemm_bf16_tma(
            x.data_ptr(), w.data_ptr(), sched.data_ptr(), nb, n_groups, cap,
            d_in, d_out, w.shape[0], _units(host, nb, route, cap),
            _TMA_ROUTES[route], out.data_ptr(), *launch_target(out.device))
    else:
        lib = _lib()
        err = lib.moe_gemm(x.data_ptr(), w.data_ptr(), sched.data_ptr(), nb,
                           cap, d_in, d_out, row_tile(cap),
                           _DTYPE_CODE[x.dtype], out.data_ptr(),
                           *launch_target(out.device))
    _build.check_launch(lib, err, "moe_gemm")
    moe_gemm.launches += 1
    moe_gemm.routes[route] = moe_gemm.routes.get(route, 0) + 1


def _k5(x: torch.Tensor, w: torch.Tensor, bundle_expert, be: np.ndarray
        ) -> torch.Tensor:
    """K5's output on the card (a launch unless it is empty)."""
    out = torch.empty((x.shape[0], x.shape[1], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        _launch(x, w, bundle_expert, be, out)
    return out


def _k5_bwd(x: torch.Tensor, w: torch.Tensor, bundle_expert, be: np.ndarray,
            dy: torch.Tensor, need_dx: bool = True, need_dw: bool = True):
    """K5's backward on the card: ``(dx, dw)`` in x's dtype, either None
    where it is not needed.  dx is one launch of its entry (none where it is
    empty); dw one of its, which writes every element (zeros for an expert
    with no bundle).  bfloat16 takes ``bwd_route``'s kernels: on ``wgmma``
    dx walks the forward's schedule buffer (the tile route's units), dw the
    CSR ``bwd_schedule``."""
    nb, cap, d_in = x.shape
    n_experts, _, d_out = w.shape
    _check_operands("K5's backward", x.device, nb, d_in, d_out, x, w, dy)
    if n_experts > MAX_BUNDLES:     # dw's grid runs an expert a z index
        raise ValueError(f"K5's backward takes at most {MAX_BUNDLES} "
                         f"experts, got {n_experts}")
    if dy.dtype != x.dtype or tuple(dy.shape) != (nb, cap, d_out):
        raise ValueError(f"dy must be ({nb}, {cap}, {d_out}) of x's dtype, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    dev, code = x.device, _DTYPE_CODE[x.dtype]
    tma = code == 1 and bwd_route(d_in, d_out) == "wgmma"
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    launched = False
    if need_dx and dx.numel():
        lib = _bwd_lib()
        sched, host, n_groups = _device_schedule(bundle_expert, be, dev)
        if tma:
            err = lib.moe_gemm_bwd_dx_tma(
                dy.data_ptr(), w.data_ptr(), sched.data_ptr(), nb, n_groups,
                cap, d_in, d_out, n_experts,
                _units(host, nb, "wgmma_tiles", cap), dx.data_ptr(),
                *launch_target(dev))
        else:
            err = lib.moe_gemm_bwd_dx(dy.data_ptr(), w.data_ptr(),
                                      sched.data_ptr(), nb, cap, d_in, d_out,
                                      code, dx.data_ptr(), *launch_target(dev))
        _build.check_launch(lib, err, "moe_gemm_bwd_dx")
        moe_gemm_bwd.routes["dx"] = moe_gemm_bwd.routes.get("dx", 0) + 1
        launched = True
    if need_dw and dw.numel():
        lib = _bwd_lib()
        sched = _device_bwd_schedule(bundle_expert, be, n_experts, dev)
        if tma:
            err = lib.moe_gemm_bwd_dw_tma(
                x.data_ptr(), dy.data_ptr(), sched.data_ptr(), nb, n_experts,
                cap, d_in, d_out, dw.data_ptr(), *launch_target(dev))
        else:
            err = lib.moe_gemm_bwd_dw(x.data_ptr(), dy.data_ptr(),
                                      sched.data_ptr(), n_experts, cap, d_in,
                                      d_out, code, dw.data_ptr(),
                                      *launch_target(dev))
        _build.check_launch(lib, err, "moe_gemm_bwd_dw")
        moe_gemm_bwd.routes["dw"] = moe_gemm_bwd.routes.get("dw", 0) + 1
        launched = True
    if launched and code == 1:
        route = "wgmma" if tma else "mma_sync"
        moe_gemm_bwd.bf16_routes[route] = \
            moe_gemm_bwd.bf16_routes.get(route, 0) + 1
    moe_gemm_bwd.launches += launched
    return dx, dw


class _MoeGemm(torch.autograd.Function):
    """K5 with its backward kernels: the forward launches K5 as it is (its
    output bit-identical to a call without grad, nothing kept but the
    inputs), the backward launches ``moe_gemm_bwd_dx`` and
    ``moe_gemm_bwd_dw`` (``_k5_bwd``) for the inputs that need a gradient.
    CUDA tensors only; ``bundle_expert`` as ``moe_gemm`` takes it, ``be``
    its ids on the host."""

    @staticmethod
    def forward(ctx, x, w, bundle_expert, be):
        ctx.bundle_expert, ctx.be = bundle_expert, be
        ctx.save_for_backward(x, w)
        return _k5(x, w, bundle_expert, be)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _k5_bwd(x, w, ctx.bundle_expert, ctx.be, dy.contiguous(),
                         *ctx.needs_input_grad[:2])
        return dx, dw, None, None


def _host_ids(x) -> np.ndarray:
    if isinstance(x, ScheduleBundle):
        x = x["bundle_expert"]
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x)).astype(np.int32, copy=False)


def _check_call(x_bundles: torch.Tensor, w: torch.Tensor, bundle_expert,
                bk: int = 512, bf: int = 512) -> np.ndarray:
    """Check a K5 call's shapes, dtypes and expert ids; returns the ids on
    the host."""
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
    return be


def moe_gemm(x_bundles: torch.Tensor, w: torch.Tensor, bundle_expert, *,
             bk: int = 512, bf: int = 512) -> torch.Tensor:
    """out[b] = x_bundles[b] @ w[bundle_expert[b]].

    x_bundles: (nb, cap, d_in); w: (E, d_in, d_out) of x's dtype;
    bundle_expert: (nb,) expert ids, read on the host to check their range
    (pass numpy or a CPU tensor), or a dispatch plan's schedule bundle,
    which keeps the ids' device copies.  Returns (nb, cap, d_out) in x's
    dtype on x's device.  ``bk`` / ``bf`` are the reference's tile
    arguments: they must divide d_in / d_out (after clipping to them) as
    there, and K5 does not tile by them.  CPU tensors run the plain version
    (autograd differentiates it); CUDA tensors launch K5 or raise, and under
    grad mode with x or w requiring grad go through ``_MoeGemm``, whose
    backward is K5's backward kernels.  ``meta`` tensors (the dry run) get a
    fake result of K5's shape and FLOP (``kernels._meta``).
    """
    be = _check_call(x_bundles, w, bundle_expert, bk, bf)
    if x_bundles.device.type == "cpu":
        return moe_gemm_plain(x_bundles, w, torch.from_numpy(be))
    if x_bundles.device.type == "meta":
        return _meta.moe_gemm(x_bundles, w)
    if x_bundles.device.type != "cuda":
        raise ValueError(f"unsupported device {x_bundles.device}")
    if torch.is_grad_enabled() and (x_bundles.requires_grad
                                    or w.requires_grad):
        return _MoeGemm.apply(x_bundles, w, bundle_expert, be)
    return _k5(x_bundles, w, bundle_expert, be)


moe_gemm.launches = 0
moe_gemm.routes = {}
moe_gemm.uploads = 0


def moe_gemm_bwd(x_bundles: torch.Tensor, w: torch.Tensor, bundle_expert,
                 dy: torch.Tensor):
    """K5's backward: ``(dx, dw)`` of ``moe_gemm(x_bundles, w,
    bundle_expert)`` whose output met ``dy`` (nb, cap, d_out), each in x's
    dtype: ``dx[b] = dy[b] @ w[e_b]ᵀ``, ``dw[e] = Σ_{b: e_b = e} x[b]ᵀ
    dy[b]`` (zeros for an expert no bundle meets).  CPU tensors run
    ``moe_gemm_bwd_plain``; CUDA tensors launch the kernels of
    ``csrc/moe_gemm_bwd.cu`` or raise.  ``moe_gemm``'s autograd calls the
    kernels; ``moe_gemm_bwd.launches`` counts the calls that launched
    them."""
    be = _check_call(x_bundles, w, bundle_expert)
    if tuple(dy.shape) != (*x_bundles.shape[:2], w.shape[-1]):
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x_bundles.shape)} and w {tuple(w.shape)}")
    if x_bundles.device.type == "cpu":
        return moe_gemm_bwd_plain(x_bundles, w, torch.from_numpy(be), dy)
    if x_bundles.device.type != "cuda":
        raise ValueError(f"unsupported device {x_bundles.device}")
    return _k5_bwd(x_bundles, w, bundle_expert, be,
                   dy.to(x_bundles.dtype).contiguous())


moe_gemm_bwd.launches = 0
moe_gemm_bwd.routes = {}
moe_gemm_bwd.bf16_routes = {}
moe_gemm_bwd.uploads = 0


def moe_gemm_schedule(schedule, x_bundles: torch.Tensor, w: torch.Tensor, *,
                      bk: int = 512, bf: int = 512) -> torch.Tensor:
    """Drive K5 from a ``MoeDispatchPlan``'s schedule bundle: its
    ``bundle_expert`` array is the kernel's expert map, so a cached
    dispatch plan replays onto fresh bundles with no re-routing (and, on
    the card, with no upload: the bundle keeps the map's device copy)."""
    return moe_gemm(x_bundles, w, schedule, bk=bk, bf=bf)

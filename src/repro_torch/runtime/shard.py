"""Sharded planned execution: ``shard_plan`` hooks over a device mesh.

Port of ``repro.runtime.shard``.  The REAP split scaled out: the host
inspector still builds pattern-pure plans, but the executor side becomes a
fleet — each shard of the mesh's data axes owns a contiguous range of the
computation.  Plans are partitioned on the host, each shard's operands go
to its mesh device (``launch.mesh.DeviceMesh``; one process drives every
device, as the reference's single-controller ``shard_map`` does), and the
shards' results are stitched on the host.  Each shard runs the same
executor as the single-host call:

* gather-SpGEMM — ``core.spgemm._gather_math`` on the shard's row range.
  Gustavson is row-local and row ranges never split a row, so each output
  entry sums the same partial products in the same order.  On the host
  ``index_add_`` adds in index order, so the result is bit-for-bit the
  single-host one; on a card it merges with atomics, which are not
  bit-reproducible even unsharded.
* SpMM — K2 (``kernels.bsr_spmm``) on the shard's token rows, W's tiles and
  schedule replicated.  A shard launches at the whole call's regime (K2
  picks its variant from the call's token count, not the shard's), so a
  token row's result is that of the single-host call.
* moe_dispatch — bundling is a pure gather: experts are split over the
  shards and each bundle row is gathered from the replicated tokens.

Ops opt in through the registry (``OpSpec.shard_plan`` +
``OpCapabilities.shardable``); ``ReapRuntime.run(..., mesh=...)`` routes
through the hook and namespaces the fingerprint with the shard count.  The
reference wraps its per-mesh ``shard_map`` programs in ``persistent_jit``;
the port's executors are eager torch ops and prebuilt kernels, so there is
no program to memoize per mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.formats import CSR
from ..core.inspector import (MoeDispatchPlan, PatternFingerprint,
                              SpGemmGatherPlan, inspect_moe_dispatch,
                              inspect_spgemm_gather, next_pow2)
from ..core.spgemm import _gather_math
from ..device import resolve_device, to_device
from ..kernels.bsr_spmm import (SpmmPlan, _k2_schedule, bsr_spmm,
                                bsr_spmm_plain, inspect_spmm)
from ..parallel.sharding import axis_size, dp_axes
from .ops import register_plan_type


def data_shard_count(mesh) -> int:
    """Number of shards the mesh's data-parallel axes provide."""
    return axis_size(mesh, dp_axes(mesh))


def shard_devices(mesh) -> List[torch.device]:
    """The device of each data shard, in shard order: the data axes'
    devices, each shard taking the first device of its other axes (they
    would hold replicas)."""
    names = list(mesh.axis_names)
    dp = [names.index(a) for a in dp_axes(mesh) if a in names]
    rest = [i for i in range(len(names)) if i not in dp]
    grid = np.transpose(mesh.devices, dp + rest)
    return list(grid.reshape(data_shard_count(mesh), -1)[:, 0])


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """Even partition of ``[0, n)`` into exactly ``n_shards`` contiguous
    ranges (shards may be empty when ``n < n_shards``); never merges
    ranges, unlike ``pipeline.chunk_row_bounds``."""
    return np.linspace(0, n, n_shards + 1).astype(np.int64)


@dataclasses.dataclass(eq=False)
class ShardedPlan:
    """Row-range partition of a gather-SpGEMM inspection across a mesh.

    Shard ``k`` owns A rows ``[bounds[k], bounds[k+1])`` and a chunk-local
    ``SpGemmGatherPlan`` for them (the row-slice inspection the chunked
    pipeline uses, so per-shard plans are pattern-pure and the whole
    artifact round-trips through the generic serializer — under the
    reference's type name, so either package reads the other's payloads).
    Ops whose single plan is already global (SpMM's weight schedule, MoE's
    slot map) keep their native plan type and derive the value partition at
    execute time instead.
    """

    n_shards: int
    n_rows: int
    n_cols: int
    tile: int
    bounds: np.ndarray                  # (n_shards + 1,) A-row ranges
    plans: List[SpGemmGatherPlan]       # one per shard, chunk-local indexing
    fingerprint: Optional[PatternFingerprint] = None


register_plan_type("sharded_plan", ShardedPlan)


def _replicated(arr, device: torch.device,
                memo: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``arr`` on ``device``, copied once per distinct device of a call."""
    key = str(device)
    if key not in memo:
        memo[key] = to_device(arr, device) if isinstance(arr, np.ndarray) \
            else arr.to(device, non_blocking=True)
    return memo[key]


# ---------------------------------------------------------------------------
# Sharded gather-SpGEMM
# ---------------------------------------------------------------------------

def sharded_spgemm_gather(a: CSR, b: CSR, mesh, *, tile: int = 1024,
                          plan: Optional[ShardedPlan] = None):
    """C = A @ B across the mesh's data axis.  Returns (C, stats, plan).

    A's rows are range-partitioned (``ShardedPlan``); each shard runs the
    gather math on its row slice with B's values replicated.  All shards
    share the reference's common pow-2 caps, dead slots follow the chunked
    executor's conventions (operand pads gather the appended zero, output
    pads land in the dropped ``c_cap`` segment), and shard outputs are
    disjoint contiguous ordered row ranges — the stitch is an exact
    concatenation.
    """
    n_shards = data_shard_count(mesh)
    t0 = time.perf_counter()
    if plan is None:
        bounds = shard_bounds(a.n_rows, n_shards)
        plans = [inspect_spgemm_gather(
            a.row_slice(int(bounds[k]), int(bounds[k + 1])), b, tile)
            for k in range(n_shards)]
        plan = ShardedPlan(n_shards, a.n_rows, b.n_cols, tile, bounds,
                           plans)
    inspect_s = time.perf_counter() - t0
    bounds, plans = plan.bounds, plan.plans

    pp_cap = max(next_pow2(max(1, p.a_idx.shape[0] // max(1, plan.tile)))
                 * plan.tile for p in plans)
    vals_cap = next_pow2(max(1, max(
        int(a.indptr[bounds[k + 1]] - a.indptr[bounds[k]])
        for k in range(n_shards))))
    c_cap = max(next_pow2(max(1, p.c_nnz)) for p in plans)

    a_vals = np.zeros((n_shards, vals_cap), a.data.dtype)
    a_idx = np.full((n_shards, pp_cap), vals_cap, np.int64)
    b_idx = np.full((n_shards, pp_cap), len(b.data), np.int64)
    out_idx = np.full((n_shards, pp_cap), c_cap, np.int64)
    for k, p in enumerate(plans):
        s, e = int(a.indptr[bounds[k]]), int(a.indptr[bounds[k + 1]])
        a_vals[k, :e - s] = a.data[s:e]
        n = p.a_idx.shape[0]
        # the plan's own dead slots index its chunk-local data length /
        # c_nnz; remap them to the common caps' zero slot / drop segment
        a_idx[k, :n] = np.where(p.a_idx >= e - s, vals_cap, p.a_idx)
        b_idx[k, :n] = p.b_idx
        out_idx[k, :n] = np.where(p.out_idx >= p.c_nnz, c_cap, p.out_idx)

    t1 = time.perf_counter()
    b_memo: Dict[str, torch.Tensor] = {}
    # every shard is launched before any is read back, so shards on
    # different devices run concurrently
    outs = [_gather_math(to_device(a_vals[k], dev),
                         _replicated(b.data, dev, b_memo),
                         to_device(a_idx[k], dev), to_device(b_idx[k], dev),
                         to_device(out_idx[k], dev), int(c_cap))
            for k, dev in enumerate(shard_devices(mesh))]
    c_data = np.concatenate(
        [outs[k][:p.c_nnz].cpu().numpy() for k, p in enumerate(plans)])
    c_indptr = np.zeros(plan.n_rows + 1, np.int64)
    c_indptr[1:] = np.cumsum(
        np.concatenate([np.diff(p.c_indptr) for p in plans]))
    c_indices = np.concatenate([p.c_indices for p in plans])
    c = CSR(plan.n_rows, plan.n_cols, c_indptr, c_indices, c_data)
    exec_s = time.perf_counter() - t1
    stats = dict(method="gather_sharded", n_shards=n_shards,
                 inspect_s=inspect_s, execute_s=exec_s,
                 n_pp=sum(p.n_pp for p in plans),
                 flops=sum(p.flops() for p in plans))
    return c, stats, plan


# ---------------------------------------------------------------------------
# Sharded SpMM
# ---------------------------------------------------------------------------

def sharded_spmm(x: np.ndarray, w: CSR, mesh, block: int, *,
                 plan: Optional[SpmmPlan] = None, dtype=np.float32,
                 use_kernel: bool = True):
    """Y = X @ W across the mesh's data axis.  Returns (Y, stats, plan).

    W's plan is global (the schedule depends only on W's pattern); the
    token rows of X are range-partitioned per call, with W's tiles and
    schedule replicated.  Each shard runs ``spmm_execute``'s executor: K2
    for float32 with ``use_kernel`` (the plain version on the host), the
    plain version otherwise.  Every shard runs at the whole call's regime:
    K2 takes the call's token count as ``regime_t``, and on the host no
    shard drops to one row when the call has more (a one-row product takes
    BLAS's matrix-vector path, whose sums differ in the last bits).
    """
    n_shards = data_shard_count(mesh)
    t0 = time.perf_counter()
    if plan is None:
        plan = inspect_spmm(w, block)
    inspect_s = time.perf_counter() - t0
    dtype = np.dtype(dtype)
    x = np.asarray(x, dtype)
    t, d_in = x.shape
    if d_in != plan.n_rows:
        raise ValueError(f"x has {d_in} features, W has {plan.n_rows} rows")
    bounds = shard_bounds(t, n_shards)
    w_tiles = plan.scatter(w.data, dtype=dtype)
    kernel = use_kernel and dtype == np.float32

    t1 = time.perf_counter()
    w_memo: Dict[str, torch.Tensor] = {}
    ids_memo: Dict[str, tuple] = {}
    outs = []
    for k, dev in enumerate(shard_devices(mesh)):
        s, e = int(bounds[k]), int(bounds[k + 1])
        if e == s:
            continue
        xp = np.zeros((max(e - s, min(t, 2)), plan.pat.n_rows), dtype)
        xp[:e - s, :d_in] = x[s:e]
        x_t = to_device(xp, dev)
        w_t = _replicated(w_tiles, dev, w_memo)
        if kernel:
            # reaplint: disable=REAP004 no per-shape compile: K2 and the
            # torch ops take any shape
            out = bsr_spmm(x_t, w_t, _k2_schedule(plan),
                           n_j_blocks=plan.n_j_blocks, regime_t=t)
        else:
            if str(dev) not in ids_memo:
                ids_memo[str(dev)] = tuple(to_device(a, dev) for a in (
                    plan.w_id, plan.k_blk, plan.j_blk))
            # reaplint: disable=REAP004 no per-shape compile (as above)
            out = bsr_spmm_plain(x_t, w_t, *ids_memo[str(dev)],
                                 n_j_blocks=plan.n_j_blocks)
        outs.append((out, e - s))
    pieces = [out[:n, :plan.n_cols].cpu().numpy() for out, n in outs]
    y = np.concatenate(pieces) if pieces else \
        np.zeros((0, plan.n_cols), dtype)
    exec_s = time.perf_counter() - t1
    stats = dict(method="spmm_sharded", n_shards=n_shards,
                 inspect_s=inspect_s, execute_s=exec_s, n_jobs=plan.n_jobs,
                 fill=plan.pat.fill, flops=plan.flops(t))
    return y, stats, plan


# ---------------------------------------------------------------------------
# Expert-parallel MoE dispatch
# ---------------------------------------------------------------------------

def sharded_moe_dispatch(tokens, routing: CSR, capacity: int, mesh, *,
                         plan: Optional[MoeDispatchPlan] = None,
                         device="cuda"):
    """Expert-parallel bundling across the mesh's data axis.

    The dispatch plan is global (slot map over all experts); each shard
    gathers its expert block's ``(experts/n_shards, capacity, d)`` bundles
    from the replicated padded token table — a pure gather, so results are
    identical to ``plan.bundle``.  When ``n_experts`` does not divide
    evenly, falls back to the single-host ``plan.bundle`` (the plan is still
    built, cached, and returned; ``stats["sharded"]`` is False).  Numpy
    tokens give numpy bundles; a tensor gives bundles on ``device`` (the
    single-host op's convention).  Returns ((x_bundles, plan), stats, plan).
    """
    n_shards = data_shard_count(mesh)
    t0 = time.perf_counter()
    if plan is None:
        plan = inspect_moe_dispatch(routing, capacity)
    inspect_s = time.perf_counter() - t0
    is_tensor = torch.is_tensor(tokens)
    if not is_tensor:
        tokens = np.asarray(tokens)
    t1 = time.perf_counter()
    if plan.n_experts % n_shards:
        x_bundles = plan.bundle(
            tokens.to(resolve_device(device), non_blocking=True)
            if is_tensor else tokens)
        sharded = False
    else:
        d = tokens.shape[-1]
        src = tokens.detach() if is_tensor else \
            torch.from_numpy(np.ascontiguousarray(tokens))
        pad = torch.cat([src, src.new_zeros((1, d))])
        st = plan.slot_token.reshape(n_shards, -1)
        pad_memo: Dict[str, torch.Tensor] = {}
        outs = [_replicated(pad, dev, pad_memo).index_select(
                    0, to_device(st[k], dev))
                for k, dev in enumerate(shard_devices(mesh))]
        x_bundles = torch.cat([o.cpu() for o in outs]).reshape(
            plan.n_experts, plan.capacity, d)
        x_bundles = x_bundles.to(resolve_device(device)) if is_tensor \
            else x_bundles.numpy()
        sharded = True
    if is_tensor and x_bundles.is_cuda:
        # deliberate timed drain: bundle_s measures device completion
        torch.cuda.synchronize(x_bundles.device)
    bundle_s = time.perf_counter() - t1
    stats = dict(method="dispatch_sharded", n_shards=n_shards,
                 sharded=sharded, inspect_s=inspect_s, bundle_s=bundle_s,
                 capacity=plan.capacity, dropped=plan.dropped_frac)
    return (x_bundles, plan), stats, plan

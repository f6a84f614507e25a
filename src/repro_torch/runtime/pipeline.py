"""Overlapped inspector/executor pipeline (the paper's CPU/FPGA overlap).

Port of ``repro.runtime.pipeline``.  The executors run on the device the
caller names; torch kernels release the GIL, so the emit worker's host
work and the main thread's device enqueue overlap as in the reference.

REAP's input controller keeps the FPGA pipelines busy while the CPU keeps
producing RIR bundles; here the same overlap is software: the schedule-bundle
stream is chunked, and while the device executes chunk *k* a worker thread
inspects chunk *k+1* (double-buffering).  Two concrete pipelines:

  * ``spgemm_gather_chunked`` — A's rows are partitioned into nnz-balanced
    chunks; each chunk is an independent Gustavson sub-problem whose output
    rows are disjoint, so results concatenate exactly.
  * ``cholesky_execute_overlapped`` — the etree level schedule is the chunk
    stream: the padded cmod/cdiv index bundles of level ℓ+1 are emitted on
    the worker thread while the device runs level ℓ.

``run_overlapped`` is the shared engine; ``overlap=False`` runs the same
chunked schedule synchronously (the baseline the benchmarks compare against).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.cholesky import (_drain, emit_level_bundle, init_values,
                             pack_bundles, run_levels)
from ..core.etree import CholeskyPlan
from ..core.formats import CSR
from ..core.inspector import (PatternFingerprint, SpGemmBlockPlan,
                              SpGemmGatherPlan, inspect_spgemm_block,
                              inspect_spgemm_gather, next_pow2)
from ..core.spgemm import block_result_to_csr, spgemm_gather_execute_chunk
from ..device import resolve_device, to_device
from ..kernels.bsr_spgemm import (bsr_spgemm_plain, bsr_spgemm_schedule,
                                  prepare_schedule)


@dataclasses.dataclass
class OverlapStats:
    """Timing split of one pipelined run.

    ``inspect_s``/``execute_s`` are summed per-chunk stage times;
    ``wall_s`` is end-to-end.  With overlap on, wall_s < inspect_s +
    execute_s measures how much host work the device time hid.
    """

    n_chunks: int
    overlap: bool
    inspect_s: float
    execute_s: float
    wall_s: float

    @property
    def hidden_s(self) -> float:
        return max(0.0, self.inspect_s + self.execute_s - self.wall_s)


_EMIT_POOL: Optional[ThreadPoolExecutor] = None
_EMIT_POOL_LOCK = threading.Lock()


def _emit_pool() -> ThreadPoolExecutor:
    """Process-wide single worker for bundle emission.

    Created once (under a lock) and reused so a pipelined call does not pay
    OS thread spawn.  One worker deliberately serializes emission across
    concurrent pipelines in the same process, exactly like the paper's
    single CPU feeding the input controller — concurrent ReapRuntime calls
    share the emission core rather than oversubscribing the host.
    """
    global _EMIT_POOL
    with _EMIT_POOL_LOCK:
        if _EMIT_POOL is None:
            _EMIT_POOL = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="reap-emit")
    return _EMIT_POOL


def run_overlapped(n_chunks: int,
                   inspect_fn: Callable[[int], object],
                   execute_fn: Callable[[int, object], object],
                   overlap: bool = True) -> Tuple[List[object], OverlapStats]:
    """Double-buffered inspector/executor driver.

    ``inspect_fn(k)`` must be independent of execution results (pure host
    pattern work); ``execute_fn(k, artifact)`` may carry sequential state.
    While chunk *k* executes, chunk *k+1* is inspected on a worker thread.
    """
    t_wall = time.perf_counter()
    inspect_s = 0.0
    execute_s = 0.0
    results: List[object] = []

    def timed_inspect(k: int):
        t0 = time.perf_counter()
        art = inspect_fn(k)
        return art, time.perf_counter() - t0

    if not overlap or n_chunks <= 1:
        for k in range(n_chunks):
            art, dt = timed_inspect(k)
            inspect_s += dt
            t0 = time.perf_counter()
            results.append(execute_fn(k, art))
            execute_s += time.perf_counter() - t0
    else:
        pool = _emit_pool()
        fut = pool.submit(timed_inspect, 0)
        try:
            for k in range(n_chunks):
                art, dt = fut.result()
                inspect_s += dt
                if k + 1 < n_chunks:
                    fut = pool.submit(timed_inspect, k + 1)   # prefetch k+1
                t0 = time.perf_counter()
                results.append(execute_fn(k, art))
                execute_s += time.perf_counter() - t0
        finally:
            # on an execute_fn error, settle the in-flight prefetch so the
            # shared worker is idle (and its exception consumed) before the
            # caller unwinds — the per-call-pool join this pool replaced
            fut.cancel()
            try:
                fut.exception()
            except BaseException:       # CancelledError is a BaseException
                pass
    stats = OverlapStats(n_chunks, overlap and n_chunks > 1, inspect_s,
                         execute_s, time.perf_counter() - t_wall)
    return results, stats


# ---------------------------------------------------------------------------
# Chunked SpGEMM (gather path)
# ---------------------------------------------------------------------------

def chunk_row_bounds(a: CSR, n_chunks: int) -> np.ndarray:
    """Partition A's rows into ≤ n_chunks contiguous, nnz-balanced ranges."""
    n_chunks = max(1, min(n_chunks, a.n_rows))
    targets = a.nnz * np.arange(1, n_chunks) / n_chunks
    cuts = np.searchsorted(a.indptr, targets, side="left")
    return np.unique(np.concatenate(
        [[0], np.minimum(cuts, a.n_rows), [a.n_rows]])).astype(np.int64)


@dataclasses.dataclass(eq=False)
class GatherChunkSet:
    """Cached artifact of a chunked gather inspection: one plan per chunk.

    Plans use chunk-local row/nnz indexing; ``row_bounds[k]`` maps chunk k
    back to A's global rows.  Pattern-pure, so one chunk set serves every
    same-pattern call.
    """

    n_rows: int
    n_cols: int
    tile: int
    row_bounds: np.ndarray
    plans: List[SpGemmGatherPlan]
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def n_chunks(self) -> int:
        return len(self.plans)


def spgemm_gather_chunked(a: CSR, b: CSR, n_chunks: int = 4,
                          tile: int = 1024, overlap: bool = True,
                          chunkset: Optional[GatherChunkSet] = None,
                          device="cuda"
                          ) -> Tuple[CSR, dict, GatherChunkSet]:
    """C = A @ B, chunked over A's rows with inspect/execute overlap.

    With a warm ``chunkset`` (plan-cache hit) inspection degenerates to a
    list lookup and the pipeline is pure execution.  Returns
    (C, stats, chunkset) so callers can cache the chunk set.
    """
    dev = resolve_device(device)
    bounds = (chunkset.row_bounds if chunkset is not None
              else chunk_row_bounds(a, n_chunks))
    nk = len(bounds) - 1
    plans: List[Optional[SpGemmGatherPlan]] = (
        list(chunkset.plans) if chunkset is not None else [None] * nk)

    def inspect_fn(k: int) -> SpGemmGatherPlan:
        if plans[k] is None:
            plans[k] = inspect_spgemm_gather(
                a.row_slice(int(bounds[k]), int(bounds[k + 1])), b, tile)
        return plans[k]

    def execute_fn(k: int, plan: SpGemmGatherPlan) -> np.ndarray:
        s, e = int(a.indptr[bounds[k]]), int(a.indptr[bounds[k + 1]])
        return spgemm_gather_execute_chunk(plan, a.data[s:e], b.data, dev)

    chunks, ostats = run_overlapped(nk, inspect_fn, execute_fn, overlap)

    # stitch: chunk output rows are disjoint, contiguous, and ordered
    c_indptr = np.zeros(a.n_rows + 1, dtype=np.int64)
    row_nnz = np.concatenate([np.diff(p.c_indptr) for p in plans]) \
        if nk else np.zeros(0, np.int64)
    c_indptr[1:] = np.cumsum(row_nnz)
    c_indices = (np.concatenate([p.c_indices for p in plans])
                 if nk else np.zeros(0, np.int64))
    c_data = (np.concatenate(chunks) if nk
              else np.zeros(0, a.data.dtype))
    c = CSR(a.n_rows, b.n_cols, c_indptr, c_indices, c_data)
    out_set = chunkset if chunkset is not None else GatherChunkSet(
        a.n_rows, b.n_cols, tile, bounds, plans)  # type: ignore[arg-type]
    stats = dict(method="gather_chunked", n_chunks=nk,
                 overlap=ostats.overlap, inspect_s=ostats.inspect_s,
                 execute_s=ostats.execute_s, wall_s=ostats.wall_s,
                 hidden_s=ostats.hidden_s,
                 n_pp=sum(p.n_pp for p in plans),
                 flops=sum(p.flops() for p in plans))
    return c, stats, out_set


# ---------------------------------------------------------------------------
# Chunked SpGEMM (block path) — schedule groups as chunk boundaries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class BlockChunk:
    """One output-group-aligned slice of a block plan's pair schedule.

    Ids are chunk-local: ``a_id``/``b_id`` index the chunk's compact operand
    tile arrays, ``out_id`` is 0-based within the chunk.  The ``*_sel`` /
    ``*_eblk``/``*_erow``/``*_ecol`` arrays are the chunk-local scatter maps
    (which source CSR elements land where in the chunk's operand tiles) —
    the per-call value pass the pipeline overlaps with device execution.
    """

    a_id: np.ndarray
    b_id: np.ndarray
    out_id: np.ndarray
    is_first: np.ndarray
    is_last: np.ndarray
    n_out_blocks: int
    n_a_blocks: int
    n_b_blocks: int
    a_sel: np.ndarray
    a_eblk: np.ndarray
    a_erow: np.ndarray
    a_ecol: np.ndarray
    b_sel: np.ndarray
    b_eblk: np.ndarray
    b_erow: np.ndarray
    b_ecol: np.ndarray

    @property
    def n_pairs(self) -> int:
        return int(self.a_id.shape[0])


@dataclasses.dataclass(eq=False)
class BlockChunkSet:
    """Cached artifact of a chunked block inspection: the full plan plus its
    output-group-aligned chunk slices.  Pattern-pure like every plan.

    Chunk slices are built lazily — ``chunk(k)`` materializes on first use,
    so the overlapped pipeline constructs chunk *k+1*'s slice on the worker
    thread while the device executes chunk *k* (the gather path builds its
    per-chunk plans the same way).  A cached (warm) chunk set is fully
    materialized and ``chunk(k)`` degenerates to a list lookup.
    """

    plan: SpGemmBlockPlan
    out_bounds: np.ndarray          # (n_chunks+1,) out-block index bounds
    pair_bounds: np.ndarray         # (n_chunks+1,) pair index bounds
    chunks: List[Optional[BlockChunk]]
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def chunk(self, k: int) -> BlockChunk:
        if self.chunks[k] is None:
            self.chunks[k] = _build_block_chunk(
                self.plan, int(self.out_bounds[k]),
                int(self.pair_bounds[k]), int(self.pair_bounds[k + 1]))
        return self.chunks[k]

    def materialize(self) -> None:
        """Force every lazy chunk slice (serialize_plan calls this)."""
        for k in range(self.n_chunks):
            self.chunk(k)


def _chunk_scatter_maps(pat, blk_ids: np.ndarray):
    """Restrict a BsrPattern's element scatter to the given (sorted, unique)
    block ids, re-indexed to the chunk's compact tile array."""
    mask = np.isin(pat.elem_block, blk_ids)
    sel = np.flatnonzero(mask)
    local = np.searchsorted(blk_ids, pat.elem_block[sel])
    return sel, local, pat.elem_row[sel], pat.elem_col[sel]


def _build_block_chunk(plan: SpGemmBlockPlan, out0: int, s: int, e: int
                       ) -> BlockChunk:
    """Materialize one chunk slice: local schedule + operand scatter maps."""
    a_uniq, a_local = np.unique(plan.a_id[s:e], return_inverse=True)
    b_uniq, b_local = np.unique(plan.b_id[s:e], return_inverse=True)
    a_sel, a_eblk, a_erow, a_ecol = _chunk_scatter_maps(plan.a_pat, a_uniq)
    b_sel, b_eblk, b_erow, b_ecol = _chunk_scatter_maps(plan.b_pat, b_uniq)
    n_out = int(plan.out_id[e - 1]) - out0 + 1
    return BlockChunk(
        a_local.astype(np.int64), b_local.astype(np.int64),
        (plan.out_id[s:e] - out0).astype(np.int64),
        plan.is_first[s:e].copy(), plan.is_last[s:e].copy(),
        n_out, int(a_uniq.shape[0]), int(b_uniq.shape[0]),
        a_sel, a_eblk, a_erow, a_ecol, b_sel, b_eblk, b_erow, b_ecol)


def bucket_block_schedule(ch: BlockChunk) -> dict:
    """Pow-2-bucketed executor operands for one block chunk (memoized).

    Bucketing keeps a stream of chunks at O(log) distinct launch shapes
    (the reference compiles once per shape; the port keeps the same
    schedule so both packages emit identical bundles).  This
    pads all four executor dimensions to power-of-two buckets, mirroring
    ``spgemm_gather_execute_chunk`` on the gather path: compiled shapes are
    ``(pair_cap,)`` schedules over ``(a_cap, bs, bs)``/``(b_cap, bs, bs)``
    operand tiles with ``out_cap + 1`` output tiles, O(log) distinct shapes
    across any stream of chunks.

    Dead schedule slots form one trailing ``is_first``/``is_last`` group
    whose products (of real operand tiles, so indices stay in bounds)
    accumulate into the dummy output tile at index ``out_cap``; callers
    slice the result back to the chunk's true ``n_out_blocks``.  Memoized
    as a plain attribute — pattern-pure, rebuilt after deserialization,
    skipped by serialization.  ``k1`` is kernel K1's schedule for the
    chunk, memoized with it: the live pairs only.  The dead tail exists to
    bound the reference's compiled shapes, which a hand-written kernel does
    not need, and as one group it would run all its pairs on one thread
    block; without it the dummy tile comes out zero, and callers drop it.
    """
    cached = getattr(ch, "_bucketed", None)
    if cached is not None:
        return cached
    n = ch.n_pairs
    pair_cap = next_pow2(max(1, n))
    out_cap = next_pow2(max(1, ch.n_out_blocks))
    pad = pair_cap - n

    def sched(arr, fill, pad_first=0, pad_last=0):
        out = arr.astype(np.int32)
        if pad:
            tail = np.full(pad, fill, np.int32)
            tail[0], tail[-1] = tail[0] + pad_first, tail[-1] + pad_last
            out = np.concatenate([out, tail])
        return out

    cached = dict(a_id=sched(ch.a_id, 0), b_id=sched(ch.b_id, 0),
                  out_id=sched(ch.out_id, out_cap),
                  is_first=sched(ch.is_first, 0, pad_first=1),
                  is_last=sched(ch.is_last, 0, pad_last=1),
                  pair_cap=pair_cap, out_cap=out_cap,
                  a_cap=next_pow2(max(1, ch.n_a_blocks)),
                  b_cap=next_pow2(max(1, ch.n_b_blocks)))
    cached["k1"] = prepare_schedule(
        dict(a_id=ch.a_id, b_id=ch.b_id, out_id=ch.out_id))
    ch._bucketed = cached
    return cached


def build_block_chunkset(plan: SpGemmBlockPlan, n_chunks: int,
                         lazy: bool = False) -> BlockChunkSet:
    """Split a block plan's pair schedule into ≤ n_chunks chunks.

    The schedule is sorted by output block with ``is_first``/``is_last``
    marking group runs, so cutting only at group starts keeps every output
    block whole within one chunk — per-chunk results are disjoint slices of
    the output tile array and concatenate exactly.

    With ``lazy=True`` only the (cheap) bounds are computed; chunk slices
    materialize on first ``chunk(k)`` — inside the overlapped pipeline's
    emit stage, where their cost hides under device execution.
    """
    n_out = plan.n_out_blocks
    if n_out == 0 or plan.n_pairs == 0:
        return BlockChunkSet(plan, np.zeros(1, np.int64),
                             np.zeros(1, np.int64), [])
    n_chunks = max(1, min(n_chunks, n_out))
    group_starts = np.flatnonzero(plan.is_first)        # (n_out,)
    # pair-balanced cuts, snapped to group boundaries
    targets = plan.n_pairs * np.arange(1, n_chunks) / n_chunks
    cuts = np.searchsorted(group_starts, targets, side="left")
    ob = np.unique(np.concatenate([[0], cuts, [n_out]])).astype(np.int64)
    pair_bounds = np.concatenate([group_starts[ob[:-1]], [plan.n_pairs]])
    chunkset = BlockChunkSet(plan, ob, pair_bounds,
                             [None] * (len(ob) - 1))
    if not lazy:
        for k in range(chunkset.n_chunks):
            chunkset.chunk(k)
    return chunkset


def spgemm_block_chunked(a: CSR, b: CSR, block: int = 128, n_chunks: int = 4,
                         overlap: bool = True, use_kernel: bool = True,
                         chunkset: Optional[BlockChunkSet] = None,
                         device="cuda"
                         ) -> Tuple[CSR, dict, BlockChunkSet]:
    """C = A @ B on the block path with per-chunk emit/execute overlap.

    The bundle-emit stage per chunk — scattering the chunk's operand CSR
    values into compact tiles — runs on the worker thread while the
    device executes the previous chunk's tile products (the gather path's
    pipeline, applied to the block executor).  Returns (C, stats, chunkset)
    so callers can cache the chunk set; a warm chunkset skips plan-build
    entirely and the pipeline is scatter+execute only.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if chunkset is None:
        plan = inspect_spgemm_block(a, b, block)
        # bounds only: chunk slices materialize inside the emit stage, one
        # chunk ahead of the device (hidden under execution when overlapped)
        chunkset = build_block_chunkset(plan, n_chunks, lazy=True)
    plan = chunkset.plan
    plan_s = time.perf_counter() - t0

    base = dict(method="block_chunked", n_chunks=chunkset.n_chunks,
                plan_s=plan_s, flops=plan.flops(), n_pairs=plan.n_pairs,
                fill=plan.a_pat.fill)
    if not chunkset.chunks:
        zero = np.zeros((plan.n_out_blocks, plan.block, plan.block),
                        np.float32)
        c = block_result_to_csr(plan, zero, a.n_rows, b.n_cols)
        base.update(overlap=False, inspect_s=0.0, execute_s=0.0,
                    wall_s=plan_s, hidden_s=0.0)
        return c, base, chunkset

    bs = plan.block

    def emit_fn(k: int):
        # host-side *emit* stage (not inspection — it scatters operand
        # values into RIR tiles, so it must not carry an inspect_* name):
        # pow-2-bucketed tile arrays (bucket_block_schedule) keep the
        # executor at O(log) distinct shapes across a chunk stream
        ch = chunkset.chunk(k)
        sched = bucket_block_schedule(ch)
        a_blocks = np.zeros((sched["a_cap"], bs, bs), np.float32)
        a_blocks[ch.a_eblk, ch.a_erow, ch.a_ecol] = a.data[ch.a_sel]
        b_blocks = np.zeros((sched["b_cap"], bs, bs), np.float32)
        b_blocks[ch.b_eblk, ch.b_erow, ch.b_ecol] = b.data[ch.b_sel]
        return ch, sched, a_blocks, b_blocks

    def execute_fn(k: int, emitted) -> np.ndarray:
        ch, sched, a_blocks, b_blocks = emitted
        n_out_cap = sched["out_cap"] + 1    # +1: dummy tile for dead slots
        a_t, b_t = to_device(a_blocks, dev), to_device(b_blocks, dev)
        if use_kernel:
            out = bsr_spgemm_schedule(sched["k1"], a_t, b_t,
                                      n_out_blocks=n_out_cap)
        else:
            out = bsr_spgemm_plain(
                a_t, b_t, to_device(sched["a_id"], dev),
                to_device(sched["b_id"], dev),
                to_device(sched["out_id"], dev), n_out_blocks=n_out_cap)
        return out[:ch.n_out_blocks].cpu().numpy()

    results, ostats = run_overlapped(chunkset.n_chunks, emit_fn,
                                     execute_fn, overlap)
    c_blocks = np.concatenate(results, axis=0)
    c = block_result_to_csr(plan, c_blocks, a.n_rows, b.n_cols)
    base.update(overlap=ostats.overlap, inspect_s=ostats.inspect_s,
                execute_s=ostats.execute_s, wall_s=ostats.wall_s,
                hidden_s=ostats.hidden_s)
    return c, base, chunkset


# ---------------------------------------------------------------------------
# Overlapped Cholesky (level schedule as the chunk stream)
# ---------------------------------------------------------------------------

def _level_groups(plan: CholeskyPlan, max_chunks: int) -> List[np.ndarray]:
    """Split the level schedule into ≤ max_chunks work-balanced groups.

    Per-handoff overhead (future round-trip) is amortized over a group of
    levels; balancing by cmod count keeps both sides of the pipeline busy.
    """
    n = plan.n_levels
    if n == 0:
        return []
    work = np.array([1.0 + s.shape[0] for s in plan.upd_src1])
    cum = np.cumsum(work)
    targets = cum[-1] * np.arange(1, min(max_chunks, n)) / min(max_chunks, n)
    cuts = np.unique(np.searchsorted(cum, targets))
    bounds = np.concatenate([[0], cuts + 1, [n]])
    bounds = np.unique(bounds)
    return [np.arange(bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def cholesky_execute_overlapped(plan: CholeskyPlan, a_vals: np.ndarray,
                                dtype=torch.float64, overlap: bool = True,
                                max_chunks: int = 16, device="cuda"
                                ) -> Tuple[np.ndarray, dict]:
    """Numeric phase with bundle emission one level-group ahead.

    Level ℓ+1's padded index bundles depend only on the plan (pattern), not
    on numeric results, so emission overlaps the device's level-ℓ step.
    Levels are batched into ≤ ``max_chunks`` work-balanced groups so the
    per-handoff thread overhead is amortized (etree schedules routinely have
    hundreds of tiny levels).  A group's bundles are packed into one host
    array on the worker, so the device copy is one transfer per group.
    """
    state = [init_values(plan, a_vals, dtype, device)]
    groups = _level_groups(plan, max_chunks)

    def inspect_fn(k: int):
        return pack_bundles([emit_level_bundle(plan, int(ell))
                             for ell in groups[k]])

    def execute_fn(k: int, packed) -> None:
        state[0] = run_levels(state[0], packed)

    _, ostats = run_overlapped(len(groups), inspect_fn, execute_fn, overlap)
    vals = state[0]
    t0 = time.perf_counter()
    # deliberate drain: queued device work is waited on inside the timed
    # region so the stats stay comparable with the sync path (which drains
    # before stamping)
    _drain(vals)
    drain = time.perf_counter() - t0
    execute_s = ostats.execute_s + drain
    wall_s = ostats.wall_s + drain
    stats = dict(execute_s=execute_s, emit_s=ostats.inspect_s,
                 wall_s=wall_s,
                 hidden_s=max(0.0, ostats.inspect_s + execute_s - wall_s),
                 overlap=ostats.overlap, n_levels=plan.n_levels,
                 nnz_l=plan.nnz, flops=plan.flops())
    return vals[:plan.nnz].cpu().numpy(), stats


# ---------------------------------------------------------------------------
# Op-registry plan types: chunk sets serialize through the generic
# serializer, so their names live in the registry's type table next to
# their definitions (the per-op plan dataclasses register via OpSpec).
# ---------------------------------------------------------------------------

from .ops import register_plan_type  # noqa: E402

register_plan_type("gather_chunkset", GatherChunkSet)
register_plan_type("block_chunkset", BlockChunkSet)
register_plan_type("block_chunk", BlockChunk)

"""SpGEMM: row-by-row (Gustavson) formulation, REAP-split into
host inspection (core.inspector) + device execution (this module).

Port of ``repro.core.spgemm``.  Two executors:

* ``gather`` — element bundles; the device does gather → multiply →
  ``index_add_`` into one segment per output entry.
* ``block`` — BSR tiles; the device runs kernel K1 (``kernels/bsr_spgemm``)
  over the inspector's schedule, or its plain ``einsum`` + ``index_add_``
  version with ``use_kernel=False``.

Plans are pattern-pure (core.inspector); executors take the numeric values
separately, so a cached plan serves any number of same-pattern calls.
Every executor takes host arrays and returns host arrays: the device copy
back (``.cpu().numpy()``) sits at the return, where the reference does
``np.asarray``.

The numpy reference ``spgemm_ref_numpy`` doubles as the CPU-library baseline.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..kernels.bsr_spgemm import (bsr_spgemm_plain, bsr_spgemm_schedule,
                                  prepare_schedule)
from .formats import BsrPattern, CSR
from .inspector import (SpGemmBlockPlan, SpGemmGatherPlan, choose_spgemm_path,
                        csr_pattern_digest, fingerprint_pattern,
                        inspect_spgemm_block, inspect_spgemm_gather, next_pow2)


# ---------------------------------------------------------------------------
# Reference / CPU baseline
# ---------------------------------------------------------------------------

def spgemm_ref_numpy(a: CSR, b: CSR) -> CSR:
    """Vectorized numpy Gustavson SpGEMM — the CPU library stand-in."""
    from .inspector import _ranges
    b_row_len = b.row_lengths
    k = a.indices
    counts = b_row_len[k]
    a_idx = np.repeat(np.arange(a.nnz, dtype=np.int64), counts)
    b_idx = _ranges(b.indptr[k], counts)
    out_row = np.repeat(a.nnz_rows(), counts)
    out_col = b.indices[b_idx]
    vals = a.data[a_idx] * b.data[b_idx]
    key = out_row * np.int64(b.n_cols) + out_col
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(uniq.shape[0], dtype=a.data.dtype)
    np.add.at(acc, inv, vals)
    indptr = np.zeros(a.n_rows + 1, dtype=np.int64)
    rows = (uniq // b.n_cols).astype(np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(a.n_rows, b.n_cols, indptr, (uniq % b.n_cols).astype(np.int64), acc)


# ---------------------------------------------------------------------------
# Gather executor
# ---------------------------------------------------------------------------

def _gather_math(a_data: torch.Tensor, b_data: torch.Tensor,
                 a_idx: torch.Tensor, b_idx: torch.Tensor,
                 out_idx: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Gather → multiply → merge into ``n_seg + 1`` segments; the last one
    takes the dead (padding) partials and is dropped.

    Dead gathers index the appended zero slot (``len(a_data)`` /
    ``len(b_data)``) and dead outputs the ``n_seg`` segment: every index
    stays in range, which CUDA checks where JAX would clamp.
    ``index_add_`` sums in another order than the reference's sorted
    segment sum (atomics on CUDA), so values agree to rounding only.
    """
    zero = a_data.new_zeros(1)
    a_data = torch.cat([a_data, zero])
    b_data = torch.cat([b_data, zero.to(b_data.dtype)])
    pp = a_data.index_select(0, a_idx) * b_data.index_select(0, b_idx)
    c = pp.new_zeros(n_seg + 1)
    return c.index_add_(0, out_idx, pp)[:n_seg]


def spgemm_gather_execute(plan: SpGemmGatherPlan, a_data: np.ndarray,
                          b_data: np.ndarray, device="cuda") -> np.ndarray:
    dev = resolve_device(device)
    c = _gather_math(to_device(a_data, dev), to_device(b_data, dev),
                     to_device(plan.a_idx, dev), to_device(plan.b_idx, dev),
                     to_device(plan.out_idx, dev), plan.c_nnz)
    return c.cpu().numpy()


def spgemm_gather_execute_chunk(plan: SpGemmGatherPlan, a_data: np.ndarray,
                                b_data: np.ndarray, device="cuda"
                                ) -> np.ndarray:
    """Execute one chunk plan with bucketed shapes; returns (c_nnz,) values.

    ``c_cap`` is a power of two ≥ the chunk's c_nnz and the index arrays
    are padded to power-of-two tile counts, as in the reference (it bounds
    the distinct launch shapes across a stream of chunks).
    """
    dev = resolve_device(device)
    c_cap = next_pow2(plan.c_nnz)
    n = plan.a_idx.shape[0]
    cap = next_pow2(max(1, n // max(1, plan.tile))) * plan.tile
    pad = cap - n
    a_idx = np.concatenate([plan.a_idx, np.full(pad, len(a_data), np.int64)])
    b_idx = np.concatenate([plan.b_idx, np.full(pad, len(b_data), np.int64)])
    # dead slots (pad + the plan's own tile padding) map to the c_cap segment
    out_idx = np.concatenate([plan.out_idx, np.full(pad, plan.c_nnz, np.int64)])
    out_idx = np.where(out_idx >= plan.c_nnz, c_cap, out_idx)
    c = _gather_math(to_device(a_data, dev), to_device(b_data, dev),
                     to_device(a_idx, dev), to_device(b_idx, dev),
                     to_device(out_idx, dev), c_cap)
    return c[:plan.c_nnz].cpu().numpy()


# ---------------------------------------------------------------------------
# Block executor — kernel K1, or its plain version
# ---------------------------------------------------------------------------

def _k1_schedule(plan: SpGemmBlockPlan):
    """The plan's schedule in K1's form, memoized as a plain attribute
    (pattern-pure; serialization skips it)."""
    cached = getattr(plan, "_k1_schedule", None)
    if cached is None:
        cached = prepare_schedule(plan.schedule)
        plan._k1_schedule = cached
    return cached


def spgemm_block_execute(plan: SpGemmBlockPlan, a_data: np.ndarray,
                         b_data: np.ndarray, use_kernel: bool = True,
                         device="cuda") -> np.ndarray:
    """Returns the dense (n_out_blocks, block, block) float32 output tiles.

    ``a_data``/``b_data`` are the operands' CSR value arrays; the plan's
    BsrPattern scatters them into tiles (the per-call value pass).
    ``use_kernel`` picks K1 (on CUDA; the plain version on CPU tensors)
    over the plain ``einsum`` + ``index_add_`` version.
    """
    dev = resolve_device(device)
    if plan.n_pairs == 0:
        return np.zeros((plan.n_out_blocks, plan.block, plan.block), np.float32)
    a_blocks = to_device(plan.a_pat.scatter(a_data), dev)
    b_blocks = to_device(plan.b_pat.scatter(b_data), dev)
    if use_kernel:
        out = bsr_spgemm_schedule(
            _k1_schedule(plan), a_blocks, b_blocks,
            # reaplint: disable=REAP004 no per-shape compile: K1 and the
            # torch ops take any shape, so plan-static shapes cost nothing
            n_out_blocks=plan.n_out_blocks)
    else:
        out = bsr_spgemm_plain(
            a_blocks, b_blocks, to_device(plan.a_id, dev),
            to_device(plan.b_id, dev), to_device(plan.out_id, dev),
            # reaplint: disable=REAP004 no per-shape compile (as above)
            n_out_blocks=plan.n_out_blocks)
    return out.cpu().numpy()


def block_result_to_dense(plan: SpGemmBlockPlan, c_blocks: np.ndarray
                          ) -> np.ndarray:
    bs = plan.block
    out = np.zeros((plan.a_pat.n_rows, plan.b_pat.n_cols), np.float32)
    for t in range(plan.n_out_blocks):
        r0, c0 = plan.out_brow[t] * bs, plan.out_bcol[t] * bs
        out[r0:r0 + bs, c0:c0 + bs] = c_blocks[t]
    return out


def block_result_to_csr(plan: SpGemmBlockPlan, c_blocks: np.ndarray,
                        n_rows: int, n_cols: int) -> CSR:
    """Output tiles → CSR, without materializing the dense matrix.

    Equivalent to ``CSR.from_dense(block_result_to_dense(...))`` (exact
    zeros dropped, entries row-major) but the extraction cost scales with
    the stored *block* pattern, not n² — and the ordering permutation is
    pattern-pure (``plan.out_entry_order``), so the per-call tail of the
    planned block path is a gather + mask + bincount, no sort.
    """
    perm, rows, cols = plan.out_entry_order()
    flat = c_blocks.reshape(-1)[perm]
    keep = (flat != 0) & (rows < n_rows) & (cols < n_cols)
    r, vals = rows[keep], flat[keep]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(r, minlength=n_rows))
    return CSR(n_rows, n_cols, indptr, cols[keep], vals)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def spgemm(a: CSR, b: CSR, method: str = "auto", block: int = 128,
           use_kernel: bool = True, tile: int = 1024,
           plan=None, device="cuda") -> Tuple[CSR, dict]:
    """C = A @ B with the REAP split on ``device``. Returns (C, stats).

    stats records the inspector/executor time split (paper Fig 7).  This is
    the plain synchronous path; runtime.api.ReapRuntime adds plan caching
    and inspector/executor overlap on top of the same stages.

    ``plan`` accepts a pre-built ``SpGemmGatherPlan`` or ``SpGemmBlockPlan``
    (e.g. from ``runtime.PlanCache``): inspection is skipped, the executor
    path is chosen by the plan's type, and ``method``/``block``/``tile`` are
    ignored — the plan already fixed them.
    """
    dev = resolve_device(device)
    inspect_s = 0.0
    if plan is None:
        if method == "auto":
            method = choose_spgemm_path(a, b, block)
        t0 = time.perf_counter()
        if method == "gather":
            plan = inspect_spgemm_gather(a, b, tile)
        elif method == "block":
            plan = inspect_spgemm_block(a, b, block)
        else:
            raise ValueError(f"unknown method {method!r}")
        inspect_s = time.perf_counter() - t0

    if isinstance(plan, SpGemmGatherPlan):
        t0 = time.perf_counter()
        c_data = spgemm_gather_execute(plan, a.data, b.data, dev)
        exec_s = time.perf_counter() - t0
        c = CSR(a.n_rows, b.n_cols, plan.c_indptr, plan.c_indices, c_data)
        stats = dict(method="gather", inspect_s=inspect_s,
                     execute_s=exec_s, flops=plan.flops(), n_pp=plan.n_pp)
        return c, stats
    if isinstance(plan, SpGemmBlockPlan):
        t0 = time.perf_counter()
        c_blocks = spgemm_block_execute(plan, a.data, b.data,
                                        use_kernel=use_kernel, device=dev)
        exec_s = time.perf_counter() - t0
        c = block_result_to_csr(plan, c_blocks, a.n_rows, b.n_cols)
        stats = dict(method="block", inspect_s=inspect_s,
                     execute_s=exec_s, flops=plan.flops(),
                     n_pairs=plan.n_pairs, fill=plan.a_pat.fill)
        return c, stats
    raise TypeError(f"unsupported plan type {type(plan).__name__}")


# ---------------------------------------------------------------------------
# Op registry: SpGEMM as planned ops (runtime.ops protocol)
# ---------------------------------------------------------------------------
#
# "spgemm" is a pure router: it resolves method="auto" (caching the
# heuristic's decision per pattern in the runtime's route cache) and
# forwards to the concrete "spgemm_gather" / "spgemm_block" ops.  The
# concrete specs keep the reference's fingerprint op strings and params, so
# both packages key the same pattern alike.

from ..runtime.ops import OpCapabilities, OpSpec, register_op  # noqa: E402


def _spgemm_digests(a: CSR, b: CSR, digests):
    # each operand pattern is hashed exactly once per call; the routing key
    # and the plan key share these digests
    return digests if digests is not None else (csr_pattern_digest(a),
                                                csr_pattern_digest(b))


def _route_spgemm(operands, cfg, routes, *, method: str = "auto",
                  digests=None, **kw):
    a, b = operands
    digests = _spgemm_digests(a, b, digests)
    if method == "auto":
        # the routing heuristic builds A's block structure (O(nnz log nnz));
        # cache the decision per pattern like any other plan
        route_fp = fingerprint_pattern("route", (a, b), digests,
                                       block=cfg.block)
        method, _ = routes.get_or_build(
            route_fp, lambda: choose_spgemm_path(a, b, cfg.block))
    if method not in ("gather", "block"):
        raise ValueError(f"unknown method {method!r}")
    return f"spgemm_{method}", dict(kw, digests=digests)


def _fp_spgemm_gather(operands, cfg, *, chunked, digests=None, **kw):
    a, b = operands
    digests = _spgemm_digests(a, b, digests)
    if chunked:
        return fingerprint_pattern("spgemm_gather_chunked", (a, b), digests,
                                   tile=cfg.tile, n_chunks=cfg.n_chunks)
    return fingerprint_pattern("spgemm_gather", (a, b), digests,
                               tile=cfg.tile)


def _inspect_spgemm_gather(operands, cfg, fp, **kw):
    a, b = operands
    return inspect_spgemm_gather(a, b, cfg.tile, fp)


def _exec_spgemm_gather(plan, operands, cfg, *, overlap, **kw):
    a, b = operands
    c, stats = spgemm(a, b, plan=plan, device=cfg.device)
    stats["overlap"] = False
    return c, stats


def _exec_spgemm_gather_chunked(cached, operands, cfg, *, overlap, **kw):
    from ..runtime.pipeline import spgemm_gather_chunked
    a, b = operands
    c, stats, chunkset = spgemm_gather_chunked(
        a, b, n_chunks=cfg.n_chunks, tile=cfg.tile, overlap=overlap,
        chunkset=cached, device=cfg.device)
    return c, stats, chunkset


def _shard_spgemm_gather(cached, operands, cfg, *, mesh, **kw):
    from ..runtime.shard import sharded_spgemm_gather
    a, b = operands
    return sharded_spgemm_gather(a, b, mesh, tile=cfg.tile, plan=cached)


def _fp_spgemm_block(operands, cfg, *, chunked, digests=None, **kw):
    a, b = operands
    digests = _spgemm_digests(a, b, digests)
    if chunked:
        return fingerprint_pattern("spgemm_block_chunked", (a, b), digests,
                                   block=cfg.block, n_chunks=cfg.n_chunks)
    return fingerprint_pattern("spgemm_block", (a, b), digests,
                               block=cfg.block)


def _inspect_spgemm_block(operands, cfg, fp, **kw):
    a, b = operands
    return inspect_spgemm_block(a, b, cfg.block, fp)


def _exec_spgemm_block(plan, operands, cfg, *, overlap, **kw):
    a, b = operands
    c, stats = spgemm(a, b, plan=plan, use_kernel=cfg.use_kernel,
                      device=cfg.device)
    stats["overlap"] = False
    return c, stats


def _exec_spgemm_block_chunked(cached, operands, cfg, *, overlap, **kw):
    from ..runtime.pipeline import spgemm_block_chunked
    a, b = operands
    c, stats, chunkset = spgemm_block_chunked(
        a, b, block=cfg.block, n_chunks=cfg.n_chunks, overlap=overlap,
        use_kernel=cfg.use_kernel, chunkset=cached, device=cfg.device)
    return c, stats, chunkset


register_op(OpSpec(tag="spgemm", route=_route_spgemm))

register_op(OpSpec(
    tag="spgemm_gather",
    fingerprint=_fp_spgemm_gather,
    inspect=_inspect_spgemm_gather,
    execute_sync=_exec_spgemm_gather,
    execute_chunked=_exec_spgemm_gather_chunked,
    shard_plan=_shard_spgemm_gather,
    plan_types={"spgemm_gather": SpGemmGatherPlan},
    fingerprint_ops=("spgemm_gather", "spgemm_gather_chunked"),
    allowed_kw=("digests",),
    capabilities=OpCapabilities(shardable=True),
))

register_op(OpSpec(
    tag="spgemm_block",
    fingerprint=_fp_spgemm_block,
    inspect=_inspect_spgemm_block,
    execute_sync=_exec_spgemm_block,
    execute_chunked=_exec_spgemm_block_chunked,
    plan_types={"spgemm_block": SpGemmBlockPlan, "bsr_pattern": BsrPattern},
    fingerprint_ops=("spgemm_block", "spgemm_block_chunked"),
    allowed_kw=("digests",),
))

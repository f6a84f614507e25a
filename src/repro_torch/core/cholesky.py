"""Sparse Cholesky (left-looking, simplicial LL^T) — REAP split.

Port of ``repro.core.cholesky``.  Host (core.etree.inspect_cholesky) has
already produced a CholeskyPlan: L's symbolic pattern, etree level sets,
and per-level update triples.  This module is the device-side numeric
executor:

  per level ℓ (all columns independent — the paper's parallel pipelines):
    1. cmod:   vals[dst] -= vals[src1] * vals[src2]     (dot-product PEs)
    2. cdiv:   vals[diag] = sqrt(vals[diag])            (Div/SqRoot PEs)
               vals[offd] /= vals[diag of column]

The level loop is the only host interaction; within a level everything is a
few torch ops over padded (bucketed) index arrays.  ``dst`` holds
duplicates, so cmod is ``index_add_`` (an indexed ``-=`` would drop them).
The value array is updated in place, standing in for the reference's
buffer donation.

The per-level host work (bundle-emit: building the padded cmod/cdiv index
arrays) is factored into ``emit_level_bundle`` so runtime.pipeline can
prepare level ℓ+1 on a worker thread while the device executes level ℓ —
the software analogue of the paper's CPU/FPGA overlap.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from .etree import CholeskyPlan, cholesky_values, inspect_cholesky
from .formats import CSR
from .inspector import next_pow2


def _pad(arr: np.ndarray, size: int, fill: int) -> np.ndarray:
    # stays numpy: bundle-emit may run on a worker thread, and host→device
    # transfer belongs to the executor step
    out = np.full(size, fill, dtype=np.int64)
    out[:arr.shape[0]] = arr
    return out


def _level_step(vals: torch.Tensor, src1, src2, dst, diag_idx, off_idx,
                off_diag) -> torch.Tensor:
    """One etree level, in place: cmod (gather–multiply–scatter-sub) then
    cdiv.  Dead (padded) slots read and write the scratch slot only; the
    duplicate scratch writes of the two copies all carry one value."""
    contrib = vals[src1] * vals[src2]
    vals.index_add_(0, dst, contrib, alpha=-1)
    vals.index_copy_(0, diag_idx, vals[diag_idx].sqrt())
    vals.index_copy_(0, off_idx, vals[off_idx] / vals[off_diag])
    return vals


def emit_level_bundle(plan: CholeskyPlan, ell: int) -> tuple:
    """Bundle-emit stage for level ``ell``: padded index arrays (numpy).

    Pure host work with no dependence on numeric values, so it can run on a
    worker thread one level ahead of the executor.
    """
    scratch = plan.nnz                           # dead-op slot
    col_of_slot = plan.col_of_slot()
    s1, s2, d = plan.upd_src1[ell], plan.upd_src2[ell], plan.upd_dst[ell]
    cols = plan.cols_per_level[ell]
    diag = plan.diag_pos[cols]
    # off-diagonal slots of this level's columns + their diag slot
    seg_starts = plan.col_ptr[cols] + 1          # skip the diagonal
    seg_ends = plan.col_ptr[cols + 1]
    counts = seg_ends - seg_starts
    from .inspector import _ranges
    off = _ranges(seg_starts, counts)
    off_diag = plan.diag_pos[col_of_slot[off]]

    bu = next_pow2(max(1, s1.shape[0]))
    bc = next_pow2(max(1, diag.shape[0]))
    bo = next_pow2(max(1, off.shape[0]))
    return (_pad(s1, bu, scratch), _pad(s2, bu, scratch),
            _pad(d, bu, scratch), _pad(diag, bc, scratch),
            _pad(off, bo, scratch), _pad(off_diag, bo, scratch))


def pack_bundles(bundles: Sequence[tuple]) -> Tuple[np.ndarray, List[int]]:
    """Concatenate level bundles into one host array (one device copy)."""
    arrays = [arr for bundle in bundles for arr in bundle]
    return np.concatenate(arrays), [arr.shape[0] for arr in arrays]


def run_levels(vals: torch.Tensor, packed: Tuple[np.ndarray, List[int]]
               ) -> torch.Tensor:
    """Copy packed level bundles to ``vals``' device and run their steps."""
    flat, sizes = packed
    parts = torch.split(to_device(flat, vals.device), sizes)
    for i in range(0, len(parts), 6):
        vals = _level_step(vals, *parts[i:i + 6])
    return vals


def init_values(plan: CholeskyPlan, a_vals: np.ndarray,
                dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Scatter A's lower-triangle values into the L value array (+scratch)."""
    vals = np.zeros(plan.nnz + 1, dtype=np.float64 if dtype == torch.float64
                    else np.float32)
    vals[plan.a_scatter_pos] = a_vals
    return to_device(vals, resolve_device(device)).to(dtype)


def cholesky_execute(plan: CholeskyPlan, a_vals: np.ndarray,
                     dtype=torch.float64, device="cuda"
                     ) -> Tuple[np.ndarray, dict]:
    """Run the numeric phase synchronously.

    Returns (L values in CSC order, stats).  ``a_vals`` comes from
    ``cholesky_values(a)`` — the plan itself is value-free.
    """
    vals = init_values(plan, a_vals, dtype, device)
    t0 = time.perf_counter()
    for ell in range(plan.n_levels):
        vals = run_levels(vals, pack_bundles([emit_level_bundle(plan, ell)]))
    if vals.is_cuda:
        # reaplint: disable=REAP003 deliberate timed drain: execute_s must
        # measure device completion so sync/overlapped stats stay comparable
        torch.cuda.synchronize(vals.device)
    exec_s = time.perf_counter() - t0
    stats = dict(execute_s=exec_s, n_levels=plan.n_levels,
                 nnz_l=plan.nnz, flops=plan.flops())
    return vals[:plan.nnz].cpu().numpy(), stats


def cholesky(a: CSR, dtype=torch.float64, plan: CholeskyPlan = None,
             device="cuda"):
    """Full REAP sparse Cholesky: A = L L^T. Returns (plan, L values, stats).

    With a pre-built ``plan`` (same pattern as ``a``, e.g. from the runtime
    plan cache) inspection is skipped and the value pass uses the plan's
    precomputed lower-triangle selection — the warm planned-execution path
    ``runtime.ReapRuntime`` routes through.
    """
    device = resolve_device(device)
    inspect_s = 0.0
    if plan is None:
        t0 = time.perf_counter()
        plan = inspect_cholesky(a)
        inspect_s = time.perf_counter() - t0
        a_vals = cholesky_values(a)
    else:
        a_vals = plan.a_values(a)
    vals, stats = cholesky_execute(plan, a_vals, dtype, device)
    stats["inspect_s"] = inspect_s
    return plan, vals, stats


def plan_to_dense_l(plan: CholeskyPlan, vals: np.ndarray) -> np.ndarray:
    out = np.zeros((plan.n, plan.n), dtype=vals.dtype)
    col_of_slot = np.repeat(np.arange(plan.n), np.diff(plan.col_ptr))
    out[plan.row_idx, col_of_slot] = vals
    return out


# ---------------------------------------------------------------------------
# CPU baseline (CHOLMOD simplicial-LL^T stand-in): same plan, numpy loops
# ---------------------------------------------------------------------------

def cholesky_baseline_numpy(plan: CholeskyPlan, a_vals: np.ndarray
                            ) -> Tuple[np.ndarray, float]:
    """Column-at-a-time numpy left-looking factorization (numeric only)."""
    vals = np.zeros(plan.nnz + 1, dtype=np.float64)
    vals[plan.a_scatter_pos] = a_vals
    col_of_slot = plan.col_of_slot()
    t0 = time.perf_counter()
    for ell in range(plan.n_levels):
        s1, s2, d = plan.upd_src1[ell], plan.upd_src2[ell], plan.upd_dst[ell]
        np.subtract.at(vals, d, vals[s1] * vals[s2])
        cols = plan.cols_per_level[ell]
        diag = plan.diag_pos[cols]
        vals[diag] = np.sqrt(vals[diag])
        from .inspector import _ranges
        starts = plan.col_ptr[cols] + 1
        counts = plan.col_ptr[cols + 1] - starts
        off = _ranges(starts, counts)
        vals[off] /= vals[plan.diag_pos[col_of_slot[off]]]
    return vals[:plan.nnz], time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Op registry: sparse Cholesky as a planned op (runtime.ops protocol)
# ---------------------------------------------------------------------------
#
# One fingerprint per pattern (dtype is a value-level choice and stays out
# of the key); `overlap` picks the executor — the etree level schedule is
# the chunk stream, so overlapping lives inside execute_sync rather than a
# separate chunked hook.

from .inspector import fingerprint_pattern  # noqa: E402
from ..runtime.ops import (OpCapabilities, OpSpec,  # noqa: E402
                           register_op)


def _fp_cholesky(operands, cfg, *, chunked, **kw):
    (a,) = operands
    return fingerprint_pattern("cholesky", (a,))


def _inspect_cholesky(operands, cfg, fp, **kw):
    (a,) = operands
    return inspect_cholesky(a, fp)


def _exec_cholesky(plan, operands, cfg, *, overlap, dtype=torch.float64,
                   **kw):
    (a,) = operands
    if overlap:
        from ..runtime.pipeline import cholesky_execute_overlapped
        vals, stats = cholesky_execute_overlapped(plan, plan.a_values(a),
                                                  dtype, overlap=True,
                                                  device=cfg.device)
    else:
        _, vals, stats = cholesky(a, dtype, plan=plan, device=cfg.device)
        stats["overlap"] = False
    return (plan, vals), stats


register_op(OpSpec(
    tag="cholesky",
    fingerprint=_fp_cholesky,
    inspect=_inspect_cholesky,
    execute_sync=_exec_cholesky,
    plan_types={"cholesky": CholeskyPlan},
    allowed_kw=("dtype",),
    capabilities=OpCapabilities(dtypes=("float32", "float64"),
                                routing="host"),
))

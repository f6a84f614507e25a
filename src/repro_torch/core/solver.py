"""Planned iterative solver: CG/PCG where every matvec is a registered op.

Port of ``repro.core.solver``.  Iterative solvers are *the* repeated-pattern
workload the REAP split targets: A's sparsity is fixed across hundreds of
matvecs, so one inspection pays for the whole solve — and for every later
solve that shares the pattern (time-stepping PDEs re-assembling
coefficients).

Two pieces:

* the ``spmv`` op — ``y = A @ x`` for CSR ``A``, planned on top of the
  SpMM machinery: the kernel computes ``X @ W``, so the inspector builds
  the *pattern-pure* transpose of A (indices only, values never touched)
  and a value permutation, and execution is one value gather + the SpMM
  tile scatter + the SpMM executor (kernel K2 with T = 1 in float32, its
  plain version in float64).  Registered at the bottom of this file.
* :func:`cg_solve` — (preconditioned) conjugate gradient that drives
  every matvec through ``ReapRuntime.run("spmv", ...)``, optionally
  preconditioned by the registered planned-``cholesky`` op applied to a
  block-Jacobi restriction of A.  The iteration vectors stay float64 on
  the host, as in the reference; each matvec's result comes to the host
  once per iteration.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.bsr_spmm import SpmmPlan, inspect_spmm, spmm_execute
from .formats import CSR
from .inspector import PatternFingerprint, fingerprint_pattern


@dataclasses.dataclass(eq=False)
class SpmvPlan:
    """Pattern-pure plan for ``y = A @ x`` (CSR A).

    ``inner`` is an SpMM plan over A^T's *pattern* (built from indices
    only); ``perm`` maps A's CSR value order to A^T's CSC order, so the
    per-call value pass is one gather plus the SpMM tile scatter.
    """

    n_rows: int
    n_cols: int
    perm: np.ndarray                 # (nnz,) CSR→transpose value gather
    inner: SpmmPlan                  # SpMM plan computing x^T @ A^T
    fingerprint: Optional[PatternFingerprint] = None


def _transpose_pattern(a: CSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Value-free transpose structure: ``(t_indptr, t_indices, perm)``.

    Unlike ``CSR.transpose()`` this never touches ``a.data`` — it is
    inspector-safe by construction (REAP001).
    """
    rows, cols = a.nnz_rows(), a.indices
    perm = np.lexsort((rows, cols))
    t_indptr = np.zeros(a.n_cols + 1, np.int64)
    np.add.at(t_indptr, cols + 1, 1)
    np.cumsum(t_indptr, out=t_indptr)
    return t_indptr, rows[perm].astype(np.int64), perm


def inspect_spmv(a: CSR, block: int = 128,
                 fingerprint: Optional[PatternFingerprint] = None
                 ) -> SpmvPlan:
    """Stage-2 plan-build: A^T's block schedule + the value permutation."""
    t_indptr, t_indices, perm = _transpose_pattern(a)
    at_pattern = CSR(a.n_cols, a.n_rows, t_indptr, t_indices,
                     np.zeros(perm.shape[0], np.float32))
    inner = inspect_spmm(at_pattern, block)
    return SpmvPlan(a.n_rows, a.n_cols, perm, inner, fingerprint)


def spmv_execute(plan: SpmvPlan, a_data: np.ndarray, x: np.ndarray,
                 use_kernel: bool = True, dtype=np.float32,
                 device="cuda") -> np.ndarray:
    """y = A @ x from a plan + this call's values.  Returns (n_rows,)."""
    y = spmm_execute(plan.inner, np.asarray(x, dtype)[None, :],
                     np.asarray(a_data)[plan.perm],
                     use_kernel=use_kernel, dtype=dtype, device=device)
    return y[0]


def spmv_ref_numpy(a: CSR, x: np.ndarray) -> np.ndarray:
    """Dense-product oracle for tests/benchmarks."""
    return a.to_dense().astype(np.float64) @ np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# Planned (preconditioned) conjugate gradient
# ---------------------------------------------------------------------------

def _block_diag_restrict(a: CSR, bs: int) -> CSR:
    """A's block-diagonal restriction (block-Jacobi preconditioner matrix).

    Keeps entry (i, j) iff ``i // bs == j // bs``; for SPD A the result
    is SPD (principal block submatrices), so the planned Cholesky op can
    factor it.
    """
    rows, cols = a.nnz_rows(), a.indices
    keep = (rows // bs) == (cols // bs)
    indptr = np.zeros(a.n_rows + 1, np.int64)
    np.add.at(indptr, rows[keep] + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(a.n_rows, a.n_cols, indptr, cols[keep], a.data[keep])


def _ll_t_solve(col_ptr: np.ndarray, row_idx: np.ndarray, vals: np.ndarray,
                b: np.ndarray) -> np.ndarray:
    """Solve ``L L^T z = b`` with L in the CholeskyPlan CSC layout
    (columns sorted, diagonal slot first).  Host loops, O(nnz(L))."""
    n = b.shape[0]
    y = b.astype(np.float64).copy()
    for k in range(n):                      # forward: L y = b
        s, e = col_ptr[k], col_ptr[k + 1]
        y[k] /= vals[s]
        y[row_idx[s + 1:e]] -= vals[s + 1:e] * y[k]
    z = y
    for k in range(n - 1, -1, -1):          # backward: L^T z = y
        s, e = col_ptr[k], col_ptr[k + 1]
        z[k] -= np.dot(vals[s + 1:e], z[row_idx[s + 1:e]])
        z[k] /= vals[s]
    return z


def cg_solve(a: CSR, b: np.ndarray, runtime=None, *, tol: float = 1e-8,
             maxiter: Optional[int] = None, precond: Optional[str] = None,
             precond_block: int = 32, dtype=np.float64, device="cuda"):
    """Planned conjugate gradient for SPD ``A``: solve ``A x = b``.

    Every matvec goes through the registered ``spmv`` op on ``runtime``
    (a private sync runtime on ``device`` is created when none is given),
    so the pattern is inspected exactly once per solve *sequence* —
    iterations 2..N and every later same-pattern solve replay the warm
    plan.

    ``precond="cholesky"`` factors the block-Jacobi restriction of A
    (block size ``precond_block``) through the registered planned
    Cholesky op and applies M⁻¹ by host triangular solves.

    ``dtype`` is the matvec value dtype (numpy float32 or float64); the
    factorization runs in the matching torch dtype.

    Returns ``(x, info)`` where info carries ``converged``,
    ``iterations``, ``relres``, ``spmv_cache_hits`` and
    ``preconditioned``.
    """
    from ..runtime.api import ReapRuntime   # runtime imports core: lazy
    if runtime is None:
        runtime = ReapRuntime(n_chunks=1, overlap=False, device=device)
    n = a.n_rows
    if a.n_cols != n:
        raise ValueError("cg_solve needs a square (SPD) matrix")
    dtype = np.dtype(dtype)
    b = np.asarray(b, np.float64)
    x = np.zeros(n, np.float64)
    r = b.copy()

    apply_m = None
    if precond == "cholesky":
        m = _block_diag_restrict(a, precond_block)
        ch_dtype = torch.float64 if dtype == np.float64 else torch.float32
        (plan_l, vals_l), _ = runtime.run("cholesky", m, dtype=ch_dtype)
        vals_l = np.asarray(vals_l, np.float64)

        def apply_m(res, _p=plan_l, _v=vals_l):
            return _ll_t_solve(_p.col_ptr, _p.row_idx, _v, res)
    elif precond is not None:
        raise ValueError(f"unknown preconditioner {precond!r} "
                         "(expected None or 'cholesky')")

    bnorm = float(np.linalg.norm(b)) or 1.0
    relres = float(np.linalg.norm(r)) / bnorm
    z = apply_m(r) if apply_m else r.copy()
    p = z.copy()
    rz = float(r @ z)
    maxiter = 10 * n if maxiter is None else maxiter
    hits = it = 0
    converged = relres < tol
    while not converged and it < maxiter:
        q, st = runtime.run("spmv", a, p, dtype=dtype)
        q = np.asarray(q, np.float64)
        hits += int(st["cache_hit"])
        pq = float(p @ q)
        if pq <= 0.0:
            break                            # not SPD (or total breakdown)
        alpha = rz / pq
        x += alpha * p
        r -= alpha * q
        it += 1
        relres = float(np.linalg.norm(r)) / bnorm
        if relres < tol:
            converged = True
            break
        z = apply_m(r) if apply_m else r
        rz_new = float(r @ z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
    info = dict(converged=converged, iterations=it, relres=relres,
                spmv_cache_hits=hits, preconditioned=apply_m is not None)
    return x, info


# ---------------------------------------------------------------------------
# Op registry: SpMV admitted as a planned op — like spmm/block_attention,
# this block is the entire integration with runtime and cache.
# ---------------------------------------------------------------------------

from ..runtime.ops import OpCapabilities, OpSpec, register_op  # noqa: E402


def _fp_spmv(operands, cfg, *, chunked, **kw):
    a = operands[0]
    return fingerprint_pattern("spmv", (a,), block=cfg.block)


def _inspect_spmv(operands, cfg, fp, **kw):
    return inspect_spmv(operands[0], cfg.block, fp)


def _exec_spmv(plan, operands, cfg, *, overlap, dtype=np.float32, **kw):
    a, x = operands
    t0 = time.perf_counter()
    y = spmv_execute(plan, a.data, x, use_kernel=cfg.use_kernel, dtype=dtype,
                     device=cfg.device)
    exec_s = time.perf_counter() - t0
    stats = dict(method="spmv", execute_s=exec_s, overlap=False,
                 n_jobs=plan.inner.n_jobs, flops=2 * a.nnz)
    return y, stats


register_op(OpSpec(
    tag="spmv",
    fingerprint=_fp_spmv,
    inspect=_inspect_spmv,
    execute_sync=_exec_spmv,
    plan_types={"spmv": SpmvPlan},
    allowed_kw=("dtype",),
    capabilities=OpCapabilities(dtypes=("float32", "float64"),
                                routing="host"),
))

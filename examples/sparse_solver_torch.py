"""End-to-end sparse SPD solves on the PyTorch port: A x = b via *planned*
conjugate gradient.

The iterative-solver workload is the purest case for the REAP split: one
sparsity pattern, hundreds of matvecs.  ``cg_solve`` drives every matvec
through the registered ``spmv`` op, and its block-Jacobi preconditioner
through the registered planned-``cholesky`` op — so the first solve pays
inspection exactly once per op, iterations 2..N replay the warm spmv
plan, and *later same-pattern solves* (time-stepping with re-assembled
coefficients) run with zero inspection at all.  It runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/sparse_solver_torch.py [--device cpu]
        [--plan-store DIR] [--exec-store DIR]
"""
import argparse
import time

import numpy as np

from repro_torch.core import CSR, random_spd_csr
from repro_torch.core.solver import cg_solve
from repro_torch.runtime import ReapRuntime, RuntimeConfig, add_runtime_args

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
add_runtime_args(ap)                 # --device (default cuda), stores, ...
args = ap.parse_args()

rng = np.random.default_rng(7)
n = 1200
a = random_spd_csr(n, density=0.01, rng=rng)
# the shared flag set + this script's own picks, via the one sanctioned path
runtime = ReapRuntime(RuntimeConfig.from_args(
    args, n_chunks=1, overlap=False, block=64))

# Repeated-pattern workload: same sparsity, three different value/rhs sets
# (e.g. a time-stepping PDE re-assembling coefficients each step), in
# float64 (fp64 matvecs and factorization)
for step in range(3):
    if step:
        # new values on the identical pattern: scale A's entries
        a = CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                a.data * (1.0 + 0.1 * step))
    b = rng.standard_normal(n)
    print(f"step {step}: n={n}, nnz={a.nnz}")
    t0 = time.perf_counter()
    x, info = cg_solve(a, b, runtime, tol=1e-10, precond="cholesky",
                       dtype=np.float64, device=runtime.device)
    dt = time.perf_counter() - t0
    assert info["converged"], info
    x_ref = np.linalg.solve(a.to_dense(), b)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    resid = np.linalg.norm(a.to_dense() @ x - b) / np.linalg.norm(b)
    warm = "warm" if step else "cold"
    print(f"  pcg [{warm}]: {info['iterations']} iters in {dt * 1e3:.0f}ms, "
          f"relres {info['relres']:.2e}, spmv cache hits "
          f"{info['spmv_cache_hits']}/{info['iterations']}")
    print(f"  ‖x−x_ref‖/‖x_ref‖ = {err:.2e}, ‖Ax−b‖/‖b‖ = {resid:.2e}")
    assert err < 1e-5, "diverged from the dense reference"
    assert resid < 1e-8, "solve failed"

# plan amortization across the whole sequence: spmv and cholesky were each
# resolved non-warm exactly once (a fresh inspection, or — under a warm
# --plan-store — a disk load); every other call replayed in-memory plans
per_op = runtime.cache_stats()["per_op"]
assert per_op["spmv"]["misses"] + per_op["spmv"]["store_hits"] == 1, per_op
assert per_op["spmv"]["hits"] > 0, per_op
assert per_op["cholesky"]["misses"] \
    + per_op["cholesky"]["store_hits"] == 1, per_op
assert per_op["cholesky"]["hits"] == 2, per_op        # steps 1 and 2
print(f"plan cache: spmv {per_op['spmv']['hits']} hits / "
      f"{per_op['spmv']['misses']} miss, cholesky "
      f"{per_op['cholesky']['hits']} hits / "
      f"{per_op['cholesky']['misses']} miss — inspection amortized ✓")
print("solved ✓")

"""Quickstart on the PyTorch port: REAP inspector-executor SpGEMM in five
lines.  It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import CSR, random_csr, spgemm, spgemm_ref_numpy
from repro_torch.runtime import ReapRuntime

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# 1. a sparse matrix in a standard format (CSR), like the paper's inputs
rng = np.random.default_rng(0)
a = random_csr(2000, 2000, density=0.002, rng=rng, pattern="powerlaw")
print(f"A: {a.n_rows}x{a.n_cols}, nnz={a.nnz} (density {a.density:.2%})")

# 2. C = A^2 with the REAP split: host inspector (CPU pass: index matching,
#    sorting, merge scheduling) + device executor (regular stream of FLOPs)
c, stats = spgemm(a, a, method="auto", device=args.device)
print(f"C: nnz={c.nnz}; path={stats['method']}; "
      f"inspect={stats['inspect_s'] * 1e3:.1f}ms "
      f"execute={stats['execute_s'] * 1e3:.1f}ms "
      f"({stats['flops'] / 1e6:.1f} MFLOP)")

# 3. validate against the CPU library baseline
ref = spgemm_ref_numpy(a, a)
np.testing.assert_allclose(c.to_dense(), ref.to_dense(), rtol=1e-4,
                           atol=1e-5)
print("matches CPU library baseline ✓")

# 4. the same API drives the block path (kernel K1 on the card, its plain
#    version on the host) on blocky matrices
blocky = random_csr(1024, 1024, density=0.02, rng=rng, pattern="blocky")
c2, stats2 = spgemm(blocky, blocky, method="block", block=32,
                    device=args.device)
np.testing.assert_allclose(c2.to_dense(),
                           spgemm_ref_numpy(blocky, blocky).to_dense(),
                           rtol=1e-4, atol=1e-4)
print(f"block path: {stats2['n_pairs']} tile-pair jobs, "
      f"fill={stats2['fill']:.2%} (on {args.device}) ✓")

# 5. repeated-pattern workloads go through the runtime: the plan cache pays
#    the inspector once per pattern, then replays the plan on new values
rt = ReapRuntime(n_chunks=1, overlap=False, device=args.device)
rt.spgemm(a, a)                                # miss: builds + caches plan
a2 = CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
         rng.standard_normal(a.nnz).astype(a.data.dtype))
c3, stats3 = rt.spgemm(a2, a2)                 # same pattern, fresh values
assert stats3["cache_hit"], stats3
print(f"warm plan cache: hit={stats3['cache_hit']}, "
      f"inspect={stats3['inspect_s'] * 1e3:.2f}ms (amortized away)")

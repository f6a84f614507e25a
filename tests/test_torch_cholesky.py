"""Port parity, sparse Cholesky: ``repro_torch.core.cholesky`` and the
overlapped level pipeline on the CPU against ``repro.core.cholesky`` (x64
on, as ``tests/conftest.py`` sets it).  L values must agree to rtol 1e-10,
atol 1e-12 in float64; the level step's scatter-sub has duplicate
destinations, which ``index_add_`` must all apply."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as P
from repro.runtime import cholesky_execute_overlapped as ref_overlapped
from repro_torch.core.cholesky import pack_bundles, run_levels
from repro_torch.runtime import cholesky_execute_overlapped

CPU = "cpu"
CASES = [("banded", 90, 0.06, 1), ("uniform", 70, 0.08, 2),
         ("blocky", 80, 0.1, 3), ("powerlaw", 60, 0.1, 4)]


def _spd(pkg, pattern, n, density, seed):
    return pkg.random_spd_csr(n, density, np.random.default_rng(seed),
                              pattern)


class TestCholesky:
    @pytest.mark.parametrize("pattern,n,density,seed", CASES)
    def test_sync_matches_reference(self, pattern, n, density, seed):
        a_r, a_p = (_spd(R, pattern, n, density, seed),
                    _spd(P, pattern, n, density, seed))
        _, v_r, _ = R.cholesky(a_r, dtype=jnp.float64)
        plan, v_p, stats = P.cholesky(a_p, dtype=torch.float64, device=CPU)
        assert v_p.dtype == np.float64 and v_p.shape == (plan.nnz,)
        np.testing.assert_allclose(v_p, v_r, rtol=1e-10, atol=1e-12)
        assert stats["n_levels"] == plan.n_levels

    @pytest.mark.parametrize("pattern,n,density,seed", CASES)
    @pytest.mark.parametrize("overlap", [False, True])
    def test_overlapped_matches_reference(self, pattern, n, density, seed,
                                          overlap):
        a_r, a_p = (_spd(R, pattern, n, density, seed),
                    _spd(P, pattern, n, density, seed))
        plan_r, plan_p = R.inspect_cholesky(a_r), P.inspect_cholesky(a_p)
        v_r, _ = ref_overlapped(plan_r, plan_r.a_values(a_r), jnp.float64,
                                overlap=overlap, max_chunks=4)
        v_p, stats = cholesky_execute_overlapped(
            plan_p, plan_p.a_values(a_p), torch.float64, overlap=overlap,
            max_chunks=4, device=CPU)
        np.testing.assert_allclose(v_p, v_r, rtol=1e-10, atol=1e-12)
        assert stats["overlap"] == (overlap and plan_p.n_levels > 1)

    def test_reconstruction_and_numpy_baseline(self):
        a = _spd(P, "banded", 80, 0.08, 5)
        plan, vals, _ = P.cholesky(a, device=CPU)
        l = P.plan_to_dense_l(plan, vals)
        np.testing.assert_allclose(l @ l.T, a.to_dense(), rtol=1e-8,
                                   atol=1e-9)
        base, _ = P.cholesky_baseline_numpy(plan, P.cholesky_values(a))
        np.testing.assert_allclose(vals, base, rtol=1e-10, atol=1e-12)

    def test_float32_matches_reference(self):
        a_r, a_p = (_spd(R, "banded", 60, 0.08, 6),
                    _spd(P, "banded", 60, 0.08, 6))
        _, v_r, _ = R.cholesky(a_r, dtype=jnp.float32)
        _, v_p, _ = P.cholesky(a_p, dtype=torch.float32, device=CPU)
        assert v_p.dtype == np.float32
        np.testing.assert_allclose(v_p, v_r, rtol=1e-5, atol=1e-6)

    def test_level_bundles_bit_identical(self):
        a_r, a_p = (_spd(R, "blocky", 70, 0.1, 7),
                    _spd(P, "blocky", 70, 0.1, 7))
        plan_r, plan_p = R.inspect_cholesky(a_r), P.inspect_cholesky(a_p)
        for ell in range(plan_p.n_levels):
            for u, v in zip(P.emit_level_bundle(plan_p, ell),
                            R.emit_level_bundle(plan_r, ell)):
                assert u.dtype == v.dtype and np.array_equal(u, v)

    def test_duplicate_destinations_all_applied(self):
        # three cmod terms land on slot 0: 16 - (1*1 + 1*2 + 2*2) = 9, then
        # cdiv takes its sqrt (3) and divides slot 3 by it
        packed = pack_bundles([(
            np.array([1, 1, 2]), np.array([1, 2, 2]), np.array([0, 0, 0]),
            np.array([0]), np.array([3]), np.array([0]))])
        vals = torch.tensor([16.0, 1.0, 2.0, 6.0], dtype=torch.float64)
        out = run_levels(vals, packed)
        assert out.tolist() == [3.0, 1.0, 2.0, 2.0]

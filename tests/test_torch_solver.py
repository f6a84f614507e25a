"""Port parity, planned solver: ``repro_torch.core.solver`` on the CPU against
``repro.core.solver`` — ``SpmvPlan`` bit-identical with equal fingerprints
and byte-equal payloads over the five pattern families; ``spmv_execute``
against both reference executors at ``TestPlannedSpmv``'s tolerance (max
error under 1e-5 of max |y|); ``cg_solve`` with and without the planned
Cholesky preconditioner against the reference's iteration count (equal in
float64, within one in float32, where rounding can move the stopping
test), solution (1e-6 relative in float64, 1e-4 in float32) and cache
accounting."""
import numpy as np
import pytest
from _torch_parity import FAMILIES, assert_same_fields, family_csr

import repro.core as R
import repro.core.solver as RS
import repro.runtime as RR
import repro_torch.core as P
import repro_torch.core.solver as PS
import repro_torch.runtime as PR

CPU = "cpu"


def _spd(pkg, n=300, seed=4):
    return pkg.random_spd_csr(n, 0.02, np.random.default_rng(seed))


class TestSpmvPlan:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("block", [16, 64])
    def test_plan_fields_digest_payload(self, family, block):
        a_p = family_csr(P, family, 180, 180, 0.04, 13)
        a_r = family_csr(R, family, 180, 180, 0.04, 13)
        fp_p = P.fingerprint_pattern("spmv", (a_p,), block=block)
        fp_r = R.fingerprint_pattern("spmv", (a_r,), block=block)
        assert fp_p.digest == fp_r.digest and fp_p.params == fp_r.params
        plan_p = PS.inspect_spmv(a_p, block, fp_p)
        plan_r = RS.inspect_spmv(a_r, block, fp_r)
        assert_same_fields(plan_p, plan_r)
        pay_p, pay_r = PR.serialize_plan(plan_p), RR.serialize_plan(plan_r)
        assert sorted(pay_p) == sorted(pay_r)
        for key in pay_r:
            assert np.asarray(pay_p[key]).tobytes() == \
                np.asarray(pay_r[key]).tobytes(), key
        assert_same_fields(PR.deserialize_plan(pay_r), plan_p)
        assert_same_fields(RR.deserialize_plan(pay_p), plan_r)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_transpose_and_restriction_helpers(self, family):
        a_p = family_csr(P, family, 150, 150, 0.05, 14)
        a_r = family_csr(R, family, 150, 150, 0.05, 14)
        for u, v in zip(PS._transpose_pattern(a_p),
                        RS._transpose_pattern(a_r)):
            assert u.dtype == v.dtype and np.array_equal(u, v)
        m_p, m_r = PS._block_diag_restrict(a_p, 32), \
            RS._block_diag_restrict(a_r, 32)
        for name in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(m_p, name), getattr(m_r, name))


class TestSpmvExecute:
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_vs_reference_and_dense(self, dtype):
        rng = np.random.default_rng(3)
        a_p, a_r = _spd(P, seed=3), _spd(R, seed=3)
        x = rng.standard_normal(300)
        plan_p, plan_r = PS.inspect_spmv(a_p, 64), RS.inspect_spmv(a_r, 64)
        ref = RS.spmv_ref_numpy(a_r, x)
        np.testing.assert_array_equal(PS.spmv_ref_numpy(a_p, x), ref)
        scale = np.abs(ref).max()
        got = PS.spmv_execute(plan_p, a_p.data, x, dtype=dtype, device=CPU)
        assert got.dtype == dtype and got.shape == (300,)
        assert np.abs(got - ref).max() / scale < 1e-5
        for use_pallas in (False, True):
            want = RS.spmv_execute(plan_r, a_r.data, x,
                                   use_pallas=use_pallas, dtype=dtype)
            assert np.abs(got - want).max() / scale < 1e-5

    def test_op_cold_warm(self):
        a = _spd(P)
        x = np.random.default_rng(1).standard_normal(300)
        rt = PR.ReapRuntime(block=64, device=CPU)
        y1, s1 = rt.run("spmv", a, x)
        y2, s2 = rt.run("spmv", a, x)
        assert not s1["cache_hit"] and s2["cache_hit"]
        assert s1["method"] == "spmv" and s1["flops"] == 2 * a.nnz
        np.testing.assert_array_equal(y1, y2)
        s_r = RR.ReapRuntime(block=64, use_pallas=False).run(
            "spmv", _spd(R), x)[1]
        assert s1["fingerprint"] == s_r["fingerprint"]
        assert sorted(s1) == sorted(s_r)


class TestCgSolve:
    @pytest.mark.parametrize("precond", [None, "cholesky"])
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_vs_reference(self, precond, dtype):
        a_p, a_r = _spd(P), _spd(R)
        b = np.random.default_rng(4).standard_normal(300)
        tol = 1e-10 if dtype == np.float64 else 1e-5
        kw = dict(tol=tol, dtype=dtype, precond=precond, precond_block=32)
        rt_p = PR.ReapRuntime(n_chunks=1, overlap=False, block=64,
                              device=CPU)
        rt_r = RR.ReapRuntime(n_chunks=1, overlap=False, use_pallas=False,
                              block=64)
        x_p, info_p = PS.cg_solve(a_p, b, rt_p, **kw)
        x_r, info_r = RS.cg_solve(a_r, b, rt_r, **kw)
        assert info_p["converged"] and info_r["converged"]
        assert info_p["preconditioned"] == (precond is not None)
        if dtype == np.float64:
            assert info_p["iterations"] == info_r["iterations"]
            rel = 1e-6
        else:
            assert abs(info_p["iterations"] - info_r["iterations"]) <= 1
            rel = 1e-4
        assert np.linalg.norm(x_p - x_r) / np.linalg.norm(x_r) < rel
        x_ref = np.linalg.solve(a_p.to_dense().astype(np.float64), b)
        assert np.linalg.norm(x_p - x_ref) / np.linalg.norm(x_ref) < rel
        # every iteration after the first replayed the warm spmv plan
        assert info_p["spmv_cache_hits"] == info_p["iterations"] - 1
        per_op = rt_p.cache_stats()["per_op"]
        assert per_op["spmv"]["misses"] == 1
        assert per_op["cholesky"]["misses"] == (precond is not None)

    def test_same_pattern_solves_stay_warm(self):
        """A time-stepping sequence: rescaled coefficients on one pattern,
        a fresh right-hand side each step; only the first solve inspects."""
        a = _spd(P)
        rng = np.random.default_rng(7)
        rt = PR.ReapRuntime(block=64, device=CPU)
        for step in range(3):
            a_s = P.CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                        a.data * (1.0 + 0.1 * step))
            b = rng.standard_normal(a.n_rows)
            x, info = PS.cg_solve(a_s, b, rt, tol=1e-10, precond="cholesky")
            assert info["converged"]
            resid = np.linalg.norm(a_s.to_dense() @ x - b) / np.linalg.norm(b)
            assert resid < 1e-8
        per_op = rt.cache_stats()["per_op"]
        assert per_op["spmv"]["misses"] == 1 and per_op["spmv"]["hits"] > 0
        assert (per_op["cholesky"]["misses"], per_op["cholesky"]["hits"]) \
            == (1, 2)

    def test_private_runtime_on_requested_device(self, monkeypatch):
        a = _spd(P, n=120, seed=5)
        b = np.ones(120)
        x, info = PS.cg_solve(a, b, device=CPU, tol=1e-10)
        assert info["converged"] and info["spmv_cache_hits"] == \
            info["iterations"] - 1
        np.testing.assert_allclose(a.to_dense() @ x, b, atol=1e-8)
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PS.cg_solve(a, b)
        with pytest.raises(ValueError, match="preconditioner"):
            PS.cg_solve(a, b, device=CPU, precond="ilu")

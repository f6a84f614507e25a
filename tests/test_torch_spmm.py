"""Port parity, SpMM: ``repro_torch.kernels.bsr_spmm`` on the CPU against
``repro.kernels.bsr_spmm`` — plans and schedules bit-identical, equal
fingerprints and byte-equal payloads over the five pattern families; kernel
K2's plain version against the reference Pallas kernel (interpret mode) and
its jnp executor at ``TestBsrSpmm``'s tolerance (rtol = atol = 1e-4 in
float32), float64 through the plain executor; the K2 schedule's memoized
device copy of its ids; the ``spmm`` op through
``ReapRuntime(device="cpu")``."""
import numpy as np
import pytest
import torch
from _torch_parity import FAMILIES, assert_same_fields, family_csr, revalue

import jax.numpy as jnp

import repro.core as R
import repro.kernels.bsr_spmm as RK
import repro.runtime as RR
import repro_torch.core as P
import repro_torch.kernels.bsr_spmm as PK
import repro_torch.runtime as PR
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops as kops

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)


def _w(pkg, family, seed=11, n=200, m=150):
    return family_csr(pkg, family, n, m, 0.05, seed)


def _x(t, n, seed=5, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((t, n)).astype(dtype)


class TestPlanParity:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("block", [16, 32])
    def test_plan_fields_digest_payload(self, family, block):
        w_p, w_r = _w(P, family), _w(R, family)
        fp_p = P.fingerprint_pattern("spmm", (w_p,), block=block)
        fp_r = R.fingerprint_pattern("spmm", (w_r,), block=block)
        assert fp_p.digest == fp_r.digest and fp_p.params == fp_r.params
        plan_p = PK.inspect_spmm(w_p, block, fp_p)
        plan_r = RK.inspect_spmm(w_r, block, fp_r)
        assert_same_fields(plan_p, plan_r)
        for key, arr in plan_r.schedule.arrays.items():
            assert np.array_equal(plan_p.schedule.arrays[key], arr), key
        pay_p, pay_r = PR.serialize_plan(plan_p), RR.serialize_plan(plan_r)
        assert sorted(pay_p) == sorted(pay_r)
        for key in pay_r:
            assert np.asarray(pay_p[key]).tobytes() == \
                np.asarray(pay_r[key]).tobytes(), key
        back = PR.deserialize_plan(pay_r)
        assert isinstance(back, PK.SpmmPlan)
        assert_same_fields(back, plan_p)

    @pytest.mark.parametrize("keep", [0.25, 0.5, 1.0])
    @pytest.mark.parametrize("block", [8, 16])
    def test_inspect_bsr_weight(self, keep, block):
        w = np.random.default_rng(int(keep * 100) + block).standard_normal(
            (64, 96)).astype(np.float32)
        blocks_p, sched_p, mask_p = PK.inspect_bsr_weight(w, block, keep)
        blocks_r, sched_r, mask_r = RK.inspect_bsr_weight(w, block, keep)
        assert np.array_equal(blocks_p, blocks_r)
        assert np.array_equal(mask_p, mask_r)
        assert sorted(sched_p) == sorted(sched_r)
        for key in sched_r:
            assert sched_p[key].dtype == sched_r[key].dtype
            assert np.array_equal(sched_p[key], sched_r[key]), key


class TestK2Plain:
    @pytest.mark.parametrize("keep", [0.25, 0.5, 1.0])
    @pytest.mark.parametrize("block", [8, 16])
    def test_vs_pallas_interpret_and_masked_dense(self, keep, block):
        rng = np.random.default_rng(int(keep * 100) + block)
        t, d_in, d_out = 64, 64, 96
        x = rng.standard_normal((t, d_in)).astype(np.float32)
        w = rng.standard_normal((d_in, d_out)).astype(np.float32)
        blocks, sched, mask = PK.inspect_bsr_weight(w, block, keep)
        before = kops.bsr_spmm.launches
        out = kops.bsr_spmm(torch.from_numpy(x), torch.from_numpy(blocks),
                            sched, n_j_blocks=d_out // block)
        assert kops.bsr_spmm.launches == before      # CPU: plain version
        assert out.dtype == torch.float32 and out.shape == (t, d_out)
        pallas = rops.bsr_spmm(jnp.asarray(x), jnp.asarray(blocks), sched,
                               n_j_blocks=d_out // block, bt=32)
        dense = rref.bsr_spmm_ref(jnp.asarray(x), jnp.asarray(w), mask,
                                  block)
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(dense), **TOL)

    def test_schedule_checks(self):
        x = torch.zeros(4, 32)
        w = torch.zeros(3, 16, 16)
        good = dict(w_id=[0, 1, 2], k_blk=[0, 1, 0], j_blk=[0, 0, 1])
        assert kops.bsr_spmm(x, w, good, n_j_blocks=2).shape == (4, 32)
        with pytest.raises(ValueError, match="sorted"):
            kops.bsr_spmm(x, w, dict(good, j_blk=[1, 0, 0]), n_j_blocks=2)
        with pytest.raises(ValueError, match="every output block-column"):
            kops.bsr_spmm(x, w, good, n_j_blocks=3)
        with pytest.raises(ValueError, match="past"):
            kops.bsr_spmm(x, w, dict(good, w_id=[0, 1, 3]), n_j_blocks=2)
        with pytest.raises(ValueError, match="past"):
            kops.bsr_spmm(x, w, dict(good, k_blk=[0, 2, 0]), n_j_blocks=2)

    def test_schedule_keeps_one_device_copy_of_its_ids(self):
        plan = PK.inspect_spmm(_w(P, "banded"), 32)
        sched = PK._k2_schedule(plan)
        assert PK._k2_schedule(plan) is sched     # memoized on the plan
        before = PK.bsr_spmm.uploads
        ids = sched.device_ids(torch.device(CPU))
        assert PK.bsr_spmm.uploads == before + 1
        assert sched.device_ids(torch.device(CPU)) is ids
        assert PK.bsr_spmm.uploads == before + 1
        assert np.array_equal(ids.numpy(), sched.ids)
        # memoized outside the dataclass fields
        assert "_device_ids" not in {f.name for f in
                                     PK.dataclasses.fields(sched)}


class TestSpmmExecute:
    @pytest.mark.parametrize("t", [1, 5, 33, 64])
    @pytest.mark.parametrize("family", ["banded", "blockdiag", "empty_rows"])
    def test_f32_vs_reference(self, t, family):
        w_p, w_r = _w(P, family), _w(R, family)
        x = _x(t, w_p.n_rows)
        plan_p = PK.inspect_spmm(w_p, 16)
        plan_r = RK.inspect_spmm(w_r, 16)
        got = PK.spmm_execute(plan_p, x, w_p.data, device=CPU)
        plain = PK.spmm_execute(plan_p, x, w_p.data, use_kernel=False,
                                device=CPU)
        assert got.dtype == np.float32 and got.shape == (t, w_p.n_cols)
        np.testing.assert_array_equal(got, plain)
        for use_pallas in (True, False):
            want = RK.spmm_execute(plan_r, x, w_r.data,
                                   use_pallas=use_pallas)
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, RK.spmm_ref_numpy(x, w_r), **TOL)

    @pytest.mark.parametrize("t", [1, 7])
    def test_f64_plain_executor_vs_reference(self, t):
        w_p, w_r = _w(P, "powerlaw"), _w(R, "powerlaw")
        x = _x(t, w_p.n_rows, dtype=np.float64)
        got = PK.spmm_execute(PK.inspect_spmm(w_p, 32), x, w_p.data,
                              dtype=np.float64, device=CPU)
        want = RK.spmm_execute(RK.inspect_spmm(w_r, 32), x, w_r.data,
                               dtype=np.float64)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

    def test_coverage_jobs_zero_pruned_columns(self):
        w = P.CSR(64, 96, np.arange(0, 65, 1, dtype=np.int64),
                  np.zeros(64, dtype=np.int64), np.ones(64, dtype=np.float32))
        x = _x(16, 64, seed=1)
        y = PK.spmm_execute(PK.inspect_spmm(w, 32), x, w.data, device=CPU)
        np.testing.assert_allclose(y, PK.spmm_ref_numpy(x, w), **TOL)
        assert np.all(y[:, 32:] == 0)


class TestSpmmOp:
    def test_runtime_cold_warm_vs_reference(self):
        w_p, w_r = _w(P, "blockdiag", n=192, m=160), _w(R, "blockdiag",
                                                       n=192, m=160)
        x = _x(40, 192)
        rt_p = PR.ReapRuntime(block=32, device=CPU)
        rt_r = RR.ReapRuntime(block=32, use_pallas=False)
        y_p, s_p = rt_p.run("spmm", x, w_p)
        y_r, s_r = rt_r.run("spmm", x, w_r)
        assert not s_p["cache_hit"] and s_p["method"] == "spmm"
        assert s_p["fingerprint"] == s_r["fingerprint"]
        assert sorted(s_p) == sorted(s_r)
        np.testing.assert_allclose(y_p, y_r, **TOL)
        w2 = revalue(P, w_p, 3)
        y2, s2 = rt_p.run("spmm", x, w2)
        assert s2["cache_hit"]
        np.testing.assert_allclose(y2, PK.spmm_ref_numpy(x, w2), **TOL)
        y3, s3 = rt_p.run("spmm", x, w_p)
        assert s3["cache_hit"]
        np.testing.assert_array_equal(y3, y_p)
        per_op = rt_p.cache_stats()["per_op"]["spmm"]
        assert (per_op["misses"], per_op["hits"]) == (1, 2)

    def test_dtype_keyword_and_capabilities(self):
        w = _w(P, "banded")
        x = _x(3, w.n_rows, dtype=np.float64)
        y, _ = PR.ReapRuntime(block=16, device=CPU).run("spmm", x, w,
                                                        dtype=np.float64)
        assert y.dtype == np.float64
        np.testing.assert_allclose(y, x @ w.to_dense().astype(np.float64),
                                   rtol=1e-12, atol=1e-12)
        spec = PR.get_op("spmm")
        cap = PR.ops.capability_summary(spec)
        ref_cap = RR.ops.capability_summary(RR.get_op("spmm"))
        assert cap["dtypes"] == ref_cap["dtypes"]
        assert cap["routing"] == ref_cap["routing"]
        # the shard hook comes with sharding: flag and hook agree
        assert cap["shardable"] is False and spec.shard_plan is None

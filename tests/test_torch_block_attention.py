"""Port parity, block-sparse attention: ``repro_torch.kernels.flash_attention``
on the CPU against ``repro.kernels.flash_attention`` — ``BlockAttentionPlan``
bit-identical with equal fingerprints and byte-equal payloads over the five
pattern families; kernel K3's plain version and ``block_attention_execute``
against the reference Pallas kernel (interpret mode), its jnp executor and
its dense float64 oracle at ``TestBlockAttention``'s cases and tolerance
(rtol = atol = 1e-4): S = 200 and 256, block 64, GQA 4/2, softcap 5 with
scale 0.2, masked-out rows exactly 0; bfloat16 against a float32 oracle at
2e-2; the ``block_attention`` op through ``ReapRuntime(device="cpu")``."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import FAMILIES, assert_same_fields, family_csr

import jax.numpy as jnp

import repro.core as R
import repro.kernels.flash_attention as RF
import repro.runtime as RR
import repro_torch.core as P
import repro_torch.kernels.flash_attention as PF
import repro_torch.runtime as PR
from repro_torch.kernels import ops as kops

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)


def _problem(pkg, s=200, h=4, hkv=2, d=32, seed=1, rows_hi=None):
    """``TestBlockAttention._problem`` of the reference, built by ``pkg``."""
    rng = np.random.default_rng(seed)
    rows_hi = s if rows_hi is None else rows_hi
    row = rng.integers(0, rows_hi, 6 * s)
    col = rng.integers(0, s, 6 * s)
    mask = pkg.CSR.from_coo(pkg.COO(s, s, row, col,
                                    np.ones(row.size, np.float32)))
    q = rng.standard_normal((2, h, s, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, d)).astype(np.float32)
    return mask, q, k, v


class TestPlanParity:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("block", [32, 64])
    def test_plan_fields_digest_payload(self, family, block):
        m_p = family_csr(P, family, 256, 256, 0.03, 17)
        m_r = family_csr(R, family, 256, 256, 0.03, 17)
        fp_p = P.fingerprint_pattern("block_attention", (m_p,), block=block)
        fp_r = R.fingerprint_pattern("block_attention", (m_r,), block=block)
        assert fp_p.digest == fp_r.digest and fp_p.params == fp_r.params
        plan_p = PF.inspect_block_attention(m_p, block, fp_p)
        plan_r = RF.inspect_block_attention(m_r, block, fp_r)
        assert_same_fields(plan_p, plan_r)
        pay_p, pay_r = PR.serialize_plan(plan_p), RR.serialize_plan(plan_r)
        assert sorted(pay_p) == sorted(pay_r)
        for key in pay_r:
            assert np.asarray(pay_p[key]).tobytes() == \
                np.asarray(pay_r[key]).tobytes(), key
        assert_same_fields(PR.deserialize_plan(pay_r), plan_p)

    def test_rejects_non_square_mask(self):
        m = P.random_csr(64, 96, 0.1, np.random.default_rng(0))
        with pytest.raises(ValueError, match="square"):
            PF.inspect_block_attention(m, 32)


class TestExecute:
    @pytest.mark.parametrize("use_kernel", [True, False])
    @pytest.mark.parametrize("s", [256, 200])
    def test_vs_reference(self, use_kernel, s):
        m_p, q, k, v = _problem(P, s=s)
        m_r = _problem(R, s=s)[0]
        plan_p = PF.inspect_block_attention(m_p, 64)
        plan_r = RF.inspect_block_attention(m_r, 64)
        before = kops.block_sparse_attention.launches
        out = PF.block_attention_execute(plan_p, q, k, v,
                                         use_kernel=use_kernel, device=CPU)
        assert kops.block_sparse_attention.launches == before
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        assert out.shape == q.shape
        for use_pallas in (True, False):
            want = RF.block_attention_execute(plan_r, q, k, v,
                                              use_pallas=use_pallas)
            np.testing.assert_allclose(out, want, **TOL)
        ref = RF.block_attention_ref(q, k, v, m_r, 64)
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_array_equal(
            PF.block_attention_ref(q, k, v, m_p, 64), ref)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_masked_out_rows_and_softcap(self, use_kernel):
        m_p, q, k, v = _problem(P, s=200, rows_hi=128)
        m_r = _problem(R, s=200, rows_hi=128)[0]
        plan = PF.inspect_block_attention(m_p, 64)
        assert plan.n_kv[2:].max(initial=0) == 0
        out = PF.block_attention_execute(plan, q, k, v,
                                         use_kernel=use_kernel, softcap=5.0,
                                         scale=0.2, device=CPU)
        want = RF.block_attention_execute(
            RF.inspect_block_attention(m_r, 64), q, k, v, use_pallas=True,
            softcap=5.0, scale=0.2)
        np.testing.assert_allclose(out, want, **TOL)
        ref = RF.block_attention_ref(q, k, v, m_r, 64, softcap=5.0,
                                     scale=0.2)
        np.testing.assert_allclose(out, ref, **TOL)
        assert np.abs(out[:, :, 128:]).max() == 0.0

    def test_k3_plain_vs_pallas_kernel(self):
        """The kernel-level entry on padded inputs, GQA and a softcap."""
        m_p, q, k, v = _problem(P, s=256, h=4, hkv=1, seed=2)
        plan = PF.inspect_block_attention(m_p, 64)
        got = kops.block_sparse_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            plan.kv_ids, plan.n_kv, softcap=3.0, seq=250)
        want = RF.block_sparse_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(plan.kv_ids), jnp.asarray(plan.n_kv), softcap=3.0,
            seq=250, interpret=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_bf16_tensors_in_tensor_out(self):
        m_p, q, k, v = _problem(P, s=256, seed=3)
        plan = PF.inspect_block_attention(m_p, 64)
        qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v))
        out = PF.block_attention_execute(plan, qb, kb, vb, device=CPU)
        assert torch.is_tensor(out) and out.dtype == torch.bfloat16
        oracle = PF.block_attention_execute(
            plan, *(x.float() for x in (qb, kb, vb)), device=CPU)
        torch.testing.assert_close(out.float(), oracle, rtol=2e-2, atol=2e-2)

    def test_wrapper_checks(self):
        q = torch.zeros(1, 2, 64, 32)
        kv = torch.zeros(1, 2, 64, 32)
        ids, n = np.zeros((2, 2), np.int32), np.array([1, 1], np.int32)
        kops.block_sparse_attention(q, kv, kv, ids, n)
        with pytest.raises(ValueError, match="out of range"):
            kops.block_sparse_attention(q, kv, kv, ids + 2, n)
        with pytest.raises(ValueError, match="out of range"):
            kops.block_sparse_attention(q, kv, kv, ids, n + 2)
        with pytest.raises(ValueError, match="incompatible"):
            kops.block_sparse_attention(q, torch.zeros(1, 3, 64, 32),
                                        torch.zeros(1, 3, 64, 32), ids, n)


class TestPlanSchedule:
    """K3's plan route: a range-checked device copy of ``kv_ids | n_kv``
    memoized on the plan, outside its dataclass fields."""

    def test_memoized_outside_fields(self):
        m_p = family_csr(P, "banded", 256, 256, 0.03, 21)
        m_r = family_csr(R, "banded", 256, 256, 0.03, 21)
        plan_p = PF.inspect_block_attention(m_p, 32)
        plan_r = RF.inspect_block_attention(m_r, 32)
        payload = PR.serialize_plan(plan_p)
        before = kops.block_sparse_attention.uploads
        sched = PF.plan_schedule(plan_p, torch.device(CPU))
        assert kops.block_sparse_attention.uploads == before + 1
        assert PF.plan_schedule(plan_p, torch.device(CPU)) is sched
        assert kops.block_sparse_attention.uploads == before + 1
        np.testing.assert_array_equal(
            sched.numpy(), np.concatenate([plan_p.kv_ids.reshape(-1),
                                           plan_p.n_kv]))
        assert_same_fields(plan_p, plan_r)       # fields: the reference's
        after = PR.serialize_plan(plan_p)
        assert sorted(after) == sorted(payload) == \
            sorted(RR.serialize_plan(plan_r))
        for key in payload:
            assert np.asarray(after[key]).tobytes() == \
                np.asarray(payload[key]).tobytes() == \
                np.asarray(RR.serialize_plan(plan_r)[key]).tobytes(), key

    def test_plan_route_vs_array_route_and_warm_op(self):
        m_p, q, k, v = _problem(P, s=256)
        plan = PF.inspect_block_attention(m_p, 64)
        q, k, v = (torch.from_numpy(x) for x in (q, k, v))
        got = PF.block_sparse_attention_plan(q, k, v, plan, softcap=5.0)
        want = kops.block_sparse_attention(q, k, v, plan.kv_ids, plan.n_kv,
                                           softcap=5.0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        with pytest.raises(ValueError, match="rows"):
            PF.block_sparse_attention_plan(q[:, :, :192], k[:, :, :192],
                                           v[:, :, :192], plan)
        rt = PR.ReapRuntime(n_chunks=1, overlap=False, block=64, device=CPU)
        rt.run("block_attention", q, k, v, m_p)
        before = kops.block_sparse_attention.uploads
        for _ in range(3):
            rt.run("block_attention", q, k, v, m_p)
        assert kops.block_sparse_attention.uploads == before

    def test_plan_schedule_checks_ranges(self):
        m_p = _problem(P, s=256)[0]
        plan = PF.inspect_block_attention(m_p, 64)
        bad = PF.BlockAttentionPlan(**{
            f.name: getattr(plan, f.name)
            for f in dataclasses.fields(plan)})
        bad.kv_ids = plan.kv_ids + plan.n_q_blocks
        with pytest.raises(ValueError, match="out of range"):
            PF.plan_schedule(bad, torch.device(CPU))


class TestBlockAttentionOp:
    def test_runtime_cold_warm_vs_reference(self):
        m_p, q, k, v = _problem(P, s=256)
        m_r = _problem(R, s=256)[0]
        rt = PR.ReapRuntime(n_chunks=1, overlap=False, block=64, device=CPU)
        o1, s1 = rt.run("block_attention", q, k, v, m_p)
        o2, s2 = rt.run("block_attention", q, k, v, m_p)
        assert not s1["cache_hit"] and s2["cache_hit"]
        np.testing.assert_array_equal(o1, o2)
        o_r, s_r = RR.ReapRuntime(n_chunks=1, overlap=False, use_pallas=False,
                                  block=64).run("block_attention", q, k, v,
                                                m_r)
        assert s1["fingerprint"] == s_r["fingerprint"]
        assert sorted(s1) == sorted(s_r)
        assert s1["flops"] == s_r["flops"]
        np.testing.assert_allclose(o1, o_r, **TOL)
        o3, s3 = rt.run("block_attention", q, k, v, m_p, softcap=5.0,
                        scale=0.2)
        assert s3["cache_hit"]
        np.testing.assert_allclose(
            o3, RF.block_attention_ref(q, k, v, m_r, 64, softcap=5.0,
                                       scale=0.2), **TOL)
        with pytest.raises(TypeError, match="unexpected keyword"):
            rt.run("block_attention", q, k, v, m_p, window=4)

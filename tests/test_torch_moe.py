"""Port parity, MoE dispatch: ``repro_torch.core.routing`` (numpy and torch
branches), ``routing_csr`` / ``MoeDispatchPlan`` / the ``moe_dispatch`` op,
``host_route``, kernel K5's plain version (``repro_torch.kernels.ops.moe_gemm``)
and the host-routed expert FFN ``moe_ffn_host``, each against ``repro``
on the same inputs made with numpy from a seed.  The reference's Pallas
``moe_gemm`` runs in interpret mode, as its own tests run it on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_same_fields

import repro.core as R
import repro.core.routing as RRT
import repro.runtime as RR
from repro.kernels import ops as rops
from repro.models import moe as rmoe
import repro_torch.core as P
import repro_torch.core.routing as PRT
import repro_torch.runtime as PR
from repro_torch.kernels import ops as pops
from repro_torch.models import moe as pmoe

CPU = "cpu"
T, D, E, K = 48, 12, 6, 2


def _routing(seed, t=T, d=D, e=E, k=K):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((t, d)).astype(np.float32)
    router_w = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    expert_ids, gates = RRT.top_k_experts(
        RRT.softmax_probs(tokens @ router_w), k)
    return tokens, router_w, expert_ids.astype(np.int64), gates


def _tied_probs(seed, t=40, e=8):
    """Probabilities with many exact ties (quantized to 1/8)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 4, size=(t, e)).astype(np.float32) / 8 + 0.125
    return raw / raw.sum(axis=-1, keepdims=True)


def assert_payloads_equal(p, r):
    assert sorted(p) == sorted(r)
    for key in r:
        u, v = np.asarray(p[key]), np.asarray(r[key])
        assert u.dtype == v.dtype and u.shape == v.shape, key
        assert u.tobytes() == v.tobytes(), key


# ---------------------------------------------------------------------------
# core.routing: torch branch against numpy, numpy against the reference
# ---------------------------------------------------------------------------

class TestRouting:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("tied", [False, True])
    @pytest.mark.parametrize("top_k", [1, 2, 4])
    def test_top_k_torch_matches_numpy_and_reference(self, seed, tied,
                                                     top_k):
        probs = _tied_probs(seed) if tied else PRT.softmax_probs(
            np.random.default_rng(seed).standard_normal((40, 8))
            .astype(np.float32))
        e_np, g_np = PRT.top_k_experts(probs, top_k, xp=np)
        e_t, g_t = PRT.top_k_experts(torch.from_numpy(probs), top_k,
                                     xp=torch)
        e_r, g_r = RRT.top_k_experts(probs, top_k, xp=np)
        np.testing.assert_array_equal(e_np, e_r)
        np.testing.assert_array_equal(g_np, g_r)
        assert e_t.numpy().tobytes() == e_np.astype(np.int64).tobytes()
        np.testing.assert_allclose(g_t.numpy(), g_np, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_softmax_torch_close_to_numpy(self, seed):
        logits = np.random.default_rng(seed).standard_normal(
            (33, 16)).astype(np.float32) * 4
        np.testing.assert_array_equal(PRT.softmax_probs(logits),
                                      RRT.softmax_probs(logits))
        np.testing.assert_allclose(
            PRT.softmax_probs(torch.from_numpy(logits), xp=torch).numpy(),
            PRT.softmax_probs(logits), rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("n,e,cap", [(96, 6, 16), (96, 6, 8),
                                         (200, 16, 24), (64, 4, 64),
                                         (0, 4, 8)])
    def test_assignment_bit_exact(self, n, e, cap):
        e_flat = np.random.default_rng(n + e).integers(0, e, n) \
            .astype(np.int64)
        want = RRT.expert_assignment(e_flat, cap, e, xp=np)
        got_np = PRT.expert_assignment(e_flat, cap, e, xp=np)
        got_t = PRT.expert_assignment(torch.from_numpy(e_flat), cap, e,
                                      xp=torch)
        for u, v, w in zip(want, got_np, got_t):
            assert u.tobytes() == v.tobytes()
            assert np.asarray(u).astype(w.numpy().dtype).tobytes() == \
                w.numpy().tobytes()
        vals = np.arange(n, dtype=np.int64)
        slots_r = RRT.scatter_to_slots(want[2], vals, e * cap, fill=n)
        assert PRT.scatter_to_slots(want[2], vals, e * cap, fill=n) \
            .tobytes() == slots_r.tobytes()
        slots_t = PRT.scatter_to_slots(got_t[2], torch.from_numpy(vals),
                                       e * cap, fill=n, xp=torch)
        assert slots_t.numpy().tobytes() == slots_r.tobytes()


# ---------------------------------------------------------------------------
# Dispatch plans, digests and payloads against the reference
# ---------------------------------------------------------------------------

CASES = [(0, 16), (1, 8), (2, 4), (3, 64)]      # (seed, capacity)


class TestDispatchPlanParity:
    @pytest.mark.parametrize("seed,cap", CASES)
    def test_plan_digest_and_payload_bit_identical(self, seed, cap):
        _, _, ids, _ = _routing(seed)
        rc_r, rc_p = R.routing_csr(ids, E), P.routing_csr(ids, E)
        assert_same_fields(rc_p, rc_r, "routing")
        fp_r = R.fingerprint_pattern("moe_dispatch", (rc_r,), capacity=cap)
        fp_p = P.fingerprint_pattern("moe_dispatch", (rc_p,), capacity=cap)
        assert (fp_p.op, fp_p.shapes, fp_p.nnz, fp_p.digest, fp_p.params) \
            == (fp_r.op, fp_r.shapes, fp_r.nnz, fp_r.digest, fp_r.params)
        plan_r = R.inspect_moe_dispatch(rc_r, cap)
        plan_p = P.inspect_moe_dispatch(rc_p, cap)
        assert_same_fields(plan_p, plan_r)
        assert plan_p.dropped_frac == plan_r.dropped_frac
        np.testing.assert_array_equal(plan_p.keep, plan_r.keep)
        for key in ("slot_token", "bundle_expert"):
            assert plan_p.schedule[key].tobytes() == \
                plan_r.schedule[key].tobytes()
        pay_p, pay_r = PR.serialize_plan(plan_p), RR.serialize_plan(plan_r)
        assert_payloads_equal(pay_p, pay_r)
        assert_same_fields(PR.deserialize_plan(pay_r), plan_r)
        assert_same_fields(RR.deserialize_plan(pay_p), plan_p)

    def test_schedule_is_one_bundle_per_plan(self):
        # K5 keeps the expert map's device copy on the schedule bundle, so
        # every read of a plan's schedule must give the same object; the
        # memo stays out of the plan's payload
        _, _, ids, _ = _routing(3)
        plan = P.inspect_moe_dispatch(P.routing_csr(ids, E), 6)
        payload = PR.serialize_plan(plan)
        sched = plan.schedule
        assert plan.schedule is sched
        assert_payloads_equal(PR.serialize_plan(plan), payload)
        restored = PR.deserialize_plan(payload)
        assert restored.schedule is not sched
        for key in ("slot_token", "bundle_expert"):
            np.testing.assert_array_equal(restored.schedule[key], sched[key])

    def test_routing_csr_rejects_out_of_range(self):
        with pytest.raises(ValueError, match="expert ids"):
            P.routing_csr(np.array([[0, 6]]), 6)

    @pytest.mark.parametrize("seed,cap", CASES)
    def test_bundle_combine_numpy_and_tensor(self, seed, cap):
        tokens, _, ids, gates = _routing(seed)
        plan_r = R.inspect_moe_dispatch(R.routing_csr(ids, E), cap)
        plan_p = P.inspect_moe_dispatch(P.routing_csr(ids, E), cap)
        xb = plan_p.bundle(tokens)
        np.testing.assert_array_equal(xb, plan_r.bundle(tokens))
        xb_t = plan_p.bundle(torch.from_numpy(tokens))
        assert torch.is_tensor(xb_t)
        np.testing.assert_array_equal(xb_t.numpy(), xb)
        y = np.random.default_rng(seed + 50).standard_normal(
            (E, cap, 5)).astype(np.float32)
        want = plan_r.combine(y, gates)
        np.testing.assert_array_equal(plan_p.combine(y, gates), want)
        got = plan_p.combine(torch.from_numpy(y), gates)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        got = plan_p.combine(torch.from_numpy(y), torch.from_numpy(gates))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


class TestDispatchOp:
    @pytest.mark.parametrize("capacity", [None, 8, 64])
    def test_runtime_matches_reference(self, capacity):
        tokens, _, ids, _ = _routing(5)
        rt_r, rt_p = RR.ReapRuntime(), PR.ReapRuntime(device=CPU)
        xb_r, plan_r, st_r = rt_r.moe_dispatch(tokens, ids, n_experts=E,
                                               capacity=capacity)
        xb_p, plan_p, st_p = rt_p.moe_dispatch(tokens, ids, n_experts=E,
                                               capacity=capacity)
        assert isinstance(xb_p, np.ndarray)
        np.testing.assert_array_equal(xb_p, xb_r)
        assert_same_fields(plan_p, plan_r)
        assert st_p["fingerprint"] == st_r["fingerprint"]
        assert sorted(st_p) == sorted(st_r)
        assert st_p["dropped"] == st_r["dropped"]
        # same routing, fresh values: a hit on the same plan object
        xb2, plan2, st2 = rt_p.moe_dispatch(torch.from_numpy(tokens * 1.7),
                                            torch.from_numpy(ids),
                                            n_experts=E, capacity=capacity)
        assert st2["cache_hit"] and plan2 is plan_p
        assert torch.is_tensor(xb2) and xb2.device.type == "cpu"
        np.testing.assert_allclose(xb2.numpy(), xb_r * 1.7, rtol=1e-6)

    def test_capacity_factor_from_config(self):
        tokens, _, ids, _ = _routing(6)
        rt = PR.ReapRuntime(device=CPU, moe_capacity_factor=2.0)
        _, plan, _ = rt.moe_dispatch(tokens, ids, n_experts=E)
        assert plan.capacity == pmoe.expert_capacity(T, E, K, 2.0) == \
            rmoe.expert_capacity(T, E, K, 2.0)

    @pytest.mark.parametrize("args", [(4096, 16, 4, 1.25), (64, 16, 4, 1.25),
                                      (7, 3, 2, 1.0), (1000, 8, 2, 0.5)])
    def test_expert_capacity(self, args):
        assert pmoe.expert_capacity(*args) == rmoe.expert_capacity(*args)


# ---------------------------------------------------------------------------
# host_route, K5's plain version, moe_ffn_host
# ---------------------------------------------------------------------------

class TestHostRoute:
    @pytest.mark.parametrize("seed,top_k", [(0, 1), (1, 2), (2, 4)])
    def test_expert_ids_equal_reference(self, seed, top_k):
        rng = np.random.default_rng(seed)
        tokens = rng.standard_normal((64, 32)).astype(np.float32)
        router = (rng.standard_normal((32, 8)) * 0.1).astype(np.float32)
        e_r, g_r = rmoe.host_route(tokens, router, top_k=top_k)
        for tok in (tokens, torch.from_numpy(tokens)):
            e_p, g_p = pmoe.host_route(tok, torch.from_numpy(router),
                                       top_k=top_k)
            assert e_p.dtype == e_r.dtype and g_p.dtype == g_r.dtype
            np.testing.assert_array_equal(e_p, e_r)
            np.testing.assert_allclose(g_p, g_r, rtol=1e-6, atol=1e-7)


MOE_GEMM_SHAPES = [(4, 8, 32, 64, 3), (7, 16, 128, 128, 8),
                   (2, 128, 256, 512, 2)]


class TestMoeGemm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("nb,cap,din,dout,e", MOE_GEMM_SHAPES)
    def test_plain_matches_reference_interpret(self, dtype, nb, cap, din,
                                               dout, e):
        rng = np.random.default_rng(nb)
        x = rng.standard_normal((nb, cap, din)).astype(np.float32)
        w = rng.standard_normal((e, din, dout)).astype(np.float32)
        be = rng.integers(0, e, nb).astype(np.int32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = rops.moe_gemm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(be), bk=min(128, din),
                             bf=min(128, dout))
        got = pops.moe_gemm(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w).to(tdt), be,
                            bk=min(128, din), bf=min(128, dout))
        assert got.dtype == tdt and tuple(got.shape) == (nb, cap, dout)
        # the kernel tiles K: another accumulation order than the einsum
        tol = 1e-3 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)

    def test_schedule_entry_matches_reference(self):
        tokens, _, ids, _ = _routing(10)
        cap = pmoe.expert_capacity(T, E, K, 1.25)
        plan = P.inspect_moe_dispatch(P.routing_csr(ids, E), cap)
        xb = plan.bundle(tokens)
        w = (np.random.default_rng(11).standard_normal((E, D, D))
             / np.sqrt(D)).astype(np.float32)
        want = np.asarray(rops.moe_gemm_schedule(plan.schedule, xb, w,
                                                 bk=D, bf=D))
        got = pops.moe_gemm_schedule(plan.schedule, torch.from_numpy(xb),
                                     torch.from_numpy(w), bk=D, bf=D)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)

    def test_rejects_what_reference_rejects(self):
        x = torch.zeros((2, 8, 48))
        w = torch.zeros((3, 48, 64))
        with pytest.raises(AssertionError):          # 48 % 32 != 0
            pops.moe_gemm(x, w, np.array([0, 1]), bk=32)
        with pytest.raises(AssertionError):
            rops.moe_gemm(jnp.zeros((2, 8, 48)), jnp.zeros((3, 48, 64)),
                          jnp.array([0, 1], jnp.int32), bk=32)
        with pytest.raises(ValueError, match="dtypes differ"):
            pops.moe_gemm(x, w.to(torch.bfloat16), np.array([0, 1]))
        with pytest.raises(ValueError, match="bundle_expert"):
            pops.moe_gemm(x, w, np.array([0, 3]))
        with pytest.raises(ValueError, match="bundle_expert"):
            pops.moe_gemm(x, w, np.array([0]))
        assert pops.moe_gemm.launches == 0


def _moe_inputs(seed, shared):
    b, s, d, e, k, dff = 2, 16, 32, 4, 2, 48
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = dict(router=(rng.standard_normal((d, e)) * 0.1).astype(np.float32),
             w_gate=(rng.standard_normal((e, d, dff)) / np.sqrt(d))
             .astype(np.float32),
             w_up=(rng.standard_normal((e, d, dff)) / np.sqrt(d))
             .astype(np.float32),
             w_down=(rng.standard_normal((e, dff, d)) / np.sqrt(dff))
             .astype(np.float32))
    if shared:
        sdff = 40
        p.update(shared_gate=(rng.standard_normal((d, sdff)) / np.sqrt(d))
                 .astype(np.float32),
                 shared_up=(rng.standard_normal((d, sdff)) / np.sqrt(d))
                 .astype(np.float32),
                 shared_down=(rng.standard_normal((sdff, d)) / np.sqrt(sdff))
                 .astype(np.float32))
    return x, p, dict(n_experts=e, top_k=k)


class TestMoeFfnHost:
    @pytest.mark.parametrize("shared", [False, True])
    @pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
    def test_matches_reference(self, shared, capacity_factor):
        x, p, kw = _moe_inputs(7, shared)
        kw = dict(kw, capacity_factor=capacity_factor)
        rt_r = RR.ReapRuntime()
        rmoe.set_host_dispatch_runtime(rt_r)
        try:
            want, _ = rmoe._moe_ffn_host(jnp.asarray(x), {
                k: jnp.asarray(v) for k, v in p.items()}, **kw)
        finally:
            rmoe.set_host_dispatch_runtime(None)
        rt = PR.ReapRuntime(device=CPU)
        pt = pmoe.moe_params_from_numpy(p, CPU)
        assert sorted(pt) == sorted(p)
        got, aux = pmoe.moe_ffn_host(torch.from_numpy(x), pt, rt, **kw)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        # second call: a warm moe_dispatch hit, bit-equal output
        again, _ = pmoe.moe_ffn_host(torch.from_numpy(x), pt, rt, **kw)
        assert torch.equal(got, again)
        per = rt.cache_stats()["per_op"]["moe_dispatch"]
        assert (per["misses"], per["hits"]) == (1, 1)

    def test_params_default_to_cuda_and_raise_without_card(
            self, monkeypatch):
        _, p, _ = _moe_inputs(10, True)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmoe.moe_params_from_numpy(p)
        pt = pmoe.moe_params_from_numpy(p, CPU, torch.bfloat16)
        assert sorted(pt) == sorted(p)
        assert all(v.device.type == CPU and v.dtype == torch.bfloat16
                   for v in pt.values())

    def test_expert_swiglu_matches_reference(self):
        x, p, kw = _moe_inputs(8, False)
        xb = np.random.default_rng(9).standard_normal(
            (kw["n_experts"], 24, 32)).astype(np.float32)
        want = rmoe.expert_swiglu(jnp.asarray(xb), *(
            jnp.asarray(p[k]) for k in ("w_gate", "w_up", "w_down")))
        pt = pmoe.moe_params_from_numpy(p, CPU)
        got = pmoe.expert_swiglu(torch.from_numpy(xb), pt["w_gate"],
                                 pt["w_up"], pt["w_down"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)

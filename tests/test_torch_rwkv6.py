"""Port parity, RWKV6 (kernel K6): ``repro_torch`` on the CPU against
``repro``.

* K6's plain version (``kernels.ops.rwkv6`` on CPU tensors): its ``o``
  against the reference's Pallas ``rwkv6`` in interpret mode and against
  the per-step oracle ``rwkv6_ref``, over the ``TestRwkv6`` cases of
  ``tests/test_kernels.py`` at their tolerances (2e-4; chunk invariance
  1e-4 / 1e-5; extreme decay 1e-4);
* ``(o, state)`` against ``rwkv6_chunked_jnp`` (through the model-level
  ``models.ssm.rwkv6_chunked``), and the decode step against
  ``rwkv6_decode_step``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.models.ssm as RS
import repro_torch.kernels.rwkv6_scan as PK
import repro_torch.models.ssm as PS
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops as pops


def _inputs(seed, b, h, t, kk, vv, *, spread=4.0, w_val=None, lo=1e-4):
    """r, k, v, w, u as float32 numpy arrays; w = sigmoid(spread·N) clipped
    to [lo, 1 - lo] (the reference's decay range), or constant ``w_val``."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, kk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, t, vv)).astype(np.float32)
    if w_val is None:
        z = spread * rng.standard_normal((b, h, t, kk))
        w = np.clip(1 / (1 + np.exp(-z)), lo, 1 - lo).astype(np.float32)
    else:
        w = np.full((b, h, t, kk), w_val, np.float32)
    u = rng.standard_normal((h, kk)).astype(np.float32)
    return r, k, v, w, u


def _port(args, chunk):
    return pops.rwkv6(*map(torch.from_numpy, args), chunk=chunk)


class TestK6PlainMatchesReference:
    @pytest.mark.parametrize("t,chunk", [(64, 16), (128, 32), (96, 32)])
    def test_vs_pallas_and_naive_scan(self, t, chunk):
        args = _inputs(t, 2, 3, t, 16, 24)
        o, state = _port(args, chunk)
        assert o.dtype == state.dtype == torch.float32
        assert tuple(state.shape) == (2, 3, 16, 24)
        np.testing.assert_allclose(o.numpy(), np.asarray(
            rops.rwkv6(*args, chunk=chunk)), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(
            rref.rwkv6_ref(*args)), rtol=2e-4, atol=2e-4)

    def test_chunk_size_invariance(self):
        args = _inputs(9, 1, 2, 64, 8, 8, spread=1.0)
        (o16, s16), (o32, s32), (o64, s64) = (_port(args, c)
                                              for c in (16, 32, 64))
        for a, b in ((o16, o32), (o32, o64), (s16, s32), (s32, s64)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)

    @pytest.mark.parametrize("w_val", [1e-6, 1 - 1e-6])
    def test_extreme_decay_stable(self, w_val):
        args = _inputs(11, 1, 1, 32, 4, 4, w_val=w_val)
        o, state = _port(args, 16)
        assert torch.isfinite(o).all() and torch.isfinite(state).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(
            rref.rwkv6_ref(*args)), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(
            rops.rwkv6(*args, chunk=16)), rtol=1e-4, atol=1e-4)

    def test_bfloat16_inputs_widened(self):
        r, k, v, w, u = _inputs(12, 1, 2, 64, 16, 32)
        rb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (r, k, v))
        o, _ = pops.rwkv6(rb, kb, vb, torch.from_numpy(w),
                          torch.from_numpy(u), chunk=32)
        want = rops.rwkv6(*(jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)),
                          w, u, chunk=32)
        np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)

    def test_rejects_what_reference_rejects(self):
        args = _inputs(13, 1, 1, 48, 4, 4)
        with pytest.raises(ValueError, match="multiple"):
            _port(args, 32)                       # 48 % 32 != 0
        with pytest.raises(AssertionError):
            rops.rwkv6(*args, chunk=32)
        with pytest.raises(ValueError, match="incompatible"):
            pops.rwkv6(*map(torch.from_numpy, args[:4]), torch.zeros(2, 4))


class TestModelSsm:
    @pytest.mark.parametrize("t,u_zero", [(64, True), (128, False),
                                          (12, True), (192, False)])
    def test_chunked_state_matches_jnp(self, t, u_zero):
        r, k, v, w, u = _inputs(20 + t, 2, 3, t, 8, 16, lo=1e-6)
        if u_zero:
            u = np.zeros_like(u)
        o, state = PS.rwkv6_chunked(*map(torch.from_numpy, (r, k, v, w, u)),
                                    chunk=min(64, t))
        o_r, s_r = RS.rwkv6_chunked_jnp(r, k, v, w, u, chunk=min(64, t))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(state.numpy(), np.asarray(s_r),
                                   rtol=2e-4, atol=2e-4)

    def test_chunk_assertion_kept(self):
        r, k, v, w, u = map(torch.from_numpy, _inputs(30, 1, 1, 96, 4, 4))
        with pytest.raises(ValueError, match="multiple"):
            PS.rwkv6_chunked(r, k, v, w, u, chunk=64)   # 96 % 64 != 0

    def test_decode_step_matches_reference(self):
        rng = np.random.default_rng(31)
        b, h, kk, vv = 3, 2, 8, 16
        r, k, w = (rng.standard_normal((b, h, kk)).astype(np.float32)
                   for _ in range(3))
        w = 1 / (1 + np.exp(-w))
        v = rng.standard_normal((b, h, vv)).astype(np.float32)
        u = rng.standard_normal((h, kk)).astype(np.float32)
        s0 = rng.standard_normal((b, h, kk, vv)).astype(np.float32)
        o, s1 = PS.rwkv6_decode_step(*map(torch.from_numpy,
                                          (r, k, v, w, u, s0)))
        o_r, s1_r = RS.rwkv6_decode_step(r, k, v, w, u, s0)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(s1.numpy(), np.asarray(s1_r), rtol=1e-5,
                                   atol=1e-5)

    def test_decode_steps_continue_the_prefill_state(self):
        # prefill T tokens, then decode 3: the same outputs as one scan
        r, k, v, w, u = _inputs(32, 1, 2, 67, 8, 8)
        o_all = np.asarray(rref.rwkv6_ref(r, k, v, w, u))
        o, state = PS.rwkv6_chunked(*(torch.from_numpy(x[:, :, :64])
                                      for x in (r, k, v, w)),
                                    torch.from_numpy(u))
        for t in range(64, 67):
            o_t, state = PS.rwkv6_decode_step(
                *(torch.from_numpy(x[:, :, t]) for x in (r, k, v, w)),
                torch.from_numpy(u), state)
            np.testing.assert_allclose(o_t.numpy(), o_all[:, :, t],
                                       rtol=2e-4, atol=2e-4)


def test_wrapper_runs_the_plain_version_on_cpu():
    args = [torch.from_numpy(x) for x in _inputs(40, 1, 2, 32, 4, 8)]
    before = PK.rwkv6.launches
    o, s = PK.rwkv6(*args, chunk=8)
    o2, s2 = PK.rwkv6_plain(*args, chunk=8)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert PK.rwkv6.launches == before

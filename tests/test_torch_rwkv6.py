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


def _chunk_parallel(r, k, v, w, u, chunk, sub=16):
    """K6's chunk-parallel algebra in plain torch, float32: (1) the
    chunk-local terms of every chunk at once (the state-free part of o,
    r·e^{ecum}, each chunk's decay and its contribution Kd^T v), (2) the
    scan of the state over the chunks, S_c = d_c ⊙ S_{c-1} + U_c, keeping
    the state that enters each chunk, (3) the inter-chunk term
    (r·e^{ecum}) S_{c-1}.  Inside the chunk, A's entries between ``sub``-token
    sub-blocks are the product of two factors, e^{ecum_t - ref} and
    e^{ref - cum_s} with ref the cum before t's sub-block (both exponents
    <= 0); inside a sub-block each takes its own exponential.  Returns
    (o, final state)."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    nc = t // chunk
    r_, k_, w_ = (x.float().reshape(b, h, nc, chunk, kk) for x in (r, k, w))
    v_ = v.float().reshape(b, h, nc, chunk, vv)
    # 1. chunk-local, all chunks in parallel; exponents <= 0
    logw = torch.log(w_)
    cum = torch.cumsum(logw, dim=3)
    ecum = cum - logw
    last = cum[:, :, :, -1:, :]
    idx = torch.arange(chunk)
    start = idx // sub * sub                           # t's sub-block start
    same = (idx[:, None] > idx[None, :]) & (start[:, None] == start[None, :])
    cross = idx[None, :] < start[:, None]              # s before t's block
    zero = torch.zeros(())
    expo = ecum[..., :, None, :] - cum[..., None, :, :]    # (.., t, s, K)
    expo = torch.where(same[:, :, None], expo, zero)
    a_same = (r_[..., :, None, :] * k_[..., None, :, :]
              * torch.exp(expo)).sum(-1)
    ref = torch.where((start > 0)[:, None],
                      cum[..., (start - 1).clamp_min(0), :], zero)
    r_f = r_ * torch.exp(ecum - ref)                   # (.., t, K)
    expo_k = ref[..., :, None, :] - cum[..., None, :, :]
    expo_k = torch.where(cross[:, :, None], expo_k, zero)
    a_cross = (r_f[..., :, None, :] * k_[..., None, :, :]
               * torch.exp(expo_k)).sum(-1)
    a = torch.where(same, a_same, torch.where(cross, a_cross, zero))
    bonus = (r_ * u.float()[None, :, None, None, :] * k_).sum(-1,
                                                              keepdim=True)
    o_local = a @ v_ + bonus * v_
    rq = r_ * torch.exp(ecum)
    decay = torch.exp(last[:, :, :, 0])                   # (B, H, NC, K)
    contrib = (k_ * torch.exp(last - cum)).transpose(-1, -2) @ v_
    # 2. the state scan: the state entering each chunk
    s = torch.zeros(b, h, kk, vv)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + contrib[:, :, c]
    # 3. the inter-chunk term
    o = o_local + rq @ torch.stack(s_in, dim=2)
    return o.reshape(b, h, t, vv), s


class TestK6ChunkParallelAlgebra:
    """The chunk-parallel split that the CUDA kernel runs, against the
    sequential plain version and the reference's Pallas kernel."""

    @pytest.mark.parametrize("t,chunk,kk,vv,w_val,u_zero", [
        (256, 64, 16, 64, None, True),       # hymba's SSM heads, 4 chunks
        (128, 32, 16, 24, None, False),      # u != 0, V of no tile's width
        (96, 32, 64, 16, None, False),       # K = 64
        # extreme decays, at test_extreme_decay_stable's shape
        (32, 16, 4, 4, 1e-6, False),
        (32, 16, 4, 4, 1 - 1e-6, False),
        (64, 64, 16, 32, None, False),       # T = C: one chunk, no carry
        (12, 64, 16, 8, None, True),         # T < chunk
    ])
    def test_matches_plain_and_pallas(self, t, chunk, kk, vv, w_val,
                                      u_zero):
        args = list(_inputs(50 + t + kk, 1, 2, t, kk, vv, w_val=w_val,
                            lo=1e-6))
        if u_zero:
            args[4] = np.zeros_like(args[4])
        c = min(chunk, t)
        o, state = _chunk_parallel(*map(torch.from_numpy, args), c)
        assert torch.isfinite(o).all() and torch.isfinite(state).all()
        o_p, s_p = PK.rwkv6_plain(*map(torch.from_numpy, args), chunk=c)
        np.testing.assert_allclose(o.numpy(), o_p.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(state.numpy(), s_p.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(
            rops.rwkv6(*args, chunk=c)), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("w_val", [1e-6, 1 - 1e-6])
    def test_extreme_decay_full_chunk_matches_plain(self, w_val):
        # chunk 64 at w = 1e-6: |cum| reaches 884, where float32 rounding of
        # the exponents costs about 1e-3 in both chunked forms against the
        # Pallas kernel alike; the split itself changes nothing against the
        # sequential plain version
        args = _inputs(60, 1, 2, 256, 16, 64, w_val=w_val)
        o, state = _chunk_parallel(*map(torch.from_numpy, args), 64)
        assert torch.isfinite(o).all() and torch.isfinite(state).all()
        o_p, s_p = PK.rwkv6_plain(*map(torch.from_numpy, args), chunk=64)
        np.testing.assert_allclose(o.numpy(), o_p.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(state.numpy(), s_p.numpy(), rtol=2e-4,
                                   atol=2e-4)

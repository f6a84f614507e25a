"""Port parity, flash attention (kernel K4): ``repro_torch`` on the CPU
against ``repro``.

* ``attention_block_schedule`` equal to the reference's over a grid of
  (seq, bq, bk, causal, window);
* K4's plain version (``kernels.ops.flash_attention`` on CPU tensors)
  against the reference's Pallas ``flash_attention`` in interpret mode and
  its ``flash_attention_ref`` oracle, over every ``TestFlashAttention``
  case at its tolerance (2e-3 float32, 3e-2 bfloat16);
* the model-level ``models.attention.flash_attention`` against
  ``flash_attention_jnp`` on a ragged S, on the ``_windowed`` branch
  (S > window + bq) and at head dims 256 and 16, and ``decode_attention``
  against the reference's;
* every head dim of the configs (and of ``reduced_config``) is one K4
  takes on the card;
* K4's backward as the CPU runs it (autograd through the plain version;
  ``flash_attention_bwd`` on CPU tensors) against ``jax.vjp`` of
  ``flash_attention_jnp``, and the one guard of the kernels without a
  backward (``_build.refuse_grad``);
* the arithmetic of K4's bfloat16 backward kernels (P and dS rounded to
  bfloat16 once, as the A operands of their products; D from the forward's
  bfloat16 output; every sum in float32), written in plain torch here,
  against ``jax.vjp`` of ``flash_attention_jnp`` at every head dim: the
  design keeps dq, dk and dv within the card's 5e-3 relative norm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.kernels.flash_attention as RF
import repro.models.attention as RA
import repro_torch.kernels.flash_attention as PF
import repro_torch.models.attention as PA
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops as pops


def _qkv(seed, b, h, hkv, s, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.standard_normal((b, n, s, d))).astype(
        np.float32) for n in (h, hkv, hkv))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


class TestSchedule:
    @pytest.mark.parametrize("seq,bq,bk", [(512, 64, 64), (256, 64, 128),
                                           (1024, 128, 64), (96, 32, 32),
                                           (64, 64, 64)])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("window", [0, 1, 64, 100, 128, 4096])
    def test_equal_to_reference(self, seq, bq, bk, causal, window):
        got = pops.attention_block_schedule(seq, bq, bk, causal=causal,
                                            window=window)
        want = RF.attention_block_schedule(seq, bq, bk, causal=causal,
                                           window=window)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[2] == want[2]

    def test_skips_invisible_blocks(self):
        lo, n, _ = pops.attention_block_schedule(512, 64, 64, causal=True)
        assert list(n) == list(range(1, 9))
        _, n2, _ = pops.attention_block_schedule(512, 64, 64, causal=True,
                                                 window=128)
        assert n2.max() <= 3


class TestK4PlainMatchesReference:
    """Every ``TestFlashAttention`` case of ``tests/test_kernels.py``."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_basic(self, dtype, causal):
        q, k, v = _qkv(0, 2, 4, 4, 256, 64)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
        got = pops.flash_attention(*(torch.from_numpy(x).to(tdt)
                                     for x in (q, k, v)), causal=causal)
        assert got.dtype == tdt and tuple(got.shape) == q.shape
        tol = 2e-3 if dtype == "float32" else 3e-2
        _close(got, rops.flash_attention(jq, jk, jv, causal=causal, bq=64,
                                         bk=64), tol)
        _close(got, rref.flash_attention_ref(jq, jk, jv, causal=causal), tol)

    @pytest.mark.parametrize("window", [64, 128])
    def test_sliding_window(self, window):
        q, k, v = _qkv(1, 1, 2, 2, 512, 32)
        got = pops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window)
        _close(got, rops.flash_attention(q, k, v, causal=True, window=window,
                                         bq=64, bk=64), 2e-3)
        _close(got, rref.flash_attention_ref(q, k, v, causal=True,
                                             window=window), 2e-3)

    def test_softcap_gemma2(self):
        q, k, v = _qkv(2, 1, 2, 2, 128, 32)
        q, k = 3 * q, 3 * k
        got = pops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, softcap=50.0)
        _close(got, rops.flash_attention(q, k, v, causal=True, softcap=50.0,
                                         bq=64, bk=64), 2e-3)
        _close(got, rref.flash_attention_ref(q, k, v, causal=True,
                                             softcap=50.0), 2e-3)

    def test_gqa(self):
        q, k, v = _qkv(3, 1, 8, 2, 128, 32)
        got = pops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
        _close(got, rops.flash_attention(q, k, v, causal=True, bq=64, bk=64),
               2e-3)
        rep = [np.repeat(x, 4, axis=1) for x in (k, v)]
        _close(got, rref.flash_attention_ref(q, *rep, causal=True), 2e-3)

    def test_scale_and_non_causal_window(self):
        q, k, v = _qkv(4, 1, 4, 2, 128, 32)
        kw = dict(causal=False, window=40, scale=0.3)
        got = pops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
        _close(got, rops.flash_attention(q, k, v, bq=64, bk=64, **kw), 2e-3)

    def test_rejects_mismatched_heads(self):
        q = torch.zeros(1, 3, 16, 32)
        k = torch.zeros(1, 2, 16, 32)
        with pytest.raises(ValueError, match="incompatible"):
            pops.flash_attention(q, k, k)


class TestModelAttention:
    @pytest.mark.parametrize("s,spec", [
        (100, dict(causal=True, window=0)),
        (100, dict(causal=True, window=16, softcap=20.0)),
        (36, dict(causal=False, window=0)),
    ])
    def test_ragged_seq(self, s, spec):
        q, k, v = _qkv(5, 2, 4, 2, s, 16)
        got = PA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 PA.AttnSpec(**spec, scale=0.25))
        want = RA.flash_attention_jnp(q, k, v, RA.AttnSpec(**spec,
                                                           scale=0.25))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize("window", [32, 64])
    def test_windowed_branch(self, window):
        q, k, v = _qkv(6, 1, 4, 2, 256, 16)
        spec = dict(causal=True, window=window)
        assert window + 64 < 256          # the reference's _windowed path
        got = PA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 PA.AttnSpec(**spec), bq=64, bk=64)
        want = RA.flash_attention_jnp(q, k, v, RA.AttnSpec(**spec), bq=64,
                                      bk=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize("d,h,hkv,s,spec", [
        (256, 8, 4, 128, dict(causal=True, window=32, softcap=50.0)),
        (256, 4, 1, 96, dict(causal=True, window=0)),
        (16, 4, 2, 128, dict(causal=True, window=16, softcap=20.0)),
        (16, 8, 2, 64, dict(causal=False, window=0)),
    ])
    def test_head_dims_256_and_16(self, d, h, hkv, s, spec):
        # gemma2-2b / paligemma-3b's head dim and reduced_config's
        q, k, v = _qkv(10 + d, 1, h, hkv, s, d)
        got = PA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 PA.AttnSpec(**spec))
        want = RA.flash_attention_jnp(q, k, v, RA.AttnSpec(**spec))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    def test_bfloat16_within_one_rounding_of_p(self):
        # flash_attention_jnp rounds p to bfloat16 before the PV product;
        # the port keeps p in float32 (as the Pallas kernel does)
        q, k, v = _qkv(7, 1, 4, 2, 128, 16)
        got = PA.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                   for x in (q, k, v)), PA.AttnSpec())
        want = RA.flash_attention_jnp(*(jnp.asarray(x, jnp.bfloat16)
                                        for x in (q, k, v)), RA.AttnSpec())
        _close(got, want, 3e-2)

    def test_keeps_reference_block_assertion(self):
        q, k, v = (torch.zeros(1, 2, 1100, 16) for _ in range(3))
        with pytest.raises(ValueError, match="multiple"):
            PA.flash_attention(q, k, v, PA.AttnSpec())
        with pytest.raises(AssertionError):
            RA.flash_attention_jnp(q.numpy(), k.numpy(), v.numpy(),
                                   RA.AttnSpec())

    @pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0),
                                                (0, 30.0)])
    def test_decode_attention(self, window, softcap):
        rng = np.random.default_rng(8)
        b, h, hkv, sc, d = 3, 4, 2, 16, 16
        q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        kc, vc = (rng.standard_normal((b, hkv, sc, d)).astype(np.float32)
                  for _ in range(2))
        slot_pos = np.tile(np.arange(sc, dtype=np.int32), (b, 1))
        slot_pos[1, 10:] = -1
        pos = np.array([15, 9, -1], np.int32)          # row 2 idle
        kw = dict(causal=True, window=window, softcap=softcap)
        got = PA.decode_attention(*map(torch.from_numpy,
                                       (q, kc, vc, slot_pos, pos)),
                                  PA.AttnSpec(**kw))
        want = RA.decode_attention(q, kc, vc, slot_pos, pos,
                                   RA.AttnSpec(**kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


class TestBackward:
    """K4's backward as the CPU runs it (autograd through the plain
    version, which ``flash_attention_bwd`` calls on CPU tensors) against
    ``jax.vjp`` of ``flash_attention_jnp``, the function the reference's
    models differentiate: float32, within 1e-5 (the same sums in another
    order)."""

    @pytest.mark.parametrize("b,h,hkv,s,d,spec", [
        (2, 4, 2, 96, 16, dict()),
        (1, 8, 4, 128, 32, dict(window=32)),
        (2, 4, 4, 64, 64, dict(causal=False)),
        (1, 4, 1, 80, 16, dict(softcap=5.0, window=24)),
        (1, 2, 2, 48, 256, dict(softcap=50.0))])
    def test_grads_match_flash_attention_jnp(self, b, h, hkv, s, d, spec):
        q, k, v = _qkv(b * s + d, b, h, hkv, s, d)
        dout = np.random.default_rng(s).standard_normal(q.shape).astype(
            np.float32)
        _, vjp = jax.vjp(lambda *a: RA.flash_attention_jnp(
            *a, RA.AttnSpec(**spec)), q, k, v)
        want = vjp(jnp.asarray(dout))
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = pops.flash_attention(*leaves, **spec)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
        direct = PF.flash_attention_bwd(*(torch.from_numpy(x)
                                          for x in (q, k, v)), out.detach(),
                                        torch.from_numpy(dout), **spec)
        for g, dg, w in zip(got, direct, want):
            assert g.shape == w.shape and torch.equal(g, dg)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)

    def test_no_grad_needed_no_graph(self):
        q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 2, 2, 32, 16))
        assert not pops.flash_attention(q, k, v).requires_grad


def _bf16_design_bwd(q, k, v, dout, causal=True, window=0, softcap=0.0):
    """dq, dk, dv as ``csrc/flash_attention_bwd.cu``'s bfloat16 kernels
    round them: bfloat16 inputs and out, P and dS rounded to bfloat16 before
    the products they feed, float32 sums, each result rounded once."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    x = qf @ kr.transpose(-1, -2) * d ** -0.5
    if softcap > 0.0:
        x = softcap * torch.tanh(x / softcap)
    mask = PF.attention_mask(s, causal=causal, window=window, device="cpu")
    lse = torch.logsumexp(torch.where(mask, x, torch.tensor(-1e30)), -1,
                          keepdim=True)
    p = torch.where(mask, torch.exp(x - lse), torch.zeros(()))
    out = (p @ vr).to(torch.bfloat16).float()
    dlog = d ** -0.5 * (1 - (x / softcap) ** 2) if softcap > 0.0 \
        else d ** -0.5
    ds = (p * (gf @ vr.transpose(-1, -2) - (gf * out).sum(-1, keepdim=True))
          * dlog).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()

    def per_kv(t):
        return t.reshape(b, k.shape[1], g, s, d).sum(2)

    return [t.to(torch.bfloat16) for t in (
        ds @ kr, per_kv(ds.transpose(-1, -2) @ qf),
        per_kv(pb.transpose(-1, -2) @ gf))]


@pytest.mark.parametrize("b,h,hkv,s,d,spec", [
    (2, 4, 2, 300, 16, dict(window=32)),
    (1, 4, 2, 300, 32, dict(window=16)),
    (1, 10, 2, 257, 64, dict(window=100)),
    (2, 4, 2, 200, 128, dict()),
    (1, 4, 2, 160, 128, dict(window=64, softcap=50.0)),
    (1, 4, 2, 130, 256, dict(window=4096, softcap=50.0)),
    (2, 2, 2, 96, 64, dict(causal=False))])
def test_bf16_backward_design_within_the_card_limit(b, h, hkv, s, d, spec):
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(s + d, b, h, hkv, s, d))
    dout = torch.from_numpy(np.random.default_rng(d).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    _, vjp = jax.vjp(lambda *a: RA.flash_attention_jnp(
        *a, RA.AttnSpec(**spec)), *(t.float().numpy() for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.float().numpy()))
    for g, w in zip(_bf16_design_bwd(q, k, v, dout, **spec), want):
        w = torch.from_numpy(np.array(w, np.float32))
        assert ((g.float() - w).norm() / w.norm()).item() <= 5e-3


def test_refuse_grad_raises_only_when_a_gradient_is_asked_for():
    from repro_torch.kernels import _build
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K5 .* no backward"):
        _build.refuse_grad("K5 (moe_gemm)", x, torch.zeros(2))
    with torch.no_grad():
        _build.refuse_grad("K5 (moe_gemm)", x)
    _build.refuse_grad("K5 (moe_gemm)", torch.zeros(2), None)


def test_k4_takes_every_head_dim_the_configs_use():
    from repro_torch.configs import ARCHS, get_config, reduced_config
    dims = {get_config(a).d_head for a in ARCHS}
    dims |= {reduced_config(get_config(a)).d_head for a in ARCHS}
    assert dims <= set(PF.K4_HEAD_DIMS)
    assert {16, 64, 128, 256} <= dims


def test_plain_is_the_kernel_modules_function():
    # the wrapper runs the module's plain version on CPU tensors
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 2, 1, 70, 64))
    before = PF.flash_attention.launches
    out = PF.flash_attention(q, k, v, window=20)
    assert torch.equal(out, PF.flash_attention_plain(q, k, v, window=20))
    assert PF.flash_attention.launches == before

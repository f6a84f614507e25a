"""Port parity, paligemma-3b (image prefixes, prefix-LM attention):
``repro_torch.models`` and ``repro_torch.launch`` on the CPU against
``repro``, at the reduced config in float32 with the reference's params
carried across by ``params_from_numpy``, within 1e-4.

* the param tree (``img_proj`` included) equal to the reference's, key for
  key and shape for shape, full and reduced;
* ``forward`` with images (prefix-LM) and without (K4's plain version);
  ``_prefix_attention`` itself, at several prefixes and under GQA;
* ``prefill`` with images and 3 decode steps, caches included;
* two reference quirks, pinned: ``prefill`` under images is causal (only
  ``forward`` is prefix-LM), and ``_prefix_attention`` ignores the spec's
  softcap and window;
* text-only serving (``ServeScheduler.run``, ``generate``) token-equal to
  the reference's, the slot-wise cache helpers, and ``compute_params``
  casting ``img_proj``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.launch.scheduler as RS
import repro.launch.serve as RV
import repro.models.blocks as RB
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.launch.scheduler as PS
import repro_torch.launch.serve as PV
import repro_torch.models.blocks as PB
import repro_torch.models.model as PM
from _torch_parity import tree_close
from repro.models.params import _walk as r_walk
from repro_torch.models.params import _walk as p_walk
from repro_torch.models.params import params_from_numpy

ARCH = "paligemma-3b"
CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vlm():
    """(reference cfg, port cfg, reference params, port params)."""
    cfg = RC.reduced_config(RC.get_config(ARCH))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    return cfg, PC.reduced_config(PC.get_config(ARCH)), params, pp


def _inputs(cfg, seed, batch=2, text=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    images = rng.standard_normal(
        (batch, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)
    return toks, images


@pytest.mark.parametrize("reduced", [False, True])
def test_metas_equal_reference(reduced):
    r, p = RC.get_config(ARCH), PC.get_config(ARCH)
    if reduced:
        r, p = RC.reduced_config(r), PC.reduced_config(p)
    want = [(path, m.shape, m.axes, m.init, m.scale)
            for path, m in r_walk(RM.lm_metas(r))]
    got = [(path, m.shape, m.axes, m.init, m.scale)
           for path, m in p_walk(PM.lm_metas(p))]
    assert got == want
    assert PM.lm_metas(p)["img_proj"].shape == (p.d_image, p.d_model)


@pytest.mark.parametrize("with_images", [True, False])
def test_forward(vlm, with_images):
    cfg, pcfg, params, pp = vlm
    toks, images = _inputs(cfg, 1)
    kw_ref = dict(images=jnp.asarray(images)) if with_images else {}
    kw = dict(images=torch.from_numpy(images)) if with_images else {}
    want, want_aux = RM.forward(cfg, params, jnp.asarray(toks), **kw_ref)
    got, aux = PM.forward(pcfg, pp, torch.from_numpy(toks), **kw)
    n = toks.shape[1] + (cfg.n_image_tokens if with_images else 0)
    assert tuple(got.shape) == (2, n, cfg.vocab_size)
    assert got.dtype == torch.float32 and float(aux) == float(want_aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,hkv,prefix", [(4, 1, 8), (4, 2, 1), (2, 2, 20),
                                          (4, 4, 32)])
def test_prefix_attention_matches_reference(h, hkv, prefix):
    rng = np.random.default_rng(prefix)
    q = rng.standard_normal((2, h, 32, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, 32, 16)).astype(np.float32)
            for _ in range(2))
    spec = dict(causal=True, window=0, softcap=0.0, scale=0.3)
    want = RB._prefix_attention(q, k, v, RB.AttnSpec(**spec), prefix)
    got = PB._prefix_attention(*map(torch.from_numpy, (q, k, v)),
                               PB.AttnSpec(**spec), prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefix_attention_ignores_softcap_and_window():
    # a reference quirk, kept: the prefix-LM path reads only the scale
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
               for _ in range(3))
    plain = dict(causal=True, window=0, softcap=0.0, scale=None)
    capped = dict(causal=True, window=4, softcap=0.5, scale=None)
    want = RB._prefix_attention(q, k, v, RB.AttnSpec(**capped), 6)
    got = PB._prefix_attention(*map(torch.from_numpy, (q, k, v)),
                               PB.AttnSpec(**capped), 6)
    same = PB._prefix_attention(*map(torch.from_numpy, (q, k, v)),
                                PB.AttnSpec(**plain), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, same)


def test_prefill_with_images_then_three_decode_steps(vlm):
    cfg, pcfg, params, pp = vlm
    toks, images = _inputs(cfg, 2)
    n = cfg.n_image_tokens + toks.shape[1]
    c = RM.init_cache(cfg, 2, n + 4)
    pc = PM.init_cache(pcfg, 2, n + 4, device=CPU)
    tree_close(pc, jax.tree.map(np.asarray, c), rtol=0, atol=0)
    want, c = RM.prefill(cfg, params, jnp.asarray(toks), c,
                         images=jnp.asarray(images))
    got, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks), pc,
                         images=torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tree_close(pc, jax.tree.map(np.asarray, c), **TOL)
    tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
    for pos in range(n, n + 3):
        want, c = RM.decode_step(cfg, params, c, jnp.asarray(tok),
                                 jnp.int32(pos))
        got, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
            np.int32)
    tree_close(pc, jax.tree.map(np.asarray, c), **TOL)


def test_prefill_under_images_is_causal(vlm):
    # a reference quirk, kept: prefill attends causally over the image
    # prefix (block_prefill takes no prefix), where forward is prefix-LM;
    # so prefill equals a forward with prefix_lm off, in both packages
    cfg, pcfg, params, pp = vlm
    toks, images = _inputs(cfg, 4)
    n = cfg.n_image_tokens + toks.shape[1]
    causal_r = dataclasses.replace(cfg, prefix_lm=False)
    causal_p = dataclasses.replace(pcfg, prefix_lm=False)
    ref_prefill, _ = RM.prefill(cfg, params, jnp.asarray(toks),
                                RM.init_cache(cfg, 2, n),
                                images=jnp.asarray(images))
    got, _ = PM.prefill(pcfg, pp, torch.from_numpy(toks),
                        PM.init_cache(pcfg, 2, n, device=CPU),
                        images=torch.from_numpy(images))
    ref_causal, _ = RM.forward(causal_r, params, jnp.asarray(toks),
                               images=jnp.asarray(images))
    causal, _ = PM.forward(causal_p, pp, torch.from_numpy(toks),
                           images=torch.from_numpy(images))
    prefix_lm, _ = PM.forward(pcfg, pp, torch.from_numpy(toks),
                              images=torch.from_numpy(images))
    np.testing.assert_allclose(np.asarray(ref_prefill), np.asarray(
        ref_causal), **TOL)
    np.testing.assert_allclose(got.numpy(), causal.numpy(), **TOL)
    assert (got - prefix_lm).abs().max() > 1e-2


def test_text_only_serving_equals_reference(vlm):
    cfg, pcfg, params, pp = vlm
    trace = PS.synthetic_trace(6, seed=8, vocab=cfg.vocab_size,
                               prompt_lens=(4, 6, 8), gen_lens=(1, 3, 5))
    want = RS.ServeScheduler(cfg, params, max_batch=3, max_seq=32).run(trace)
    sch = PS.ServeScheduler(pcfg, pp, max_batch=3, max_seq=32, device=CPU)
    got = sch.run(trace)
    assert [(c.rid, c.tokens, c.finished_step) for c in got] == \
        [(c.rid, c.tokens, c.finished_step) for c in want]
    assert not PM.cache_slot_occupancy(sch.cache).any()
    toks, _ = _inputs(cfg, 5, text=10)
    want, _ = RV.generate(cfg, params, jnp.asarray(toks), gen=4, max_seq=16)
    got, _ = PV.generate(pcfg, pp, toks, gen=4, max_seq=16, device=CPU)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_slot_cache_after_image_prefill(vlm):
    cfg, pcfg, params, pp = vlm
    toks, images = _inputs(cfg, 6, batch=1, text=4)
    n = cfg.n_image_tokens + 4
    _, row = RM.prefill(cfg, params, jnp.asarray(toks),
                        RM.init_cache(cfg, 1, 24), images=jnp.asarray(images))
    _, prow = PM.prefill(pcfg, pp, torch.from_numpy(toks),
                         PM.init_cache(pcfg, 1, 24, device=CPU),
                         images=torch.from_numpy(images))
    c = RM.cache_write_slot(RM.init_cache(cfg, 3, 24), 2, row,
                            valid_upto=n - 1)
    pc = PM.cache_write_slot(PM.init_cache(pcfg, 3, 24, device=CPU), 2, prow,
                             valid_upto=n - 1)
    tree_close(pc, jax.tree.map(np.asarray, c), **TOL)
    occ = PM.cache_slot_occupancy(pc)
    assert np.array_equal(occ, RM.cache_slot_occupancy(c))
    assert occ[2] == (n - 1) * cfg.n_layers and not occ[:2].any()
    c, pc = RM.cache_evict_slot(c, 2), PM.cache_evict_slot(pc, 2)
    tree_close(pc, jax.tree.map(np.asarray, c), rtol=0, atol=0)
    assert not PM.cache_slot_residue(pc).any()


def test_compute_params_casts_img_proj(vlm):
    _, pcfg, _, pp = vlm
    cfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    cp = PM.compute_params(cfg, pp, CPU)
    assert cp["img_proj"].dtype == torch.bfloat16
    assert cp["final_norm"].dtype == torch.float32
    toks, images = _inputs(cfg, 7, batch=1, text=8)
    a, _ = PM.forward(cfg, pp, torch.from_numpy(toks),
                      images=torch.from_numpy(images))
    b, _ = PM.forward(cfg, cp, torch.from_numpy(toks),
                      images=torch.from_numpy(images))
    assert torch.equal(a, b)

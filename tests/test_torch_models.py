"""Port parity, the LM stack: ``repro_torch.configs`` and
``repro_torch.models`` on the CPU against ``repro``.

* every architecture config equal to the reference's, field by field, full
  and reduced;
* the param tree of ``lm_metas`` equal to the reference's, key for key and
  shape for shape, for hymba-1.5b, qwen3-1.7b, gemma2-2b, rwkv6-1.6b,
  dbrx-132b, kimi-k2 (its shared experts included), gemma3-27b (the only
  config with tail layers and ``rope_theta_local``) and qwen3-4b; hymba's full
  parameter count, from metas, within ``tests/test_arch_smoke.py``'s bounds;
* the layers (``rms_norm``, ``rotary``, ``softcap``, ``dense``,
  ``embed_lookup``, ``unembed``, ``swiglu``) against the reference's;
* at the reduced configs of the eight, in float32 with the reference's
  params carried across by ``params_from_numpy``: ``forward`` logits (and
  the MoE aux loss), ``prefill`` logits and cache (the ring branch
  included; rwkv's ``wkv``, ``shift`` and ``shift_cm``), and 4 decode
  steps at per-row positions, all within 1e-4; the slot-wise cache helpers;
* the rwkv mixer's pieces (``rwkv_forward`` with a carried shift,
  ``rwkv_decode``, ``rwkv_channel_mix``) against the reference's;
* the entry points default to ``cuda`` and raise without a card.

paligemma-3b and whisper-small have files of their own
(``test_torch_vlm.py``, ``test_torch_encdec.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.models.layers as RL
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.models.layers as PL
import repro_torch.models.model as PM
from _torch_parity import to_np32, tree_close
from repro.models.params import _walk as r_walk
from repro_torch.models.params import (count_params, params_from_numpy,
                                       tree_slice)

CPU = "cpu"
ARCHS = ["hymba-1.5b", "qwen3-1.7b", "gemma2-2b", "rwkv6-1.6b", "dbrx-132b",
         "kimi-k2-1t-a32b", "gemma3-27b", "qwen3-4b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, port cfg, reference params, port params)."""
    arch = request.param
    cfg = RC.reduced_config(RC.get_config(arch))
    pcfg = PC.reduced_config(PC.get_config(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    return cfg, pcfg, params, pp


class TestConfigs:
    @pytest.mark.parametrize("arch", RC.ARCHS)
    @pytest.mark.parametrize("reduced", [False, True])
    def test_every_field_equal(self, arch, reduced):
        r, p = RC.get_config(arch), PC.get_config(arch)
        if reduced:
            r, p = RC.reduced_config(r), PC.reduced_config(p)
        for f in dataclasses.fields(r):
            assert getattr(p, f.name) == getattr(r, f.name), f.name
        assert (p.period, p.n_periods, p.tail_layers) == \
            (r.period, r.n_periods, r.tail_layers)
        assert str(p.pdtype).split(".")[-1] == np.dtype(r.pdtype).name
        assert str(p.cdtype).split(".")[-1] == np.dtype(r.cdtype).name

    def test_shapes_and_registry(self):
        assert PC.ARCHS == RC.ARCHS
        assert PC.SHAPES == {k: PC.ShapeConfig(*dataclasses.astuple(v))
                             for k, v in RC.SHAPES.items()}
        with pytest.raises(KeyError):
            PC.get_config("nope")
        assert PC.get_config("hymba-1.5b", window=8).window == 8


class TestParamTree:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("reduced", [False, True])
    def test_metas_equal_reference(self, arch, reduced):
        r, p = RC.get_config(arch), PC.get_config(arch)
        if reduced:
            r, p = RC.reduced_config(r), PC.reduced_config(p)
        want = [(path, m.shape, m.axes, m.init, m.scale)
                for path, m in r_walk(RM.lm_metas(r))]
        from repro_torch.models.params import _walk
        got = [(path, m.shape, m.axes, m.init, m.scale)
               for path, m in _walk(PM.lm_metas(p))]
        assert got == want

    def test_hymba_keeps_unused_wo_s(self):
        metas = PM.lm_metas(PC.get_config("hymba-1.5b"))
        assert metas["layers"]["pos0"]["ssm"]["wo_s"].shape == (32, 1600,
                                                                1600)

    def test_full_hymba_count_from_metas(self):
        total = count_params(PM.lm_metas(PC.get_config("hymba-1.5b")))
        assert 1.2e9 < total < 2.3e9         # test_arch_smoke.py's bounds

    def test_init_params_shapes_dtypes_and_seed(self):
        cfg = PC.reduced_config(PC.get_config("hymba-1.5b"))
        a = PM.init_params(cfg, 3, device=CPU)
        b = PM.init_params(cfg, 3, device=CPU)
        c = PM.init_params(cfg, 4, device=CPU)
        from repro_torch.models.params import _walk
        shapes = [(p, tuple(x.shape)) for p, x in _walk(a)]
        assert shapes == [(p, m.shape) for p, m in _walk(PM.lm_metas(cfg))]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_walk(a),
                                                               _walk(b)))
        assert not torch.equal(a["embed"], c["embed"])
        assert not torch.equal(a["layers"]["pos0"]["attn"]["wq"],
                               a["layers"]["pos0"]["attn"]["wk"][..., :64])
        assert torch.all(a["layers"]["pos0"]["ssm"]["wb_s"] == 0)
        assert torch.all(a["final_norm"] == 1)
        # the reference's fan-in: every dim but the last, the stacked
        # layer dim included
        wq = a["layers"]["pos0"]["attn"]["wq"]
        fan_in = cfg.n_periods * cfg.d_model
        assert abs(float(wq.std()) - fan_in ** -0.5) < 0.01


class TestLayers:
    def test_rms_norm_rotary_softcap(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
        w = rng.standard_normal(16).astype(np.float32)
        for plus_one in (False, True):
            np.testing.assert_allclose(
                PL.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            plus_one=plus_one).numpy(),
                np.asarray(RL.rms_norm(x, w, plus_one=plus_one)), **TOL)
        pos = rng.integers(0, 100, (2, 1, 5)).astype(np.int32)
        np.testing.assert_allclose(
            PL.rotary(torch.from_numpy(x), torch.from_numpy(pos),
                      theta=1e6).numpy(),
            np.asarray(RL.rotary(x, pos, theta=1e6)), **TOL)
        np.testing.assert_allclose(
            PL.softcap(torch.from_numpy(30 * x), 50.0).numpy(),
            np.asarray(RL.softcap(30 * x, 50.0)), **TOL)
        xt = torch.from_numpy(x)
        assert PL.softcap(xt, 0.0) is xt

    def test_dense_embed_unembed_swiglu(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 3, 8)).astype(np.float32)
        w2 = rng.standard_normal((8, 12)).astype(np.float32)
        w3 = rng.standard_normal((8, 2, 6)).astype(np.float32)
        for w in (w2, w3):
            np.testing.assert_allclose(
                PL.dense(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                np.asarray(RL.dense(x, w, out_dims=w.ndim - 1)), **TOL)
        table = rng.standard_normal((20, 8)).astype(np.float32)
        tok = rng.integers(0, 20, (2, 3)).astype(np.int32)
        for scale in (None, 8 ** 0.5):
            for pdt, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
                got = PL.embed_lookup(torch.from_numpy(tok),
                                      torch.from_numpy(table), scale=scale,
                                      compute_dtype=pdt)
                want = RL.embed_lookup(tok, table, scale=scale,
                                       compute_dtype=jdt)
                assert got.dtype == pdt
                np.testing.assert_array_equal(to_np32(got), to_np32(want))
        for xdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            got = PL.unembed(torch.from_numpy(x).to(xdt),
                             torch.from_numpy(table), cap=30.0)
            want = RL.unembed(jnp.asarray(x, jdt), table, cap=30.0)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        wg, wu = (rng.standard_normal((8, 16)).astype(np.float32)
                  for _ in range(2))
        wd = rng.standard_normal((16, 8)).astype(np.float32)
        np.testing.assert_allclose(
            PL.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))).numpy(),
            np.asarray(RL.swiglu(x, wg, wu, wd)), **TOL)


class TestModelParity:
    def test_forward(self, model):
        cfg, pcfg, params, pp = model
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 48)).astype(np.int32)
        want, want_aux = RM.forward(cfg, params, jnp.asarray(toks))
        got, aux = PM.forward(pcfg, pp, torch.from_numpy(toks))
        assert got.dtype == torch.float32 and aux.dtype == torch.float32
        assert (float(aux) == 0.0) == (cfg.ffn != "moe")
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("prompt,max_seq", [(32, 40), (48, 64),
                                                (128, 140)])
    def test_prefill_then_four_decode_steps(self, model, prompt, max_seq):
        # (48, 64) and (128, 140) exceed the reduced window (32): the
        # local layers' ring branch; 128 runs the SSM in chunks of 64
        cfg, pcfg, params, pp = model
        toks = np.random.default_rng(prompt).integers(
            0, cfg.vocab_size, (2, prompt)).astype(np.int32)
        c = RM.init_cache(cfg, 2, max_seq)
        pc = PM.init_cache(pcfg, 2, max_seq, device=CPU)
        tree_close(pc, jax.tree.map(np.asarray, c), rtol=0, atol=0)
        want, c = RM.prefill(cfg, params, jnp.asarray(toks), c)
        got, pc = PM.prefill(pcfg, pp, torch.from_numpy(toks), pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tree_close(pc, jax.tree.map(np.asarray, c), **TOL)
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
            np.int32)
        pos = np.array([prompt, prompt - 2], np.int32)   # per-row positions
        for _ in range(4):
            want, c = RM.decode_step(cfg, params, c, jnp.asarray(tok),
                                     jnp.asarray(pos))
            got, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(
                np.int32)
            pos = pos + 1
        tree_close(pc, jax.tree.map(np.asarray, c), **TOL)

    def test_scalar_position_decode(self, model):
        cfg, pcfg, params, pp = model
        c = RM.init_cache(cfg, 2, 16)
        pc = PM.init_cache(pcfg, 2, 16, device=CPU)
        tok = np.array([[3], [7]], np.int32)
        want, c = RM.decode_step(cfg, params, c, jnp.asarray(tok),
                                 jnp.int32(0))
        got, pc = PM.decode_step(pcfg, pp, pc, torch.from_numpy(tok), 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tree_close(pc, jax.tree.map(np.asarray, c), **TOL)

    def test_inputs_left_unchanged(self, model):
        _, pcfg, _, pp = model
        pc = PM.init_cache(pcfg, 1, 16, device=CPU)
        before = {k: v.clone() for k, v in tree_slice(pc["layers"], 0)[
            "pos0"].items()}
        PM.prefill(pcfg, pp, torch.zeros((1, 8), dtype=torch.int32), pc)
        after = tree_slice(pc["layers"], 0)["pos0"]
        assert all(torch.equal(before[k], after[k]) for k in before)


class TestRwkvMixer:
    """The rwkv mixer's pieces at rwkv6-1.6b's reduced config, float32."""

    @pytest.fixture(scope="class")
    def rwkv(self):
        cfg = RC.reduced_config(RC.get_config("rwkv6-1.6b"))
        pcfg = PC.reduced_config(PC.get_config("rwkv6-1.6b"))
        params = RM.init_params(cfg, jax.random.PRNGKey(1))
        blk = jax.tree.map(lambda a: np.asarray(a)[0],
                           params["layers"]["pos0"])
        # the mixes start at zero: give them values, as training would
        rng = np.random.default_rng(3)
        for key in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            blk["rwkv"][key] = rng.uniform(0, 1, cfg.d_model).astype(
                np.float32)
        blk["ffn"]["mu_cm"] = rng.uniform(0, 1, cfg.d_model).astype(
            np.float32)
        return cfg, pcfg, blk, params_from_numpy(blk, device=CPU)

    def test_forward_with_carried_shift(self, rwkv):
        import repro.models.blocks as RB
        import repro_torch.models.blocks as PB
        cfg, pcfg, blk, pb = rwkv
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
        shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        for state in (None, {"shift": shift}):
            want, wst = RB.rwkv_forward(cfg, blk["rwkv"], jnp.asarray(x),
                                        state)
            got, gst = PB.rwkv_forward(
                pcfg, pb["rwkv"], torch.from_numpy(x), None if state is None
                else {"shift": torch.from_numpy(shift)})
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            tree_close(gst, jax.tree.map(np.asarray, wst), **TOL)

    def test_decode_and_channel_mix(self, rwkv):
        import repro.models.blocks as RB
        import repro_torch.models.blocks as PB
        cfg, pcfg, blk, pb = rwkv
        rng = np.random.default_rng(5)
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        cache = {"wkv": rng.standard_normal(
                     (3, cfg.n_heads, cfg.d_head, cfg.d_head)).astype(
                     np.float32),
                 "shift": rng.standard_normal((3, cfg.d_model)).astype(
                     np.float32),
                 "shift_cm": rng.standard_normal((3, cfg.d_model)).astype(
                     np.float32)}
        want, wc = RB.rwkv_decode(cfg, blk["rwkv"], jnp.asarray(x), cache)
        got, gc = PB.rwkv_decode(pcfg, pb["rwkv"], torch.from_numpy(x),
                                 params_from_numpy(cache, device=CPU))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tree_close(gc, jax.tree.map(np.asarray, wc), **TOL)
        prev = cache["shift_cm"][:, None, :]
        np.testing.assert_allclose(
            PB.rwkv_channel_mix(pcfg, pb["ffn"], torch.from_numpy(x),
                                torch.from_numpy(prev)).numpy(),
            np.asarray(RB.rwkv_channel_mix(cfg, blk["ffn"], jnp.asarray(x),
                                           jnp.asarray(prev))), **TOL)


class TestSlotCache:
    def test_write_evict_occupancy_match_reference(self, model):
        cfg, pcfg, params, pp = model
        toks = np.arange(6, dtype=np.int32)[None]
        row = RM.init_cache(cfg, 1, 24)
        _, row = RM.prefill(cfg, params, jnp.asarray(toks), row)
        prow = PM.init_cache(pcfg, 1, 24, device=CPU)
        _, prow = PM.prefill(pcfg, pp, torch.from_numpy(toks), prow)
        c = RM.cache_write_slot(RM.init_cache(cfg, 3, 24), 1, row,
                                valid_upto=4)
        pc = PM.cache_write_slot(PM.init_cache(pcfg, 3, 24, device=CPU), 1,
                                 prow, valid_upto=4)
        tree_close(pc, jax.tree.map(np.asarray, c), **TOL)
        occ = PM.cache_slot_occupancy(pc)
        assert np.array_equal(occ, RM.cache_slot_occupancy(c))
        if cfg.mixer == "rwkv":
            # no attention cache: zero occupancy, as the reference reports;
            # the written row holds the recurrent state
            wkv = pc["layers"]["pos0"]["wkv"]          # (periods, B, ...)
            assert not occ.any() and wkv[:, 1].abs().sum() > 0
            assert not wkv[:, 0].any() and not wkv[:, 2].any()
        else:
            assert occ[1] > 0 and occ[0] == occ[2] == 0
        res = PM.cache_slot_residue(pc)
        assert res[1] > 0 and res[0] == res[2] == 0
        c, pc = RM.cache_evict_slot(c, 1), PM.cache_evict_slot(pc, 1)
        tree_close(pc, jax.tree.map(np.asarray, c), rtol=0, atol=0)
        assert not PM.cache_slot_occupancy(pc).any()
        assert not PM.cache_slot_residue(pc).any()


class TestEntryPoints:
    def test_default_to_cuda_and_raise_without_card(self, monkeypatch):
        cfg = PC.reduced_config(PC.get_config("hymba-1.5b"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PM.init_params(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PM.init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
        p = params_from_numpy({"a": {"b": np.ones(3, np.float32)},
                               "c": np.zeros(2, np.int32)}, CPU)
        assert p["a"]["b"].dtype == torch.float32
        assert p["c"].dtype == torch.int32

    def test_bfloat16_leaves_carried_across(self):
        leaf = jnp.asarray([1.5, -2.25], jnp.bfloat16)
        p = params_from_numpy({"w": leaf}, CPU)
        assert p["w"].dtype == torch.bfloat16
        assert p["w"].float().tolist() == [1.5, -2.25]

    @pytest.mark.parametrize("arch", ["rwkv6-1.6b", "kimi-k2-1t-a32b"])
    def test_compute_params_keeps_float32_reads(self, arch):
        cfg = dataclasses.replace(PC.reduced_config(PC.get_config(arch)),
                                  compute_dtype="bfloat16")
        p = PM.init_params(cfg, 0, device=CPU)
        cp = PM.compute_params(cfg, p, CPU)
        blk = cp["layers"]["pos0"]
        if cfg.mixer == "rwkv":
            assert blk["rwkv"]["wr"].dtype == torch.bfloat16
            assert blk["ffn"]["w_in"].dtype == torch.bfloat16
            assert blk["rwkv"]["u"].dtype == torch.float32
            assert blk["rwkv"]["mu_r"].dtype == torch.float32
        else:
            assert blk["ffn"]["shared_up"].dtype == torch.bfloat16
            assert blk["ffn"]["router"].dtype == torch.float32
        toks = torch.arange(16, dtype=torch.int32)[None]
        a, aux_a = PM.forward(cfg, p, toks)
        b, aux_b = PM.forward(cfg, cp, toks)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)

    def test_compute_params_cast_once_same_values(self):
        cfg = dataclasses.replace(
            PC.reduced_config(PC.get_config("hymba-1.5b")),
            compute_dtype="bfloat16")
        p = PM.init_params(cfg, 0, device=CPU)
        cp = PM.compute_params(cfg, p, CPU)
        blk = cp["layers"]["pos0"]
        assert blk["attn"]["wq"].dtype == torch.bfloat16
        assert blk["ssm"]["norm_a"].dtype == torch.float32
        assert blk["ssm"]["wb_s"].dtype == torch.float32
        toks = torch.arange(16, dtype=torch.int32)[None]
        a, _ = PM.forward(cfg, p, toks)
        b, _ = PM.forward(cfg, cp, toks)
        assert torch.equal(a, b)

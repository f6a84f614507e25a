"""Port parity, training: ``repro_torch``'s data pipeline, loss, gradients,
train step and train CLI on the CPU against ``repro``.

* ``SyntheticLM`` batches bit-equal to the reference's for the same
  ``(seed, step, host_index)``, images and frames included, and the
  reference's ``TestData`` cases;
* ``cross_entropy_loss`` (with and without a mask), ``layer_norm`` and
  ``gelu_mlp`` against the reference's; ``grad_fence`` is the identity and
  autograd hands each tensor a gradient of its own dtype;
* ``loss_fn``'s loss and the gradient of every param leaf against
  ``jax.value_and_grad(M.loss_fn)`` at the reduced configs of eight
  archs (kimi-k2 the one MoE config with shared experts; float32, params
  carried across by ``params_from_numpy``);
* three ``make_train_step`` steps against the reference's losses; remat on
  and off bit-equal; the abstract param tree and training state;
* the CLI (``--reduced --device cpu``): falling loss over 30 steps, and a
  run resumed from its checkpoint at step 3 equal to an uninterrupted one.

Tolerances, float32 throughout: the loss within 1e-5 relative (a few ulps
of a loss of order 10); each gradient leaf within 1e-4 of the reference's
norm, ‖Δ‖ ≤ 1e-4 ‖g_ref‖ (sums in another order, through autograd's
graph instead of XLA's); the train steps' losses within 1e-4 relative
(three AdamW updates amplify the gradients' last-bit differences where a
gradient is near zero: its update is ±lr whatever its size).
"""
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter

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
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch.steps import make_train_step as r_make_train_step
from repro.optim import adamw as RA
from repro_torch.checkpoint import manager as pckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as PS
from repro_torch.launch import train as PT
from repro_torch.models.params import _walk, params_from_numpy
from repro_torch.optim import adamw as PA

CPU = "cpu"
TRAIN_ARCHS = ["qwen3-1.7b", "gemma2-2b", "hymba-1.5b", "rwkv6-1.6b",
               "dbrx-132b", "kimi-k2-1t-a32b", "paligemma-3b",
               "whisper-small"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _reference_default_numerics():
    """The reference at its default numerics, x64 off (the conftest turns
    x64 on for the float64 sparse paths, which would widen the reference's
    float32 schedule and updates to float64)."""
    with jax.enable_x64(False):
        yield


def _data_cfg(cfg, seq=32, batch=2, seed=0):
    return dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                seed=seed, n_image_tokens=cfg.n_image_tokens,
                d_image=cfg.d_image, d_frame=cfg.d_frame if cfg.enc_dec else 0)


def _both(arch):
    """(reference cfg, port cfg, reference params, numpy params)."""
    cfg = RC.reduced_config(RC.get_config(arch))
    pcfg = PC.reduced_config(PC.get_config(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, pcfg, params, jax.tree.map(np.asarray, params)


def _port_grads(pcfg, npp, batch):
    pp = params_from_numpy(npp, device=CPU)
    leaves = list(_walk(pp))
    for _, t in leaves:
        t.requires_grad_(True)
    loss, parts = PM.loss_fn(pcfg, pp, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            {path: g for (path, _), g in zip(leaves, grads)})


class TestData:
    @pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (7, 5, 0),
                                                (3, 1000, 1), (11, 2, 3)])
    def test_batches_bit_equal_reference(self, seed, step, host):
        kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=seed,
                  n_image_tokens=4, d_image=6, d_frame=5)
        got = SyntheticLM(DataConfig(**kw), host, 4).get_batch(step)
        want = RSyntheticLM(RDataConfig(**kw), host, 4).get_batch(step)
        assert sorted(got) == sorted(want) == ["frames", "images", "labels",
                                               "tokens"]
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key

    def test_deterministic_steps_differ_labels_shifted(self):
        cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
        a, b = SyntheticLM(cfg), SyntheticLM(cfg)
        for step in (0, 5, 1000):
            np.testing.assert_array_equal(a.get_batch(step)["tokens"],
                                          b.get_batch(step)["tokens"])
        assert not np.array_equal(a.get_batch(0)["tokens"],
                                  a.get_batch(1)["tokens"])
        x = a.get_batch(3)
        np.testing.assert_array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
        it = a.iter_from(5)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      a.get_batch(5)["tokens"])

    def test_host_sharding_partitions_batch(self):
        cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
        batches = [SyntheticLM(cfg, host_index=i, host_count=4).get_batch(0)
                   ["tokens"] for i in range(4)]
        assert all(b.shape == (2, 16) for b in batches)
        assert not np.array_equal(batches[0], batches[1])
        with pytest.raises(ValueError):
            SyntheticLM(cfg, host_count=3)

    def test_learnable_structure(self):
        cfg = DataConfig(vocab_size=64, seq_len=512, global_batch=8, seed=1)
        toks = SyntheticLM(cfg).get_batch(0)["tokens"]
        c = Counter(zip(toks[:, :-1].ravel().tolist(),
                        toks[:, 1:].ravel().tolist()))
        assert c.most_common(1)[0][1] > 3


class TestLayers:
    @pytest.mark.parametrize("masked", [False, True])
    def test_cross_entropy_loss(self, masked):
        rng = np.random.default_rng(0)
        logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
        labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
        mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked \
            else None
        want = RL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     mask=None if mask is None
                                     else jnp.asarray(mask))
        got = PL.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            mask=None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)

    def test_cross_entropy_all_masked_is_zero(self):
        logits = torch.randn(2, 3, 5)
        labels = torch.zeros(2, 3, dtype=torch.int32)
        assert float(PL.cross_entropy_loss(logits, labels,
                                           mask=torch.zeros(2, 3))) == 0.0

    def test_layer_norm_and_gelu_mlp(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 5, 16)).astype(np.float32)
        w, bias = (rng.standard_normal(16).astype(np.float32)
                   for _ in range(2))
        np.testing.assert_allclose(
            PL.layer_norm(*map(torch.from_numpy, (x, w, bias))).numpy(),
            np.asarray(RL.layer_norm(x, w, bias)), rtol=1e-5, atol=1e-5)
        w_up = rng.standard_normal((16, 32)).astype(np.float32) / 4
        b_up = rng.standard_normal(32).astype(np.float32)
        w_dn = rng.standard_normal((32, 16)).astype(np.float32) / 6
        b_dn = rng.standard_normal(16).astype(np.float32)
        args = (x, w_up, b_up, w_dn, b_dn)
        np.testing.assert_allclose(
            PL.gelu_mlp(*map(torch.from_numpy, args)).numpy(),
            np.asarray(RL.gelu_mlp(*args)), rtol=1e-5, atol=1e-5)

    def test_grad_fence_and_cast_gradients_keep_dtypes(self):
        # the reference's grad_fence casts the cotangent to the primal's
        # dtype; autograd does that for every cast already
        x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn(8, 4, requires_grad=True)          # float32 leaf
        assert PL.grad_fence(x) is x
        y = PL.dense(PL.grad_fence(x), w).float()
        y.square().sum().backward()
        assert x.grad.dtype == torch.bfloat16
        assert w.grad.dtype == torch.float32


class TestLossAndGrads:
    @pytest.mark.parametrize("arch", TRAIN_ARCHS)
    def test_loss_and_every_gradient_leaf(self, arch):
        cfg, pcfg, params, npp = _both(arch)
        batch = RSyntheticLM(RDataConfig(**_data_cfg(cfg))).get_batch(0)
        (want, parts), g_ref = jax.value_and_grad(
            lambda p: RM.loss_fn(cfg, p, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
            has_aux=True)(params)
        loss, got_parts, grads = _port_grads(pcfg, npp, batch)
        np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got_parts["ce"]),
                                   float(parts["ce"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(got_parts["aux"]),
                                   float(parts["aux"]), rtol=LOSS_RTOL,
                                   atol=1e-7)
        ref = dict(_walk(jax.tree.map(np.asarray, g_ref)))
        assert sorted(ref) == sorted(grads)
        for path, g in grads.items():
            r = ref[path]
            assert tuple(g.shape) == r.shape and g.dtype == torch.float32
            diff = np.linalg.norm(g.numpy() - r)
            assert diff <= GRAD_REL * np.linalg.norm(r), (path, diff)
        if cfg.ffn == "moe":        # the router's aux term reaches router_w
            assert any(np.linalg.norm(grads[p].numpy()) > 0
                       for p in grads if p[-1] == "router")

    @pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-small"])
    def test_remat_on_and_off_bit_equal(self, arch):
        cfg, pcfg, _, npp = _both(arch)
        assert pcfg.remat
        batch = RSyntheticLM(RDataConfig(**_data_cfg(cfg))).get_batch(1)
        on = _port_grads(pcfg, npp, batch)
        off = _port_grads(dataclasses.replace(pcfg, remat=False), npp, batch)
        assert torch.equal(on[0], off[0])
        for path in on[2]:
            assert torch.equal(on[2][path], off[2][path]), path


class TestTrainStep:
    @pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
    def test_three_steps_match_reference_losses(self, arch):
        cfg, pcfg, params, npp = _both(arch)
        kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
        r_step = jax.jit(r_make_train_step(cfg, RA.AdamWConfig(**kw)))
        p_step = PS.make_train_step(pcfg, PA.AdamWConfig(**kw))
        data = RSyntheticLM(RDataConfig(**_data_cfg(cfg)))
        r_opt = RA.init(RA.AdamWConfig(**kw), params)
        pp = params_from_numpy(npp, device=CPU)
        p_opt = PA.init(PA.AdamWConfig(**kw), pp)
        for step in range(3):
            batch = data.get_batch(step)
            params, r_opt, rm = r_step(params, r_opt,
                                       {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            pp, p_opt, pm = p_step(pp, p_opt, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
            assert sorted(pm) == sorted(rm)
            for key in ("loss", "ce", "grad_norm", "lr"):
                np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                           rtol=STEP_LOSS_RTOL, err_msg=key)
        assert int(p_opt["step"]) == int(r_opt["step"]) == 3

    def test_mesh_is_refused(self, monkeypatch):
        """``cuda`` with several cards visible builds the reference's
        ``(n // mp, mp)`` ``("data", "model")`` mesh over them (the name
        is kept from when it was refused); ``cuda:<i>`` and ``cpu`` train
        on one device."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for n, mp, shape in ((2, 16, (1, 2)), (8, 16, (1, 8)), (8, 2, (4, 2)),
                             (8, 3, (2, 3))):
            monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
            mesh = PT.build_mesh(torch.device("cuda"), mp)
            assert mesh.devices.shape == shape
            assert mesh.axis_names == ("data", "model")
            assert [str(d) for d in mesh.devices.flat] == [
                f"cuda:{i}" for i in range(np.prod(shape))]
            assert PT.build_mesh(torch.device("cuda", 0), mp) is None
            assert PT.build_mesh(torch.device("cpu"), mp) is None
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert PT.build_mesh(torch.device("cuda")) is None

    def test_make_train_step_takes_a_mesh(self):
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.sharding import params_shardings, shard_tree
        cfg = PC.reduced_config(PC.get_config("qwen3-1.7b"))
        opt_cfg = PA.AdamWConfig()
        mesh = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
        params = shard_tree(PM.init_params(cfg, 0, device=CPU),
                            params_shardings(cfg, mesh))
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
            **_data_cfg(cfg, batch=4))).get_batch(0).items()}
        _, opt, m = PS.make_train_step(cfg, opt_cfg, mesh)(
            params, PA.init(opt_cfg, params), batch)
        assert np.isfinite(float(m["loss"])) and int(opt["step"]) == 1


class TestAbstract:
    @pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-small"])
    def test_abstract_params_and_train_state(self, arch):
        pcfg = PC.reduced_config(PC.get_config(arch))
        cfg = RC.reduced_config(RC.get_config(arch))
        got = PM.abstract_params(pcfg)
        want = RM.abstract_params(cfg)
        ref = dict(_walk(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                                      want, is_leaf=lambda s: hasattr(
                                          s, "shape"))))
        flat = dict(_walk(got))
        assert sorted(flat) == sorted(ref)
        for path, t in flat.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) \
                == (tuple(ref[path][0]), ref[path][1])
        params, opt = PS.abstract_train_state(pcfg, PA.AdamWConfig())
        assert all(t.device.type == "meta" for _, t in _walk(opt["m"]))
        assert opt["step"].dtype == torch.int32


class TestCLI:
    def test_loss_falls_over_30_steps(self, tmp_path, capsys):
        out = tmp_path / "m.json"
        hist = PT.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "30",
                        "--batch", "4", "--seq", "32", "--device", CPU,
                        "--metrics-out", str(out)])
        losses = [h["loss"] for h in hist]
        assert len(losses) == 30 and np.all(np.isfinite(losses))
        assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
        import json
        rows = json.loads(out.read_text())
        assert [sorted(r) for r in rows[:1]] == [
            ["aux", "ce", "dt", "grad_norm", "loss", "lr", "step"]]
        assert "flash_attention=0 flash_attention_bwd=0" in \
            capsys.readouterr().out

    def test_resume_equals_uninterrupted(self, tmp_path):
        # both runs stay inside the 10-step warmup, where the schedule does
        # not depend on --steps
        base = ["--arch", "gemma2-2b", "--reduced", "--batch", "2", "--seq",
                "16", "--device", CPU]
        whole = PT.main(base + ["--steps", "6", "--ckpt-dir",
                                str(tmp_path / "whole")])
        cut = str(tmp_path / "cut")
        first = PT.main(base + ["--steps", "3", "--ckpt-dir", cut])
        assert pckpt.latest_step(cut) == 3
        rest = PT.main(base + ["--steps", "6", "--ckpt-dir", cut])
        assert [h["step"] for h in rest] == [3, 4, 5]
        assert [h["loss"] for h in first + rest] == \
            [h["loss"] for h in whole]
        template = {"params": PM.abstract_params(PC.reduced_config(
            PC.get_config("gemma2-2b")))}
        a, _ = pckpt.restore(str(tmp_path / "whole"), template, device=CPU)
        b, _ = pckpt.restore(cut, template, device=CPU)
        for (path, x), (_, y) in zip(_walk(a), _walk(b)):
            assert torch.equal(x, y), path

    def test_example_trains_on_the_host(self, tmp_path):
        """``examples/train_lm_torch.py``, the port's twin of
        ``examples/train_lm.py``: a few reduced steps with ``--device
        cpu`` into ``tmp_path``; the script asserts that the loss fell."""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        r = subprocess.run(
            [sys.executable, os.path.join(root, "examples",
                                          "train_lm_torch.py"),
             "--steps", "12", "--batch", "4", "--seq", "32", "--device",
             CPU, "--out-dir", str(tmp_path)], capture_output=True,
            text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "training reduced loss" in r.stdout
        with open(tmp_path / "example_torch_train_metrics.json") as f:
            hist = json.load(f)
        assert len(hist) == 12 and hist[-1]["loss"] < hist[0]["loss"]
        assert pckpt.latest_step(str(tmp_path / "example_torch_ckpt")) == 12

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PT.main(["--reduced", "--steps", "1"])

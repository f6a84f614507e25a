"""Port parity, checkpoints and the fault-tolerance runtime:
``repro_torch.checkpoint.manager`` and ``repro_torch.runtime.elastic`` on
the CPU against ``repro``.

* the reference's ``TestCheckpoint`` cases on the port (round trip with
  extras, the ``latest`` pointer, a specific step, a missing leaf, no torn
  checkpoint when a write fails);
* a reduced qwen3-1.7b training state (params, AdamW m / v and the step
  counter) saved by either package and restored by the other, bit-equal,
  with the same files, keys and manifest;
* bfloat16 leaves, ``meta`` templates and ``device=``;
* the reference's ``TestRuntime`` and ``tests/test_elastic.py`` cases:
  ``retry``'s backoff (``TRANSIENT`` is ``OSError`` and
  ``torch.AcceleratorError``), ``StepWatchdog``, ``ElasticPlan`` and its
  mesh.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.models.model as PM
from repro.checkpoint import manager as rckpt
from repro.optim import adamw as RA
from repro_torch.checkpoint import manager as ckpt
from repro_torch.models.params import _walk, params_from_numpy
from repro_torch.optim import adamw as PA
from repro_torch.runtime.elastic import (TRANSIENT, ElasticPlan,
                                         StepWatchdog, retry)

CPU = "cpu"


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"w": torch.arange(6.0).reshape(2, 3),
                "nested": {"b": torch.ones(4, dtype=torch.int32)}}
        ckpt.save(str(tmp_path), 7, tree, extras={"note": "hi"})
        restored, manifest = ckpt.restore(str(tmp_path), tree)
        assert manifest["step"] == 7
        assert manifest["extras"]["note"] == "hi"
        assert torch.equal(restored["w"], tree["w"])
        assert restored["nested"]["b"].dtype == torch.int32
        assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])

    def test_latest_pointer_and_multiple_steps(self, tmp_path):
        tree = {"w": torch.zeros(2)}
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, {"w": torch.ones(2)})
        assert ckpt.latest_step(str(tmp_path)) == 2
        restored, _ = ckpt.restore(str(tmp_path), tree)
        assert restored["w"].tolist() == [1, 1]

    def test_restore_specific_step(self, tmp_path):
        tree = {"w": torch.zeros(2)}
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, {"w": torch.ones(2)})
        restored, _ = ckpt.restore(str(tmp_path), tree, step=1)
        assert restored["w"].tolist() == [0, 0]

    def test_missing_leaf_raises(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"w": torch.zeros(2)})
        with pytest.raises(KeyError):
            ckpt.restore(str(tmp_path), {"w": torch.zeros(2),
                                         "extra": torch.zeros(1)})

    def test_no_checkpoint_raises(self, tmp_path):
        assert ckpt.latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore(str(tmp_path), {"w": torch.zeros(2)})

    def test_no_torn_checkpoint_on_failure(self, tmp_path, monkeypatch):
        tree = {"w": torch.zeros(2)}
        ckpt.save(str(tmp_path), 1, tree)

        def boom(*a, **k):
            raise RuntimeError("disk died")
        monkeypatch.setattr(ckpt.np, "savez", boom)
        with pytest.raises(RuntimeError):
            ckpt.save(str(tmp_path), 2, tree)
        assert ckpt.latest_step(str(tmp_path)) == 1
        assert not any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
        ckpt.restore(str(tmp_path), tree)

    def test_bfloat16_meta_template_and_device(self, tmp_path):
        tree = {"m": torch.randn(3, 4).to(torch.bfloat16),
                "step": torch.tensor(5, dtype=torch.int32)}
        ckpt.save(str(tmp_path), 5, tree)
        manifest = json.loads((tmp_path / "step_5" / "manifest.json")
                              .read_text())
        assert manifest["keys"] == {"m": [[3, 4], "bfloat16"],
                                    "step": [[], "int32"]}
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in tree.items()}
        with pytest.raises(ValueError, match="device="):
            ckpt.restore(str(tmp_path), meta)
        restored, _ = ckpt.restore(str(tmp_path), meta, device=CPU)
        assert restored["m"].dtype == torch.bfloat16
        assert torch.equal(restored["m"], tree["m"])
        assert int(restored["step"]) == 5


def _state(arch="qwen3-1.7b"):
    """A reduced training state after a few updates, in both packages."""
    cfg = RC.reduced_config(RC.get_config(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(3))
    r_cfg, p_cfg = RA.AdamWConfig(), PA.AdamWConfig()
    grads = jax.tree.map(lambda x: 0.1 * jnp.ones_like(x), params)
    opt = RA.init(r_cfg, params)
    for _ in range(2):
        params, opt, _ = RA.update(r_cfg, grads, opt, params)
    pp = params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    popt = {"m": params_from_numpy(jax.tree.map(np.asarray, opt["m"]),
                                   device=CPU),
            "v": params_from_numpy(jax.tree.map(np.asarray, opt["v"]),
                                   device=CPU),
            "step": torch.tensor(int(opt["step"]), dtype=torch.int32)}
    return {"params": params, "opt": opt}, {"params": pp, "opt": popt}


class TestCrossPackage:
    def test_port_writes_reference_reads(self, tmp_path):
        ref_tree, port_tree = _state()
        ckpt.save(str(tmp_path), 2, port_tree, extras={"arch": "qwen3-1.7b"})
        template = jax.tree.map(jnp.zeros_like, ref_tree)
        got, manifest = rckpt.restore(str(tmp_path), template)
        assert manifest["step"] == 2 and manifest["extras"]["arch"] == \
            "qwen3-1.7b"
        want = jax.tree.map(np.asarray, ref_tree)
        for (p, a), (q, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert p == q and a.dtype == b.dtype
            assert np.asarray(a).tobytes() == b.tobytes(), p

    def test_reference_writes_port_reads(self, tmp_path):
        ref_tree, port_tree = _state()
        rckpt.save(str(tmp_path), 2, ref_tree)
        template = {"params": PM.abstract_params(PC.reduced_config(
            PC.get_config("qwen3-1.7b")))}
        template["opt"] = PA.init(PA.AdamWConfig(), template["params"])
        got, manifest = ckpt.restore(str(tmp_path), template, device=CPU)
        assert manifest["step"] == 2 and ckpt.latest_step(str(tmp_path)) == 2
        flat = dict(_walk(got))
        assert sorted(flat) == sorted(dict(_walk(port_tree)))
        for path, want in _walk(port_tree):
            assert flat[path].dtype == want.dtype
            assert torch.equal(flat[path], want), path

    def test_same_layout_and_manifest(self, tmp_path):
        ref_tree, port_tree = _state()
        rckpt.save(str(tmp_path / "r"), 2, ref_tree, extras={"a": 1})
        ckpt.save(str(tmp_path / "p"), 2, port_tree, extras={"a": 1})
        for d in ("r", "p"):
            assert sorted(os.listdir(tmp_path / d)) == ["latest", "step_2"]
            assert (tmp_path / d / "latest").read_text() == "step_2"
        mr, mp = (json.loads((tmp_path / d / "step_2" / "manifest.json")
                             .read_text()) for d in ("r", "p"))
        assert mr == mp
        with np.load(tmp_path / "r" / "step_2" / "arrays.npz") as a, \
                np.load(tmp_path / "p" / "step_2" / "arrays.npz") as b:
            assert a.files == b.files
            assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


class _Flaky:
    """Fails ``n_fail`` times with ``exc`` before succeeding."""

    def __init__(self, n_fail, exc=OSError):
        self.n_fail, self.exc, self.calls = n_fail, exc, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= self.n_fail:
            raise self.exc(f"transient #{self.calls}")
        return (args, kwargs)


class TestRetry:
    def test_backoff_schedule_doubles_from_base(self, monkeypatch):
        slept = []
        monkeypatch.setattr("time.sleep", slept.append)
        fn = _Flaky(3)
        retry(fn, retries=3, base_delay=0.5)
        assert fn.calls == 4 and slept == [0.5, 1.0, 2.0]

    def test_exhausted_retries_reraise(self, monkeypatch):
        slept = []
        monkeypatch.setattr("time.sleep", slept.append)
        fn = _Flaky(5)
        with pytest.raises(OSError):
            retry(fn, retries=2, base_delay=0.25)
        assert fn.calls == 3 and slept == [0.25, 0.5]

    def test_on_error_sees_exception_and_attempt(self, monkeypatch):
        monkeypatch.setattr("time.sleep", lambda s: None)
        seen = []
        retry(_Flaky(2), retries=3, base_delay=0.1,
              on_error=lambda e, attempt: seen.append((str(e), attempt)))
        assert seen == [("transient #1", 0), ("transient #2", 1)]

    def test_non_transient_error_propagates_immediately(self, monkeypatch):
        slept = []
        monkeypatch.setattr("time.sleep", slept.append)
        fn = _Flaky(1, exc=ValueError)
        with pytest.raises(ValueError):
            retry(fn, retries=3)
        assert fn.calls == 1 and slept == []

    def test_cuda_runtime_error_is_transient(self, monkeypatch):
        monkeypatch.setattr("time.sleep", lambda s: None)
        assert TRANSIENT == (torch.AcceleratorError, OSError)
        fn = _Flaky(1, exc=torch.AcceleratorError)
        assert retry(fn, 7, retries=1, x=1) == ((7,), {"x": 1})


class TestRuntime:
    def test_watchdog_flags_straggler(self):
        w = StepWatchdog(factor=3.0, min_samples=5)
        for i in range(10):
            assert w.observe(i, 1.0) is None
        ev = w.observe(10, 10.0)
        assert ev is not None and ev.step == 10 and w.events == [ev]

    def test_watchdog_boundary_window_and_min_samples(self):
        wd = StepWatchdog(factor=3.0, window=4, min_samples=2)
        assert wd.observe(0, 100.0) is None            # below min_samples
        wd.observe(1, 1.0)
        for step in range(2, 6):
            wd.observe(step, 1.0)
        assert wd.observe(6, 3.0) is None               # exactly 3x: not >
        ev = wd.observe(7, 10.0)          # window [1, 1, 3, 10]: median 2
        assert ev is not None and ev.median == pytest.approx(2.0)

    def test_elastic_plan(self):
        p = ElasticPlan.plan(240, 16)
        assert (p.data, p.model) == (15, 16)
        assert (ElasticPlan.plan(19, 4).data, ElasticPlan.plan(19, 4).model) \
            == (4, 4)
        with pytest.raises(RuntimeError, match="cannot restart"):
            ElasticPlan.plan(8, 16)

    def test_elastic_plan_mesh(self):
        mesh = ElasticPlan.plan(6, 2).make_mesh([CPU] * 6)
        assert mesh.axis_names == ("data", "model")
        assert mesh.devices.shape == (3, 2)

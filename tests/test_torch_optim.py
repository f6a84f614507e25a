"""Port parity, the optimizer: ``repro_torch.optim.adamw`` on the CPU
against ``repro.optim.adamw``.

* ``schedule`` over steps 0-300 at four configs, within 1e-7 relative
  (the float32 operations are the reference's; the cosine is the C
  library's, which XLA's CPU backend calls, so the values are equal);
* ``update`` on identical gradients from an identical state, float32 and
  bfloat16 m/v, with and without clipping: params, m, v, the gradient norm
  and the rate within 1e-6 (the elementwise float32 ops are the
  reference's; only the global norm sums in another order);
* the reference's ``TestAdamW`` cases; the update is in place (the params
  and m/v tensors are the ones passed in) and the step counter stays on
  the host.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as RA
from repro_torch.models.params import _walk
from repro_torch.optim import adamw as PA

SCHEDULE_RTOL = 1e-7
UPDATE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _reference_default_numerics():
    """The reference at its default numerics, x64 off (the conftest turns
    x64 on for the float64 sparse paths, which would widen the reference's
    float32 schedule and updates to float64)."""
    with jax.enable_x64(False):
        yield


def _cfgs(state_dtype=None, **kw):
    r = RA.AdamWConfig(**kw, **({} if state_dtype is None else
                                {"state_dtype": state_dtype[0]}))
    p = PA.AdamWConfig(**kw, **({} if state_dtype is None else
                                {"state_dtype": state_dtype[1]}))
    return r, p


@pytest.mark.parametrize("kw", [dict(lr=3e-3, warmup_steps=15,
                                     total_steps=300),
                                dict(lr=3e-3, warmup_steps=10,
                                     total_steps=300),
                                dict(),
                                dict(lr=1.0, warmup_steps=0,
                                     total_steps=100)])
def test_schedule_matches_reference(kw):
    r, p = _cfgs(**kw)
    want = np.array([float(RA.schedule(r, s)) for s in range(301)])
    got = np.array([float(PA.schedule(p, s)) for s in range(301)])
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
    assert PA.schedule(p, torch.tensor(7, dtype=torch.int32)).dtype == \
        torch.float32


def _tree(rng):
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((3, 2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("grad_scale", [0.01, 100.0],
                         ids=["unclipped", "clipped"])
def test_update_matches_reference(dtypes, grad_scale):
    r, p = _cfgs(dtypes, lr=0.1, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = RA.init(r, jp)
    tp = jax.tree.map(torch.tensor, params)
    ts = PA.init(p, tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: grad_scale * x, _tree(rng))
        jp, js, jm = RA.update(r, jax.tree.map(jnp.asarray, g), js, jp)
        before = [t for _, t in _walk(tp)]
        tp, ts, tm = PA.update(p, jax.tree.map(torch.tensor, g), ts, tp)
        assert all(a is b for a, b in zip(before, (t for _, t in _walk(tp))))
        for key in ("params", "m", "v"):
            got = dict(_walk(tp if key == "params" else ts[key]))
            want = dict(_walk(jax.tree.map(
                lambda x: np.asarray(x, np.float32),
                jp if key == "params" else js[key])))
            for path, t in got.items():
                assert t.dtype == (torch.float32 if key == "params"
                                   else dtypes[1])
                np.testing.assert_allclose(t.float().numpy(), want[path],
                                           rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                           err_msg=f"{key} {path}")
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=UPDATE_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32 and ts["step"].device.type == "cpu"


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    np.testing.assert_allclose(
        float(PA.global_norm(jax.tree.map(torch.tensor, tree))),
        float(RA.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=UPDATE_TOL)


class TestAdamW:
    """The reference's ``tests/test_substrate.py::TestAdamW`` cases."""

    def _params(self):
        return {"a": torch.ones((4, 4)), "b": {"c": torch.ones((3,))}}

    def test_descends_quadratic(self):
        cfg = PA.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                             total_steps=100)
        p = {"x": torch.tensor([5.0, -3.0])}
        s = PA.init(cfg, p)
        for _ in range(60):
            p, s, _ = PA.update(cfg, {"x": 2 * p["x"]}, s, p)
        assert float(p["x"].abs().max()) < 1.0

    def test_clipping(self):
        cfg = PA.AdamWConfig(clip_norm=1.0, warmup_steps=0)
        p = self._params()
        s = PA.init(cfg, p)
        g = {"a": 1e6 * torch.ones((4, 4)), "b": {"c": 1e6 * torch.ones(3)}}
        _, _, m = PA.update(cfg, g, s, p)
        assert float(m["grad_norm"]) > 1e6          # reported pre-clip

    def test_schedule_warmup_and_decay(self):
        cfg = PA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
        assert float(PA.schedule(cfg, 5)) == pytest.approx(0.5)
        assert float(PA.schedule(cfg, 10)) == pytest.approx(1.0)
        assert float(PA.schedule(cfg, 100)) == pytest.approx(0.1)

    def test_bf16_state_dtype(self):
        cfg = PA.AdamWConfig(state_dtype=torch.bfloat16)
        s = PA.init(cfg, self._params())
        assert s["m"]["a"].dtype == torch.bfloat16
        assert s["v"]["b"]["c"].dtype == torch.bfloat16

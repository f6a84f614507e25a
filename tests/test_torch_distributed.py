"""Port parity, sharded training: ``repro_torch``'s parameter shardings,
sharded train step, int8 cross-pod compressed step, GPipe pipeline,
resharding checkpoints and elastic restore on the CPU against ``repro``.

One module-scoped subprocess runs the reference at 8 forced host devices
(``--xla_force_host_platform_device_count=8``, as ``test_distributed.py``
does), x64 off; the port's meshes are of repeated ``cpu`` devices
(``launch.mesh.make_mesh``).  Params cross over as numpy trees
(``params_from_numpy``).  What is held against what:

* ``param_pspecs`` / ``params_pspecs`` equal to the reference's specs, as
  tuples, for all ten archs (published and reduced configs) on the meshes
  ``(4, 2)``, ``(3, 2)``, ``(2, 2, 2)`` with ``pod``, and ``(1, 1)``;
  ``batch_spec`` and ``constrain``'s resolved specs likewise, and under the
  compressed step's manual ``pod`` axis;
* the sharded step on ``(4, 2)`` for reduced qwen3-1.7b, dbrx-132b and
  rwkv6-1.6b, on the tensor-parallel route (each model position on its
  slice, the loss vocabulary-parallel), against the reference's sharded
  step at ``test_distributed.py``'s tolerances (loss 1e-3; params rtol
  2e-2, atol 2e-3), and against the port's one-device step: the loss,
  ``ce``, ``aux`` and the gradient norm within 1e-5 relative and each
  gradient leaf within 1e-5 of its norm (only the order of the gradient
  sums differs) (``_torch_parity.hold_sharded_step``; the other families
  and ``(2, 4)`` in ``test_torch_train_mesh_ref.py``);
* ``ef_compress_leaf`` bit-equal to the reference's, ties included; the
  compressed step on ``(2, 2, 2)`` against the reference's (the loss, the
  params, the error buffer read whole, which is the first pod's), and
  three steps in a row with each pod's buffer held to the reference's
  pod's (the devices of each pod read their own buffer back);
* ``pipeline_apply`` against the reference's and the sequential result at
  1e-5, forward and gradient;
* checkpoints: saved sharded on ``(4, 2)``, restored onto ``(3, 2)``
  bit-equal, each package reading the other's file; ``elastic_restore`` on
  6 repeated devices;
* the train loop (``train.train(cfg, args, mesh=...)``) on ``(2, 2)`` for 3
  steps into a checkpoint, resumed onto ``(1, 2)``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_parity import hold_sharded_step

import repro_torch.configs as PC
from repro_torch.checkpoint import manager as pckpt
from repro_torch.launch import steps as PS
from repro_torch.launch import train as PT
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as PM
from repro_torch.models.params import _walk, params_from_numpy
from repro_torch.optim import adamw as PA
from repro_torch.parallel import api as PAPI
from repro_torch.parallel import compression as PCOMP
from repro_torch.parallel import sharding as S
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.tensor_parallel import tp_route
from repro_torch.runtime.elastic import elastic_restore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "3x2": ((3, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
STEP_ARCHS = ["qwen3-1.7b", "dbrx-132b", "rwkv6-1.6b"]
BATCHES = [(b, extra) for b in (1, 2, 3, 4, 6, 8, 16) for extra in (0, 1, 2)]
# the five call sites' names (models/model.py, models/moe.py) at shapes
# that divide the meshes' axes and shapes that do not
CONSTRAIN_CASES = [
    ((8, 32, 256), ("dp", None, "vocab")), ((6, 32, 255), ("dp", None,
                                                           "vocab")),
    ((8, 32, 64), ("dp", None, None)), ((3, 32, 64), ("dp", None, None)),
    ((8, 4, 10, 64), ("dp", "experts", None, None)),
    ((2, 3, 10, 64), ("dp", "experts", None, None)),
    ((4, 16), ("model", "data")), ((4, 16), ("nope", "layers")),
    ((8, 32), ("dp", None, None))]
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)
# the sharded step against the port's one-device step
STEP_RTOL = 1e-5
# test_distributed.py's tolerances
REF_LOSS, REF_RTOL, REF_ATOL, COMP_ATOL = 1e-3, 2e-2, 2e-3, 5e-2
# compressed steps in a row; a pod's error buffer against the reference's
# pod's: each element within one quantum (the pod's payload scale of that
# leaf at that step), and all but this share of them within 1e-6 when both
# packages step from the same params and AdamW state (the rest: a payload
# that rounded the other way, and that difference carried into the next
# step's residual)
COMP_STEPS, COMP_FLIP_SHARE = 3, 1e-4
PIPE_TOL = 1e-5
PIPE = dict(n_stage=4, n_micro=8, mb=2, d=16)

_REF_SCRIPT = r"""
import os, pickle, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import manager as ckpt
from repro.configs import ARCHS, get_config, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import make_train_step
from repro.models import model as M
from repro.optim import adamw
from repro.parallel import sharding as S
from repro.parallel.api import constrain, use_mesh
from repro.parallel.compression import (ef_compress_leaf, init_error_state,
                                        make_compressed_train_step)
from repro.parallel.pipeline import pipeline_apply

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"n_devices": len(jax.devices())}
meshes = {k: make_mesh(*v) for k, v in inp["meshes"].items()}
to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
spec = lambda s: tuple(s)
is_spec = lambda s: isinstance(s, P)

out["specs"] = {}
for arch in ARCHS:
    for red in (False, True):
        cfg = get_config(arch)
        cfg = reduced_config(cfg) if red else cfg
        for name, mesh in meshes.items():
            out["specs"][arch, red, name] = jax.tree.map(
                spec, S.params_pspecs(cfg, mesh), is_leaf=is_spec)
out["batch"] = {(name, b, e): spec(S.batch_spec(mesh, b, e))
                for name, mesh in meshes.items() for b, e in inp["batches"]}

captured = []
wsc = jax.lax.with_sharding_constraint
jax.lax.with_sharding_constraint = \
    lambda x, s: (captured.append((tuple(x.shape), spec(s.spec))), x)[1]
out["constrain"] = {}
for name, mesh in meshes.items():
    with use_mesh(mesh):
        for shape, names in inp["constrain"]:
            captured.clear()
            constrain(jnp.zeros(shape), *names)
            out["constrain"][name, shape, names] = \
                captured[0][1] if captured else None

opt_cfg = adamw.AdamWConfig(**inp["opt"])
rng = np.random.default_rng(0)
mesh = meshes["4x2"]
out["steps"] = {}
for arch in inp["step_archs"]:
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    opt = adamw.init(opt_cfg, params)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32))}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p1, _, m1 = jax.jit(make_train_step(cfg, opt_cfg))(params, opt, jb)
    psh = S.params_shardings(cfg, mesh)
    osh = {"m": psh, "v": psh, "step": NamedSharding(mesh, P())}
    step = jax.jit(make_train_step(cfg, opt_cfg, mesh),
                   in_shardings=(psh, osh, None),
                   out_shardings=(psh, osh, None))
    p2, _, m2 = step(jax.device_put(params, psh), jax.device_put(opt, osh),
                     jb)
    out["steps"][arch] = dict(params=to_np(params), batch=batch,
                              single=(to_np(p1), to_np(m1)),
                              sharded=(to_np(p2), to_np(m2)))

g, e = inp["ef"]
out["ef"] = [np.asarray(a) for a in ef_compress_leaf(jnp.asarray(g),
                                                     jnp.asarray(e))]

cfg = reduced_config(get_config("qwen3-1.7b"))
params = M.init_params(cfg, jax.random.PRNGKey(0))
opt = adamw.init(opt_cfg, params)
jb = {k: jnp.asarray(v) for k, v in out["steps"]["qwen3-1.7b"]["batch"].items()}
pod_mesh = meshes["2x2x2"]
captured.clear()

def pod_copy(a, pod):
    # the copy of a leaf declared replicated that pod ``pod``'s devices hold
    ids = {d.id for d in pod_mesh.devices[pod].flat}
    got = np.full(a.shape, np.nan, np.float32)
    for s in a.addressable_shards:
        if s.device.id in ids:
            got[s.index] = np.asarray(s.data, np.float32)
    return got

with pod_mesh:
    step = jax.jit(make_compressed_train_step(cfg, opt_cfg, pod_mesh))
    p_c, o_c, err, m_c = step(params, opt, init_error_state(params), jb)
    out["compressed"] = dict(
        params=to_np(p_c), metrics=to_np(m_c), err=to_np(err),
        err_pod1=jax.tree.map(lambda a: np.asarray(
            [s.data for s in a.addressable_shards if s.device.id == 4][0]),
            err))
    # the steps that follow read back each pod's own buffer
    out["compressed_steps"] = []
    for i in range(inp["comp_steps"]):
        if i:
            p_c, o_c, err, m_c = step(p_c, o_c, err, jb)
        out["compressed_steps"].append(dict(
            params=to_np(p_c), opt=to_np(o_c), metrics=to_np(m_c),
            err_pods=[jax.tree.map(lambda a: pod_copy(a, pod), err)
                      for pod in range(2)]))
out["constrain_pod"] = sorted(set(captured))
jax.lax.with_sharding_constraint = wsc

w, x, ct = (jnp.asarray(a) for a in inp["pipe"])
pipe_mesh = make_mesh((4, 2), ("pipe", "model"))
def pipe_loss(w, x):
    y = pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"]), {"w": w}, x,
                       mesh=pipe_mesh, axis="pipe")
    return jnp.sum(y * ct), y
with pipe_mesh:
    (_, y), (gw, gx) = jax.value_and_grad(pipe_loss, argnums=(0, 1),
                                          has_aux=True)(w, x)
out["pipe"] = [np.asarray(a) for a in (y, gw, gx)]

cfg = reduced_config(get_config("gemma2-2b"))
params = M.init_params(cfg, jax.random.PRNGKey(1))
ckpt.save(inp["ref_ckpt"], 3, {"params": jax.device_put(
    params, S.params_shardings(cfg, meshes["4x2"]))})
out["ckpt_params"] = to_np(params)
restored, manifest = ckpt.restore(
    inp["port_ckpt"], {"params": params},
    shardings={"params": S.params_shardings(cfg, meshes["3x2"])})
out["port_ckpt_read"] = (to_np(restored), manifest["step"])
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _reduced(arch):
    return PC.reduced_config(PC.get_config(arch))


def _port_ckpt_params():
    return PM.init_params(_reduced("gemma2-2b"), 7, device=CPU)


def _pipe_inputs():
    p, rng = PIPE, np.random.default_rng(5)
    w = rng.standard_normal((p["n_stage"], p["d"], p["d"])) / p["d"] ** 0.5
    x = rng.standard_normal((p["n_micro"], p["mb"], p["d"]))
    ct = rng.standard_normal((p["n_micro"], p["mb"], p["d"]))
    return [a.astype(np.float32) for a in (w, x, ct)]


def _ef_inputs():
    rng = np.random.default_rng(9)
    g = rng.standard_normal(4096).astype(np.float32)
    # g / scale lands on halves: round half to even decides these
    g[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    err = np.zeros(4096, np.float32)
    err[8:] = 1e-3 * rng.standard_normal(4088)
    return g, err


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref8")
    port_ckpt = str(tmp / "port_ckpt")
    cfg = _reduced("gemma2-2b")
    params = _port_ckpt_params()
    pckpt.save(port_ckpt, 5, {"params": S.shard_tree(
        params, S.params_shardings(cfg, _mesh("4x2")))})
    inp = dict(meshes=MESHES, batches=BATCHES, constrain=CONSTRAIN_CASES,
               opt=OPT, step_archs=STEP_ARCHS, ef=_ef_inputs(),
               comp_steps=COMP_STEPS,
               pipe=_pipe_inputs(), port_ckpt=port_ckpt,
               ref_ckpt=str(tmp / "ref_ckpt"))
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    script = tmp / "ref8.py"
    script.write_text(textwrap.dedent(_REF_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.pkl"),
                        str(tmp / "out.pkl")], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    assert out["n_devices"] == 8
    out["ref_ckpt"] = inp["ref_ckpt"]
    return out


def _flat(tree):
    return {"/".join(path): leaf for path, leaf in _walk(tree)}


def _np(t):
    return t.detach().float().numpy()


# -- specs -------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PC.ARCHS)
def test_param_specs_match_reference(ref, arch, mesh):
    for reduced in (False, True):
        cfg = _reduced(arch) if reduced else PC.get_config(arch)
        got = _flat(S.params_pspecs(cfg, _mesh(mesh)))
        assert got == _flat(ref["specs"][arch, reduced, mesh])
        shardings = _flat(S.params_shardings(cfg, _mesh(mesh)))
        assert {k: tuple(v.spec) for k, v in shardings.items()} == got


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_constrain_specs_match_reference(ref, mesh):
    m = _mesh(mesh)
    for b, extra in BATCHES:
        assert S.batch_spec(m, b, extra) == ref["batch"][mesh, b, extra]
    for shape, names in CONSTRAIN_CASES:
        want = ref["constrain"][mesh, shape, names]
        x = torch.zeros(shape)
        with PAPI.use_mesh(m):
            assert PAPI.constrain(x, *names) is x
        if len(shape) != len(names):
            assert want is None             # ignored, as the reference does
            continue
        assert PAPI.resolve_spec(shape, names, m) == want


def test_constrain_under_manual_pod_matches_reference(ref):
    """Inside the compressed step the reference's ``pod`` axis is manual:
    its constraints (the model's, captured as it traced) leave it out."""
    m = _mesh("2x2x2")
    cfg = _reduced("qwen3-1.7b")
    names = {cfg.vocab_size: ("dp", None, "vocab"),
             cfg.d_model: ("dp", None, None)}
    assert ref["constrain_pod"]
    with PAPI.manual_axes("pod"):
        for shape, want in ref["constrain_pod"]:
            assert PAPI.resolve_spec(shape, names[shape[-1]], m) == want
    assert PAPI.resolve_spec((4, 32, 64), ("dp", None, None), m) == (
        ("pod", "data"), None, None)


def test_sharded_storage_round_trip():
    m = _mesh("2x2x2")
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in [(("pod", "data"), "model", None), (None, ("data", "model")),
                 ("model", None, "pod"), (None, None, None)]:
        try:
            sh = S.shard(t, S.Sharding(m, spec))
        except ValueError:
            assert spec == (None, ("data", "model"))   # 6 over 4: refused
            continue
        assert torch.equal(S.gather(sh, CPU), t)
        if all(s is None for s in spec):
            assert sh is t
            continue
        grid = S.Sharding(m, spec).grid(3)
        assert len(sh.shards) == int(np.prod(grid))
        assert sh.shape == t.shape and sh.dtype == t.dtype
        for idx, piece in sh.shards.items():
            assert torch.equal(piece, t[sh.slices(idx)])
            assert piece.is_contiguous()
    # the shard index over (pod, data) is pod-major, as the reference's
    sh = S.shard(t, S.Sharding(m, (("pod", "data"), None, None)))
    assert [tuple(v[0, 0, :1].tolist()) for v in sh.shards.values()] == [
        (0.0,), (48.0,), (96.0,), (144.0,)]


# -- the sharded train step ----------------------------------------------------

def _captured_update(monkeypatch):
    grads = []
    update = PA.update

    def capture(cfg, g, state, params):
        grads.append(S.unshard_tree(g, CPU))
        return update(cfg, g, state, params)
    monkeypatch.setattr(PS.adamw, "update", capture)
    return grads


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_matches_reference_and_one_device(ref, arch,
                                                       monkeypatch):
    """The sharded step on the tensor-parallel route (``tp_route``)."""
    r = ref["steps"][arch]
    cfg, mesh = _reduced(arch), _mesh("4x2")
    assert tp_route(cfg, mesh)
    p2 = hold_sharded_step(r["params"], r["batch"], r["sharded"], cfg, mesh,
                           monkeypatch, opt=OPT, step_rtol=STEP_RTOL,
                           ref_loss=REF_LOSS, ref_rtol=REF_RTOL,
                           ref_atol=REF_ATOL)
    assert any(isinstance(p, S.ShardedTensor) for _, p in _walk(p2))
    for path, want in _flat(r["single"][0]).items():   # the reference's own
        np.testing.assert_allclose(_flat(r["sharded"][0])[path], want,
                                   rtol=REF_RTOL, atol=REF_ATOL)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_storage_route_matches_reference_at_a_model_axis_of_two(
        ref, arch, monkeypatch):
    """The storage-only route (each data shard on the params gathered
    whole; the route of refused widths) on ``(4, 2)``, where ``tp_route``
    would take the config, against the reference's sharded step and the
    port's one-device step at the same tolerances."""
    r = ref["steps"][arch]
    cfg, mesh = _reduced(arch), _mesh("4x2")
    assert tp_route(cfg, mesh)
    monkeypatch.setattr(PS, "tp_route", lambda c, m: False)
    p2 = hold_sharded_step(r["params"], r["batch"], r["sharded"], cfg, mesh,
                           monkeypatch, opt=OPT, step_rtol=STEP_RTOL,
                           ref_loss=REF_LOSS, ref_rtol=REF_RTOL,
                           ref_atol=REF_ATOL)
    assert any(isinstance(p, S.ShardedTensor) for _, p in _walk(p2))


def test_one_by_one_mesh_is_the_one_device_step():
    cfg = _reduced("qwen3-1.7b")
    opt_cfg = PA.AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in _synthetic(cfg, 4).items()}
    p1 = PM.init_params(cfg, 3, device=CPU)
    p1, _, m1 = PS.make_train_step(cfg, opt_cfg)(p1, PA.init(opt_cfg, p1),
                                                 batch)
    mesh = _mesh("1x1")
    p2 = S.shard_tree(PM.init_params(cfg, 3, device=CPU),
                      S.params_shardings(cfg, mesh))
    p2, _, m2 = PS.make_train_step(cfg, opt_cfg, mesh)(
        p2, PA.init(opt_cfg, p2), batch)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    for (path, a), (_, b) in zip(_walk(p1), _walk(S.unshard_tree(p2, CPU))):
        assert torch.equal(a, b), path


def test_batch_shards_follow_batch_spec():
    mesh = _mesh("2x2x2")
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3)}
    parts = PS.batch_shards(mesh, batch)
    assert len(parts) == 4
    assert torch.equal(torch.cat([p["tokens"] for _, p in parts]),
                       batch["tokens"])
    assert [len(p["tokens"]) for _, p in PS.batch_shards(
        mesh, {"tokens": torch.zeros(6, 1)})] == [3, 3]     # data only
    assert len(PS.batch_shards(mesh, {"tokens": torch.zeros(3, 1)})) == 1


# -- int8 cross-pod compression -----------------------------------------------

def test_ef_compress_leaf_bit_equal(ref):
    g, err = _ef_inputs()
    got = PCOMP.ef_compress_leaf(torch.from_numpy(g), torch.from_numpy(err))
    q, scale, new_err = ref["ef"]
    assert got[0].dtype == torch.int8 and got[0].numpy().tobytes() == \
        q.tobytes()
    assert got[1].numpy().tobytes() == scale.astype(np.float32).tobytes()
    assert got[2].numpy().tobytes() == new_err.tobytes()
    # ties to even, as jnp.round: 0.5 → 0, 1.5 → 2, 2.5 → 2, -2.5 → -2
    assert got[0][:8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_compressed_step_matches_reference(ref):
    cfg = _reduced("qwen3-1.7b")
    opt_cfg = PA.AdamWConfig(**OPT)
    r = ref["steps"]["qwen3-1.7b"]
    params = params_from_numpy(r["params"], device=CPU)
    opt = PA.init(opt_cfg, params)
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    step = PCOMP.make_compressed_train_step(cfg, opt_cfg, _mesh("2x2x2"))
    params, opt, err, m = step(params, opt, PCOMP.init_error_state(params),
                               batch)
    c = ref["compressed"]
    assert sorted(m) == sorted(c["metrics"]) == ["ce", "grad_norm", "loss",
                                                 "lr"]
    np.testing.assert_allclose(float(m["loss"]), float(c["metrics"]["loss"]),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(float(m["ce"]), float(c["metrics"]["ce"]),
                               rtol=STEP_RTOL)
    got = _flat(params)
    for path, want in _flat(c["params"]).items():
        np.testing.assert_allclose(_np(got[path]), want, rtol=0,
                                   atol=COMP_ATOL, err_msg=path)
    # the reference's exact step is within its 5e-2 of both
    for path, want in _flat(r["single"][0]).items():
        assert np.abs(_np(got[path]) - want).max() < COMP_ATOL, path
    # the error buffer read whole is the first pod's (each pod holds its
    # own, as the reference's devices of pod 1 hold pod 1's): each element
    # within one quantum of it, where a payload rounded the other way
    got_err, pod1 = _flat(err), _flat(c["err_pod1"])
    differs = False
    for path, want in _flat(c["err"]).items():
        quantum = np.abs(want).max() * 2 / 127 + 1e-12
        assert np.abs(_np(S.gather(got_err[path], CPU)) - want).max() \
            <= quantum, path
        differs |= not np.allclose(want, pod1[path])
    assert differs


def _pod_buffers(leaf) -> list:
    """Each pod's error buffer of a leaf the compressed step returned."""
    return [_np(c) for c in getattr(leaf, "copies", [leaf] * 2)]


def test_compressed_step_keeps_each_pods_error_buffer(ref, monkeypatch):
    """``COMP_STEPS`` compressed steps on ``(2, 2, 2)``: the reference's
    devices of each pod read their own pod's buffer back, so each pod adds
    back its own residual.  Run in a row, the params after each step are
    within ``COMP_ATOL`` of the reference's and each pod's buffer within
    one quantum of the reference's pod's; the buffer read whole is the
    first pod's, and the second pod's differs from it.  Stepped from the
    reference's params and AdamW state after each step, all but
    ``COMP_FLIP_SHARE`` of each pod's buffer is within 1e-6."""
    cfg = _reduced("qwen3-1.7b")
    opt_cfg = PA.AdamWConfig(**OPT)
    r = ref["steps"]["qwen3-1.7b"]
    runs = ref["compressed_steps"]
    assert len(runs) == COMP_STEPS
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    step = PCOMP.make_compressed_train_step(cfg, opt_cfg, _mesh("2x2x2"))
    scales, ef = [], PCOMP.ef_compress_leaf

    def recorded(g, e):
        q, scale, new_err = ef(g, e)
        scales.append(float(scale))
        return q, scale, new_err
    monkeypatch.setattr(PCOMP, "ef_compress_leaf", recorded)

    params = params_from_numpy(r["params"], device=CPU)
    opt = PA.init(opt_cfg, params)
    err = PCOMP.init_error_state(params)
    for k, want in enumerate(runs):
        scales.clear()
        params, opt, err, _ = step(params, opt, err, batch)
        got = _flat(params)
        for path, w in _flat(want["params"]).items():
            assert np.abs(_np(got[path]) - w).max() < COMP_ATOL, (k, path)
        leaves = _flat(err)
        assert len(scales) == 2 * len(leaves)
        differs = False
        for j, (path, leaf) in enumerate(leaves.items()):
            pods = _pod_buffers(leaf)
            assert np.array_equal(_np(S.gather(leaf, CPU)), pods[0]), path
            for i, (got_i, w) in enumerate(zip(pods, want["err_pods"])):
                quantum = scales[i * len(leaves) + j] * (1 + 1e-3)
                assert np.abs(got_i - _flat(w)[path]).max() <= quantum, \
                    (k, i, path)
            differs |= not np.allclose(pods[0], pods[1])
        assert differs, k

    err = PCOMP.init_error_state(params)
    for k, want in enumerate(runs):
        if k == 0:
            params = params_from_numpy(r["params"], device=CPU)
            opt = PA.init(opt_cfg, params)
        else:
            before = runs[k - 1]
            params = params_from_numpy(before["params"], device=CPU)
            opt = {"m": params_from_numpy(before["opt"]["m"], device=CPU),
                   "v": params_from_numpy(before["opt"]["v"], device=CPU),
                   "step": torch.tensor(int(before["opt"]["step"]),
                                        dtype=torch.int32)}
        _, _, err, _ = step(params, opt, err, batch)
        far = total = 0
        for path, leaf in _flat(err).items():
            for got_i, w in zip(_pod_buffers(leaf), want["err_pods"]):
                diff = np.abs(got_i - _flat(w)[path])
                far += int((diff > 1e-6).sum())
                total += diff.size
        assert far <= COMP_FLIP_SHARE * total, (k, far, total)


def test_compressed_reduction_dequantizes_at_the_largest_scale(
        monkeypatch):
    """The reference's first quirk, kept: each pod quantizes its gradient
    at its own scale, yet the int32 sum of the payloads is dequantized at
    the largest of the scales (then divided by the pod count)."""
    cfg = _reduced("qwen3-1.7b")
    opt_cfg = PA.AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in _synthetic(cfg, 4).items()}
    params = PM.init_params(cfg, 6, device=CPU)
    err = PCOMP.init_error_state(params)
    leaves = list(_walk(params))
    pods = [PS._loss_and_grads(cfg, [(path, p.detach()) for path, p in
                                     leaves],
                               {k: v[i * 2:(i + 1) * 2]
                                for k, v in batch.items()})[2]
            for i in range(2)]
    grads = _captured_update(monkeypatch)
    PCOMP.make_compressed_train_step(cfg, opt_cfg, _mesh("2x2x2"))(
        params, PA.init(opt_cfg, params), err, batch)
    got = dict(_walk(grads[0]))
    n_own_scale = 0
    for i, (path, _) in enumerate(leaves):
        (q0, s0), (q1, s1) = (PCOMP.quantize_int8(g[i]) for g in pods)
        want = (q0.to(torch.int32) + q1.to(torch.int32)).float() \
            * torch.maximum(s0, s1) / 2
        assert torch.equal(got[path], want), path
        n_own_scale += not torch.equal(
            want, (PCOMP.dequantize_int8(q0, s0)
                   + PCOMP.dequantize_int8(q1, s1)) / 2)
    assert n_own_scale > 0     # the quirk shows on this batch


def test_compressed_step_without_pods_is_the_plain_step():
    cfg = _reduced("qwen3-1.7b")
    opt_cfg = PA.AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in _synthetic(cfg, 4).items()}
    p1 = PM.init_params(cfg, 2, device=CPU)
    p1, _, m1 = PS.make_train_step(cfg, opt_cfg)(p1, PA.init(opt_cfg, p1),
                                                 batch)
    for name in ("4x2", "1x1"):
        p2 = PM.init_params(cfg, 2, device=CPU)
        err = PCOMP.init_error_state(p2)
        p2, _, err2, m2 = PCOMP.make_compressed_train_step(
            cfg, opt_cfg, _mesh(name))(p2, PA.init(opt_cfg, p2), err, batch)
        assert err2 is err and sorted(m2) == ["ce", "grad_norm", "loss", "lr"]
        assert float(m2["loss"]) == float(m1["loss"])
        for (path, a), (_, b) in zip(_walk(p1), _walk(p2)):
            assert torch.equal(a, b), path


# -- pipeline -------------------------------------------------------------------

def test_pipeline_matches_reference_and_sequential(ref):
    w, x, ct = (torch.from_numpy(a).requires_grad_(True)
                for a in _pipe_inputs())
    mesh = make_mesh((4, 2), ("pipe", "model"), [CPU] * 8)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                       mesh=mesh, axis="pipe")
    gw, gx = torch.autograd.grad((y * ct).sum(), [w, x])
    want_y, want_gw, want_gx = ref["pipe"]
    for got, want in ((y, want_y), (gw, want_gw), (gx, want_gx)):
        np.testing.assert_allclose(_np(got), want, rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
    seq = x
    for s in range(PIPE["n_stage"]):
        seq = torch.tanh(seq @ w[s])
    sw, sx = torch.autograd.grad((seq * ct).sum(), [w, x])
    for got, want in ((y, seq), (gw, sw), (gx, sx)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=PIPE_TOL,
                                   atol=PIPE_TOL)


# -- checkpoints and elastic restore ------------------------------------------

def test_checkpoint_reshards_onto_a_smaller_mesh(ref, tmp_path):
    cfg = _reduced("gemma2-2b")
    params = _port_ckpt_params()
    sharded = S.shard_tree(params, S.params_shardings(cfg, _mesh("4x2")))
    pckpt.save(str(tmp_path), 3, {"params": sharded})
    mesh_b = _mesh("3x2")
    restored, manifest = pckpt.restore(
        str(tmp_path), {"params": PM.abstract_params(cfg)},
        shardings={"params": S.params_shardings(cfg, mesh_b)})
    assert manifest["step"] == 3
    for path, leaf in _walk(restored["params"]):
        assert not isinstance(leaf, S.ShardedTensor) or \
            leaf.sharding.mesh is mesh_b
    want = _flat(params)
    for path, leaf in _flat(restored["params"]).items():
        assert torch.equal(S.gather(leaf, CPU), want[path]), path


def test_each_package_reads_the_others_sharded_checkpoint(ref):
    cfg = _reduced("gemma2-2b")
    got, manifest = pckpt.restore(
        ref["ref_ckpt"], {"params": PM.abstract_params(cfg)},
        shardings={"params": S.params_shardings(cfg, _mesh("3x2"))})
    assert manifest["step"] == 3
    want = _flat(ref["ckpt_params"])
    for path, leaf in _flat(got["params"]).items():
        assert S.gather(leaf, CPU).numpy().tobytes() == \
            want[path].tobytes(), path
    read, step = ref["port_ckpt_read"]
    assert step == 5
    mine = _flat(_port_ckpt_params())
    for path, arr in _flat(read["params"]).items():
        assert arr.tobytes() == mine[path].numpy().tobytes(), path


def test_elastic_restore_on_repeated_devices(tmp_path):
    cfg = _reduced("gemma2-2b")
    params = _port_ckpt_params()
    pckpt.save(str(tmp_path), 4, S.shard_tree(
        params, S.params_shardings(cfg, _mesh("4x2"))))
    mesh, tree, manifest = elastic_restore(
        str(tmp_path), cfg, PM.abstract_params(cfg), model_parallel=2,
        devices=[CPU] * 7)
    assert mesh.devices.shape == (3, 2) and mesh.axis_names == (
        "data", "model")
    assert manifest["step"] == 4
    want = _flat(params)
    n_sharded = 0
    for path, leaf in _flat(tree).items():
        n_sharded += isinstance(leaf, S.ShardedTensor)
        assert torch.equal(S.gather(leaf, CPU), want[path]), path
    assert n_sharded > 0
    # fewer devices than the model axis: the axis shrinks to fit, as the
    # reference's ``min(model_parallel, n)``
    mesh, _, _ = elastic_restore(str(tmp_path), cfg, PM.abstract_params(cfg),
                                 model_parallel=4, devices=[CPU] * 3)
    assert mesh.devices.shape == (1, 3)


# -- the train loop on a mesh ------------------------------------------------

def _synthetic(cfg, batch, seq=16, step=0):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch)).get_batch(step)


def _args(steps, ckpt_dir=""):
    return PT.parse_args(["--arch", "qwen3-1.7b", "--reduced", "--batch", "4",
                          "--seq", "16", "--steps", str(steps), "--device",
                          CPU, "--ckpt-dir", ckpt_dir, "--log-every", "1"])


def test_train_on_a_mesh_and_resume_onto_another(tmp_path):
    # the runs stay inside the 10-step warmup, where the schedule does not
    # depend on --steps
    cfg = _reduced("qwen3-1.7b")
    one = PT.train(cfg, _args(6))
    whole = PT.train(cfg, _args(6), mesh=make_mesh((2, 2), ("data", "model"),
                                                   [CPU] * 4))
    cut = str(tmp_path / "cut")
    first = PT.train(cfg, _args(3, cut), mesh=make_mesh(
        (2, 2), ("data", "model"), [CPU] * 4))
    assert pckpt.latest_step(cut) == 3
    rest = PT.train(cfg, _args(6, cut), mesh=make_mesh(
        (1, 2), ("data", "model"), [CPU] * 2))
    assert [h["step"] for h in rest] == [3, 4, 5]
    losses = [h["loss"] for h in whole]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose([h["loss"] for h in first + rest], losses,
                               rtol=1e-4)
    np.testing.assert_allclose([h["loss"] for h in one], losses, rtol=1e-4)
    # the checkpoint is the unsharded one, readable without a mesh
    tree, _ = pckpt.restore(cut, {"params": PM.abstract_params(cfg)},
                            device=CPU)
    assert all(isinstance(v, torch.Tensor) for _, v in _walk(tree))


def test_train_shardings_match_the_reference_layout():
    cfg = _reduced("dbrx-132b")
    mesh = _mesh("4x2")
    pshard, oshard, batch_shardings = PS.train_shardings(
        cfg, mesh, PA.AdamWConfig())
    assert oshard["m"] is pshard and oshard["v"] is pshard
    assert oshard["step"] is None
    specs = {"tokens": torch.zeros(8, 16), "images": torch.zeros(8, 4, 3)}
    got = batch_shardings(specs)
    assert got["tokens"] == S.Sharding(mesh, ("data", None))
    assert got["images"] == S.Sharding(mesh, ("data", None, None))
    assert all(s.mesh is mesh for _, s in _walk(pshard))

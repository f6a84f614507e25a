"""Port parity, tensor parallelism in hymba's and the encoder-decoder's
serving steps: ``repro_torch``'s sharded prefill and decode steps for the
hybrid mixer (attention and SSM heads) and whisper's encoder, decoder and
cross-attention over the model axis, on the CPU against ``repro``.

One module-scoped subprocess runs the reference at 8 forced host devices
(``--xla_force_host_platform_device_count=8``), x64 off, as
``test_torch_serve_mesh.py`` does; the port's meshes are of repeated
``cpu`` devices and the params cross over as numpy trees
(``params_from_numpy``).  What is held against what:

* the sharded prefill and 4 decode steps at batch 8 on ``(4, 2)`` and
  ``(2, 4)`` (and at batch 1 on ``(4, 2)`` for the two variants) for four
  configs (``CONFIGS``): reduced hymba-1.5b and
  whisper-small, hymba with the published ratios (25 q / 5 K/V heads of 8,
  SSM state 8, vocabulary 257, window 8: a prompt of 16 wraps the ring
  cache) and whisper with 6 heads of 8 and vocabulary 257.  Every step's
  logits and the final cache within 1e-4 of the reference's jitted steps
  on the same mesh and of the port on one device; a ``(1, 1)`` mesh
  bit-equal to one device.  Between them they split a head over
  positions, cut a GQA group in its middle (K/V heads repeated one a q
  head), replicate the vocabulary, store ``ssm_state`` and ``xk`` /
  ``xv`` replicated over ``"model"`` and wrap the ring (pinned by
  ``test_the_cases_cover_the_design``);
* hymba's fusion norms (``norm_a``, ``norm_s``) over every head's
  channels: each head's ``wv`` and ``wv_s`` columns scaled apart, the
  steps hold to the reference, and a per-shard norm departs;
* hymba's SSM projections where the reference's guard replicates them
  (state 6: 150 columns at a model axis of 4), held to one device;
* each position's gathers: its model slice of every leaf the reference
  shards over ``"model"``, at most the whole of a replicated one, never
  hymba's unread ``ssm/wo_s``;
* the dry run's hymba and whisper serving cells on the route, their
  argument bytes equal to the reference's ``memory_analysis()``.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.launch import dryrun as PD
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as PM
from repro_torch.models.params import _walk, params_from_numpy
from repro_torch.parallel import sharding as S
from repro_torch.parallel import tensor_parallel as TPP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
TP_MESHES = ["4x2", "2x4"]
# name: (arch, overrides of its reduced config)
CONFIGS = {
    "hymba-1.5b": ("hymba-1.5b", {}),
    "whisper-small": ("whisper-small", {}),
    "hymba-published-ratios": ("hymba-1.5b", dict(
        n_heads=25, n_kv_heads=5, d_head=8, ssm_state=8, vocab_size=257,
        window=8)),
    "whisper-6-heads": ("whisper-small", dict(
        n_heads=6, n_kv_heads=6, d_head=8, vocab_size=257)),
}
BATCH = 8
# the configs also served at batch 1 on (4, 2) (hymba's long_500k layout:
# one data shard, the cache's sequence over "data")
BATCH_ONE = ["hymba-published-ratios", "whisper-6-heads"]
# prompt, decode steps; the cache holds both
PROMPT, N_DEC = 16, 4
SEQ = PROMPT + N_DEC
# the one-device serving parity tests' tolerance (test_torch_models.py)
TOL = dict(rtol=1e-4, atol=1e-4)
# hymba with each head's wv and wv_s columns scaled by NORM_SCALE[j % 4]
# for head j: each model position's sum of squares differs, so a norm over
# one position's channels departs from the norm over all of them
NORM_CONFIG = "hymba-published-ratios"
NORM_SCALE = (4.0, 2.0, 0.5, 0.25)
# the dry run's cells (reduced, bfloat16 compute, seq 64, batch 8, on
# (4, 2)), as test_torch_dryrun.py's
DRY_CELLS = [("hymba-1.5b", "prefill"), ("hymba-1.5b", "decode"),
             ("whisper-small", "prefill"), ("whisper-small", "decode")]

_REF_SCRIPT = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import ShapeConfig, get_config, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import (decode_shardings, input_specs,
                                make_decode_step, make_prefill_step)
from repro.models import model as M
from repro.parallel import sharding as S

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"n_devices": len(jax.devices())}
meshes = {k: make_mesh(*v) for k, v in inp["meshes"].items()}
to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)

def config(name):
    arch, over = inp["configs"][name]
    return dataclasses.replace(reduced_config(get_config(arch)), **over)

def serve(cfg, params, b, seq, x, toks, mesh):
    pshard = S.params_shardings(cfg, mesh)
    arg = jnp.asarray(x)
    in_sh = NamedSharding(mesh, S.batch_spec(mesh, b, arg.ndim - 1))
    with mesh:
        prefill = jax.jit(make_prefill_step(cfg, b, seq, mesh),
                          in_shardings=(pshard, in_sh))
        logits, cache = prefill(jax.device_put(params, pshard), arg)
        _, cshard, tok_sh, pos_sh = decode_shardings(cfg, mesh, cache, b)
        step = jax.jit(make_decode_step(cfg, mesh),
                       in_shardings=(pshard, cshard, tok_sh, pos_sh),
                       out_shardings=(None, cshard), donate_argnums=(1,))
        seen = [np.asarray(logits, np.float32)]
        for tok, pos in toks:
            lg, cache = step(jax.device_put(params, pshard), cache,
                             jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos, jnp.int32))
            seen.append(np.asarray(lg, np.float32))
    return dict(logits=seen, cache=to_np(cache))

out["serve"] = {}
for name in inp["configs"]:
    cfg = config(name)
    params = M.init_params(cfg, jax.random.PRNGKey(3))
    for mesh in inp["tp_meshes"]:
        out["serve"][name, mesh] = serve(cfg, params, inp["batch"],
                                         inp["seq"], *inp["inputs"][name],
                                         meshes[mesh])
    out["serve"][name, "params"] = to_np(params)
    if name in inp["batch_one"]:
        x, toks = inp["inputs"][name]
        out["serve"][name, "4x2", 1] = serve(
            cfg, params, 1, inp["seq"], x[:1], [(t[:1], p) for t, p in toks],
            meshes["4x2"])

# the norm case: each head's wv and wv_s columns scaled apart
cfg = config(inp["norm_config"])

def scaled(a):
    # head j of the leaf's columns (K/V heads of wv, SSM heads of wv_s)
    # times norm_scale[j % 4]
    n = a.shape[-1] // cfg.d_head
    s = np.resize(np.asarray(inp["norm_scale"], np.float32), n)
    return a * jnp.asarray(np.repeat(s, cfg.d_head)).astype(a.dtype)
params = jax.tree_util.tree_map_with_path(
    lambda path, a: scaled(a) if path[-1].key in ("wv", "wv_s") else a,
    M.init_params(cfg, jax.random.PRNGKey(3)))
out["norm"] = dict(serve(cfg, params, inp["batch"], inp["seq"],
                         *inp["inputs"][inp["norm_config"]], meshes["4x2"]),
                   params=to_np(params))

# the dry run's argument bytes (repro.launch.dryrun._lower_compile's
# serving branches)
out["argument_bytes"] = {}
mesh = meshes["4x2"]
for arch, kind in inp["dry_cells"]:
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              compute_dtype="bfloat16")
    shape = ShapeConfig("t", kind, 64, 8)
    specs = input_specs(cfg, shape)
    params = M.abstract_params(cfg)
    pshard = S.params_shardings(cfg, mesh)
    with mesh:
        if kind == "prefill":
            arg = specs.get("tokens", specs.get("frames"))
            in_sh = NamedSharding(mesh, S.batch_spec(mesh, 8, arg.ndim - 1))
            lowered = jax.jit(make_prefill_step(cfg, 8, 64, mesh),
                              in_shardings=(pshard, in_sh)).lower(params, arg)
        else:
            _, cshard, tok_sh, pos_sh = decode_shardings(
                cfg, mesh, specs["cache"], 8)
            lowered = jax.jit(make_decode_step(cfg, mesh),
                              in_shardings=(pshard, cshard, tok_sh, pos_sh),
                              out_shardings=(None, cshard),
                              donate_argnums=(1,)).lower(
                params, specs["cache"], specs["token"], specs["pos"])
    out["argument_bytes"][arch, kind] = int(
        lowered.compile().memory_analysis().argument_size_in_bytes)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _config(name):
    arch, over = CONFIGS[name]
    return dataclasses.replace(PC.reduced_config(PC.get_config(arch)),
                               **over)


def _inputs(name):
    """The prompt (tokens, or whisper's frames) and each decode step's
    (token, position), from a seed."""
    cfg = _config(name)
    rng = np.random.default_rng(200 + sorted(CONFIGS).index(name))
    if cfg.enc_dec:
        x = rng.standard_normal((BATCH, SEQ, cfg.d_frame)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    first = 0 if cfg.enc_dec else PROMPT
    toks = [(rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32),
             first + i) for i in range(N_DEC)]
    return x, toks


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_serve_tp")
    inp = dict(meshes=MESHES, tp_meshes=TP_MESHES, configs=CONFIGS,
               batch=BATCH, seq=SEQ,
               inputs={name: _inputs(name) for name in CONFIGS},
               norm_config=NORM_CONFIG, norm_scale=NORM_SCALE,
               dry_cells=DRY_CELLS, batch_one=BATCH_ONE)
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    script = tmp / "ref_serve_tp.py"
    script.write_text(textwrap.dedent(_REF_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.pkl"),
                        str(tmp / "out.pkl")], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    assert out["n_devices"] == 8
    return out


def _flat(tree):
    return {"/".join(path): leaf for path, leaf in _walk(tree)}


def _run(cfg, params, mesh, x, toks):
    """Prefill and the decode steps on ``mesh`` (None: one device):
    ``(logits of each (whisper's first: the encoder output), final
    cache)``, gathered onto the host."""
    p = params if mesh is None else S.shard_tree(
        params, S.params_shardings(cfg, mesh))
    logits, cache = PS.make_prefill_step(cfg, x.shape[0], SEQ, mesh)(
        p, torch.from_numpy(x))
    step = PS.make_decode_step(cfg, mesh)
    seen = [S.gather(logits, CPU)]
    for tok, pos in toks:
        lg, cache = step(p, cache, torch.from_numpy(tok), pos)
        seen.append(S.gather(lg, CPU))
    return seen, {k: S.gather(v, CPU) for k, v in _flat(cache).items()}


@pytest.fixture(scope="module")
def served(ref):
    out = {}
    for name in CONFIGS:
        cfg = _config(name)
        params = params_from_numpy(ref["serve"][name, "params"], CPU)
        x, toks = _inputs(name)
        for mesh in ("one", "1x1", *TP_MESHES):
            out[name, mesh] = _run(cfg, params,
                                   None if mesh == "one" else _mesh(mesh),
                                   x, toks)
    return out


def _held(got, want, one):
    """Every step's logits and the final cache within ``TOL`` of the
    reference's (``want``) and of the one-device port's (``one``)."""
    (logits, cache), (one_logits, one_cache) = got, one
    assert len(logits) == len(want["logits"]) == len(one_logits) == N_DEC + 1
    for g, w, o in zip(logits, want["logits"], one_logits):
        np.testing.assert_allclose(g.float().numpy(), w, **TOL)
        np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)
    want_cache = _flat(want["cache"])
    assert set(cache) == set(want_cache) == set(one_cache)
    for k, v in cache.items():
        np.testing.assert_allclose(v.float().numpy(), want_cache[k], **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), one_cache[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_serving_matches_reference_and_one_device(ref, served, name, mesh):
    """The tensor-parallel route: every step's logits (whisper's prefill:
    the encoder output) and the final cache within 1e-4 of the reference's
    jitted steps on the same mesh and of one device."""
    assert TPP.tp_route(_config(name), _mesh(mesh))
    _held(served[name, mesh], ref["serve"][name, mesh], served[name, "one"])


@pytest.mark.parametrize("name", BATCH_ONE)
def test_batch_one_matches_reference_and_one_device(ref, name):
    """At batch 1 the rows do not divide the data axis: one data shard at
    the mesh's first data position, its two model positions, the cache
    stored with its sequence over ``data`` (hymba's ring too); within 1e-4
    of the reference's jitted steps on ``(4, 2)`` and of one device."""
    cfg = _config(name)
    params = params_from_numpy(ref["serve"][name, "params"], CPU)
    x, toks = _inputs(name)
    x, toks = x[:1], [(t[:1], p) for t, p in toks]
    assert len(PS.data_shards(_mesh("4x2"), 1)) == 1
    _held(_run(cfg, params, _mesh("4x2"), x, toks),
          ref["serve"][name, "4x2", 1], _run(cfg, params, None, x, toks))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_by_one_mesh_is_one_device(served, name):
    assert not TPP.tp_route(_config(name), _mesh("1x1"))
    logits, cache = served[name, "1x1"]
    one_logits, one_cache = served[name, "one"]
    assert all(torch.equal(g, w) for g, w in zip(logits, one_logits))
    assert all(torch.equal(cache[k], one_cache[k]) for k in one_cache)


def test_the_cases_cover_the_design():
    """Across ``CONFIGS`` and the two meshes: a q head split over
    positions, a position whose q heads start inside a GQA group (K/V
    repeated one a q head), a K/V head split over positions, a replicated
    vocabulary, ``ssm_state`` and ``xk`` / ``xv`` stored replicated over
    ``"model"`` (the reference's cache specs), and a ring cache that
    wraps."""
    seen = set()
    for name in CONFIGS:
        cfg = _config(name)
        for mesh in TP_MESHES:
            m = _mesh(mesh)
            size = TPP.model_size(m)
            for r in range(size):
                sl = TPP.head_slice(cfg, size, r)
                if sl.q_cols[0] % cfg.d_head or sl.q_cols[1] % cfg.d_head:
                    seen.add("split q head")
                if TPP.kv_index(cfg, sl) is not None:
                    seen.add("group cut")
                if sl.kv_cols[1] - sl.kv_cols[0] < cfg.d_head:
                    seen.add("split K/V head")
            if not TPP.vocab_split(cfg, size):
                seen.add("replicated vocabulary")
            cache = PM.init_cache(cfg, BATCH, SEQ,
                                  s_enc=SEQ if cfg.enc_dec else 0,
                                  device="meta")
            spec_for = S.cache_pspec_fn(cfg, m, BATCH)
            for k, v in _flat(cache).items():
                leaf = k.split("/")[-1]
                if leaf in ("ssm_state", "xk", "xv") \
                        and "model" not in spec_for(k, v):
                    seen.add(f"replicated {leaf}")
            if cfg.window and cfg.window < PROMPT:
                seen.add("ring")
    assert seen == {"split q head", "group cut", "split K/V head",
                    "replicated vocabulary", "replicated ssm_state",
                    "replicated xk", "replicated xv", "ring"}


def test_kv_index_gives_each_q_head_its_group():
    """hymba-1.5b's 25 q / 5 K/V heads at a model axis of 2: position 0
    computes q heads 0-12 (head 12 split) over K/V heads 0-2, position 1
    q heads 12-24 over K/V heads 2-4; each q head reads its own group's
    K/V head.  qwen3-1.7b's whole groups need no index."""
    cfg = PC.get_config("hymba-1.5b")
    s0, s1 = (TPP.head_slice(cfg, 2, m) for m in (0, 1))
    assert (s0.q_heads, s0.kv_heads, s1.q_heads, s1.kv_heads) == (
        (0, 13), (0, 3), (12, 25), (2, 5))
    assert TPP.kv_index(cfg, s0) == [0] * 5 + [1] * 5 + [2] * 3
    assert TPP.kv_index(cfg, s1) == [0] * 3 + [1] * 5 + [2] * 5
    qwen = PC.get_config("qwen3-1.7b")
    assert all(TPP.kv_index(qwen, TPP.head_slice(qwen, n, m)) is None
               for n in (2, 4, 8, 16) for m in range(n))


def test_hymba_norms_span_every_heads_channels(ref, monkeypatch):
    """hymba with each head's ``wv`` and ``wv_s`` columns scaled apart
    (``NORM_SCALE``) on ``(4, 2)``: each position's sums of squares are
    reduced before ``norm_a`` and ``norm_s``, so the logits and the final
    cache hold to the reference at 1e-4; the same steps with each position
    normalising by its own channels' mean square (a per-shard RMS) depart
    by more."""
    from repro_torch.parallel.tensor_parallel import ModelGroup
    cfg = _config(NORM_CONFIG)
    want = ref["norm"]
    params = params_from_numpy(want["params"], CPU)
    x, toks = _inputs(NORM_CONFIG)
    logits, cache = _run(cfg, params, _mesh("4x2"), x, toks)
    for g, w in zip(logits, want["logits"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for k, v in _flat(want["cache"]).items():
        np.testing.assert_allclose(cache[k].float().numpy(), v, **TOL,
                                   err_msg=k)
    reduce = ModelGroup.all_reduce

    def per_shard(self, parts, dtype):
        if dtype == torch.float32 and parts[0].shape[-1] == 2:
            return [p * self.size for p in parts]
        return reduce(self, parts, dtype)
    monkeypatch.setattr(ModelGroup, "all_reduce", per_shard)
    bad, _ = _run(cfg, params, _mesh("4x2"), x, toks)
    err = max(float(np.abs(g.numpy() - w).max())
              for g, w in zip(bad, want["logits"]))
    assert err > 1e-4 + 1e-4 * max(float(np.abs(w).max())
                                   for w in want["logits"]), err


@pytest.mark.parametrize("mesh", TP_MESHES)
@pytest.mark.parametrize("name", ["hymba-published-ratios",
                                  "whisper-6-heads"])
def test_positions_gather_at_most_their_model_slice(name, mesh):
    """A prefill and a decode step: each position of each data shard
    gathers, of every leaf the reference shards over ``"model"``, its
    model slice (1/M of the leaf, one layer at a time) or nothing (a
    whisper prefill reads no decoder weight but the cross K/V
    projections), of a replicated leaf at most the whole, and never
    hymba's ``ssm/wo_s``, which no forward reads."""
    cfg, m = _config(name), _mesh(mesh)
    size = TPP.model_size(m)
    params = PM.init_params(cfg, 0, device=CPU)
    specs = dict(_walk(S.params_pspecs(cfg, m)))
    whole = {path: leaf.numel() * leaf.element_size()
             for path, leaf in _walk(params)}
    p = S.shard_tree(params, S.params_shardings(cfg, m))
    x, toks = _inputs(name)
    prefill = PS.make_prefill_step(cfg, BATCH, SEQ, m)
    _, cache = prefill(p, torch.from_numpy(x))
    decode = PS.make_decode_step(cfg, m)
    decode(p, cache, torch.from_numpy(toks[0][0]), toks[0][1])
    every = set(np.ndindex(*m.devices.shape))
    for step in (prefill, decode):
        got = step.gathered.by_position
        assert set(got) == every
        for pos, leaves in got.items():
            assert all(path in whole for path in leaves), pos
            for path, n in leaves.items():
                if "model" in specs[path]:
                    assert n == whole[path] // size, (pos, path)
                else:
                    assert n <= whole[path], (pos, path)
            if cfg.mixer == "hymba":
                assert not any(path[-1] == "wo_s" for path in leaves)
                assert any(path[-2:] == ("ssm", "wv_s") for path in leaves)
    if cfg.mixer == "hymba":
        assert any(path[-1] == "wo_s" and "model" in spec
                   for path, spec in specs.items())


@pytest.mark.parametrize("arch,kind", DRY_CELLS)
def test_dryrun_cells_take_the_route(ref, arch, kind):
    """The dry run costs hymba's and whisper's serving cells (reduced,
    bfloat16 compute, on ``(4, 2)``) as one model position's step on the
    tensor-parallel route: K4 (and hymba's K6) once a layer on its heads in
    a prefill, a whisper prefill's K4 once an encoder layer; its argument
    bytes equal to the reference's ``memory_analysis()``; its record names
    the costed position."""
    cfg = dataclasses.replace(PC.reduced_config(PC.get_config(arch)),
                              compute_dtype="bfloat16")
    mesh = make_mesh((4, 2), ("data", "model"), [CPU] * 8)
    cell = PD.cost_cell(cfg, PC.ShapeConfig("t", kind, 64, 8), mesh)
    assert cell["n_model_shards"] == 2 and cell["n_data_shards"] == 4
    assert cell["tp_position"] in PD.costed_positions(cfg, 2)
    assert cell["memory"]["argument_bytes"] \
        == ref["argument_bytes"][arch, kind]
    calls = {k: v["calls"] for k, v in cell["kernels"].items()}
    n = cfg.n_enc_layers if cfg.enc_dec else cfg.n_layers
    want = {} if kind == "decode" else {"flash_attention": n}
    if cfg.mixer == "hymba" and kind == "prefill":
        want["rwkv6"] = n
    assert calls == want
    assert cell["coll"].per_op["tp_reduce"] > 0


def test_ssm_projections_the_guard_replicates():
    """hymba with 25 heads of SSM state 6: ``wr_s``, ``wk_s`` and ``ww_s``
    (150 columns) split over a model axis of 2 but not of 4, where the
    reference's guard replicates them and each position cuts its heads'
    columns from the whole projection.  Both meshes hold to one device."""
    cfg = dataclasses.replace(_config("hymba-published-ratios"), ssm_state=6)
    params = PM.init_params(cfg, 1, device=CPU)
    x, toks = _inputs("hymba-published-ratios")
    one = _run(cfg, params, None, x, toks)
    for mesh, split in (("4x2", True), ("2x4", False)):
        m = _mesh(mesh)
        specs = dict(_walk(S.params_pspecs(cfg, m)))
        assert ("model" in specs["layers", "pos0", "ssm", "wr_s"]) is split
        assert TPP.tp_route(cfg, m)
        logits, cache = _run(cfg, params, m, x, toks)
        for g, o in zip(logits, one[0]):
            np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)
        for k, v in cache.items():
            np.testing.assert_allclose(v.numpy(), one[1][k].numpy(), **TOL,
                                       err_msg=k)

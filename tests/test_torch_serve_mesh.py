"""Port parity, sharded serving: ``repro_torch``'s production mesh, cache
shardings, sharded prefill and decode steps, input specs and decode
shardings on the CPU against ``repro``.

One module-scoped subprocess runs the reference at 8 forced host devices
(``--xla_force_host_platform_device_count=8``, as ``test_distributed.py``
does), x64 off; the port's meshes are of repeated ``cpu`` devices.  Params
cross over as numpy trees (``params_from_numpy``).  What is held against
what:

* ``cache_pspec_fn`` / ``cache_shardings`` equal to the reference's specs,
  as tuples, for all ten archs (published and reduced configs) on the
  meshes ``(4, 2)``, ``(3, 2)``, ``(2, 2, 2)`` with ``pod`` and ``(1, 1)``,
  at batch 8 and batch 1, rwkv's ``wkv`` taking the K/V rule as the
  reference's suffix test makes it;
* ``input_specs``' shapes and dtypes for the ten archs × the four
  ``SHAPES``; ``decode_shardings`` on ``(4, 2)``;
* the sharded prefill and 4 decode steps on ``(4, 2)`` for reduced
  qwen3-1.7b, rwkv6-1.6b, gemma2-2b, paligemma-3b, dbrx-132b,
  kimi-k2-1t-a32b and whisper-small (the encoder-decoder branch), at
  batch 8 and batch 1 (the
  cache's sequence over ``data``), against the reference's jitted sharded
  steps with the in- and out-shardings ``dryrun._lower_compile`` gives
  them, and against the port's one-device steps, at the one-device serving
  parity tests' 1e-4; a ``(1, 1)`` mesh bit-equal to one device;
* the tensor-parallel route (``tp_route``: every family at every model
  size above one that its widths divide; whisper-small's 4x2 run above
  takes it, and ``test_torch_serve_mesh_tp.py`` holds hymba and whisper on
  both meshes) for qwen3-1.7b, rwkv6-1.6b, gemma2-2b, paligemma-3b, and
  with expert parallelism dbrx-132b and kimi-k2-1t-a32b, also on ``(2, 4)``: reduced qwen3-1.7b's 2 K/V heads
  under 4 model shards and paligemma-3b's, dbrx-132b's and kimi-k2's one
  K/V head split inside it (the MoE archs' 4 experts one a position),
  both ways at 1e-4; no position gathering more than its model slice of a
  leaf sharded over ``"model"`` (the expert stacks included); the storage
  route where the experts do not divide the model axis; rwkv's
  ``out_norm`` over all the
  heads' channels (its heads scaled apart), where a per-shard norm departs
  from the reference; the logits over ``resolve_spec(shape, ("dp", None,
  "vocab"), mesh)``;
* an MoE decode batch that overflows an expert's capacity (reduced
  dbrx-132b at batch 32, its router's columns equal in the params both
  packages get): the port's mesh decode bundles the whole batch once an
  MoE layer, as the reference's one program does, and holds to its sharded
  run and to one device at 1e-4, in-graph and host-routed, on ``(4, 2)``
  (expert parallelism) and ``(4, 1)`` (the storage route);
* the production meshes' shapes and axes (``test_distributed.py``'s).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.launch import steps as PS
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as PM
from repro_torch.models.params import _walk, params_from_numpy
from repro_torch.parallel import sharding as S
from repro_torch.parallel import tensor_parallel as TPP
from repro_torch.parallel.api import resolve_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "3x2": ((3, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
SPEC_BATCHES = (8, 1)
SPEC_SEQ = 64
SERVE_ARCHS = ["qwen3-1.7b", "rwkv6-1.6b", "gemma2-2b", "dbrx-132b",
               "kimi-k2-1t-a32b", "whisper-small", "paligemma-3b"]
# the archs whose serving steps compute over the model axis
# (``tp_route``), also served on (2, 4): reduced qwen3-1.7b's 2 K/V heads
# over 4 model shards, paligemma-3b's, dbrx-132b's and kimi-k2's one K/V
# head split inside it, the MoE archs' 4 experts one a position
TP_ARCHS = ["qwen3-1.7b", "rwkv6-1.6b", "gemma2-2b", "paligemma-3b",
            "dbrx-132b", "kimi-k2-1t-a32b"]
MOE_ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
# rwkv6-1.6b with its heads' values scaled apart (OUT_NORM_SCALE[j] for
# head j of every layer's ``wv``): each model shard's sum of squares
# differs, so ``out_norm`` over one shard's channels departs from the norm
# over all of them
OUT_NORM_SCALE = (4.0, 2.0, 0.5, 0.25)
# prompt, decode steps; the cache holds both (20: a multiple of the data
# axis, so the batch-1 cell shards its sequence)
PROMPT, N_DEC = 16, 4
SEQ = PROMPT + N_DEC
# the one-device serving parity tests' tolerance (test_torch_models.py)
TOL = dict(rtol=1e-4, atol=1e-4)
# an MoE decode batch that overflows an expert's capacity (24 slots at 32
# rows, top-2 of 4) where no data shard's 8 rows would (8 slots): the
# router's columns made equal in the params both packages get
DROP = dict(arch="dbrx-132b", batch=32, prompt=8, n_dec=3, seed=130)

_REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, get_config, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import (decode_shardings, input_specs,
                                make_decode_step, make_prefill_step)
from repro.models import model as M
from repro.parallel import sharding as S

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"n_devices": len(jax.devices())}
meshes = {k: make_mesh(*v) for k, v in inp["meshes"].items()}
spec = lambda s: tuple(s.spec)
to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}

def cache_of(cfg, b, s):
    return jax.eval_shape(
        lambda: M.init_cache(cfg, b, s, s_enc=s if cfg.enc_dec else 0))

out["cache_specs"] = {}
for arch in ARCHS:
    for red in (False, True):
        cfg = get_config(arch)
        cfg = reduced_config(cfg) if red else cfg
        for b in inp["spec_batches"]:
            cache = cache_of(cfg, b, inp["spec_seq"])
            for name, mesh in meshes.items():
                out["cache_specs"][arch, red, b, name] = {
                    k: spec(v) for k, v in flat(
                        S.cache_shardings(cfg, mesh, cache, b)).items()}

out["input_specs"] = {}
out["decode_shardings"] = {}
for arch in ARCHS:
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        specs = input_specs(cfg, shape)
        out["input_specs"][arch, name] = {
            k: (tuple(v.shape), str(v.dtype)) for k, v in flat(specs).items()}
        if shape.kind == "decode":
            ps, cs, ts, qs = decode_shardings(cfg, meshes["4x2"],
                                              specs["cache"],
                                              shape.global_batch)
            out["decode_shardings"][arch, name] = (
                {k: spec(v) for k, v in flat(ps).items()},
                {k: spec(v) for k, v in flat(cs).items()}, spec(ts),
                spec(qs))

def serve(cfg, params, b, seq, x, toks, mesh=meshes["4x2"]):
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
        for i, (tok, pos) in enumerate(toks):
            lg, cache = step(jax.device_put(params, pshard), cache,
                             jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos, jnp.int32))
            seen.append(np.asarray(lg, np.float32))
    return dict(logits=seen, cache=to_np(cache))

out["serve"] = {}
for arch in inp["serve_archs"]:
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, jax.random.PRNGKey(3))
    for b in inp["spec_batches"]:
        out["serve"][arch, b] = serve(cfg, params, b, inp["seq"],
                                      *inp["serve_inputs"][arch, b])
        if arch in inp["tp_archs"]:
            out["serve"][arch, b, "2x4"] = serve(
                cfg, params, b, inp["seq"], *inp["serve_inputs"][arch, b],
                mesh=meshes["2x4"])
    out["serve"][arch, "params"] = to_np(params)

# rwkv6-1.6b, each head's wv columns scaled apart
cfg = reduced_config(get_config("rwkv6-1.6b"))
scale = jnp.repeat(jnp.asarray(inp["out_norm_scale"], jnp.float32),
                   cfg.d_head)
params = jax.tree_util.tree_map_with_path(
    lambda path, a: a * scale.astype(a.dtype)
    if path[-1].key == "wv" else a,
    M.init_params(cfg, jax.random.PRNGKey(3)))
out["out_norm"] = dict(serve(cfg, params, 8, inp["seq"],
                             *inp["serve_inputs"]["rwkv6-1.6b", 8]),
                       params=to_np(params))

# the router's columns made equal: every token ties, and top-k takes the
# first experts, which overflow their capacity at the global batch
cfg = reduced_config(get_config(inp["drop_arch"]))
params = jax.tree_util.tree_map_with_path(
    lambda path, a: jnp.broadcast_to(a[..., :1], a.shape)
    if path[-1].key == "router" else a,
    M.init_params(cfg, jax.random.PRNGKey(3)))
b, seq, x, toks = inp["drop_inputs"]
out["drop"] = dict(serve(cfg, params, b, seq, x, toks), params=to_np(params))
out["drop_4x1"] = serve(cfg, params, b, seq, x, toks, mesh=meshes["4x1"])
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _reduced(arch):
    return PC.reduced_config(PC.get_config(arch))


def _serve_inputs(arch, b):
    """The prompt (tokens, or whisper's frames) and each decode step's
    (token, position), from a seed."""
    cfg = _reduced(arch)
    rng = np.random.default_rng(100 + b)
    if cfg.enc_dec:
        x = rng.standard_normal((b, SEQ, cfg.d_frame)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
    first = 0 if cfg.enc_dec else PROMPT
    toks = [(rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
             first + i) for i in range(N_DEC)]
    return x, toks


def _drop_inputs():
    """The drop case's batch, cache length, prompt and decode steps."""
    d = DROP
    rng = np.random.default_rng(d["seed"])
    vocab = _reduced(d["arch"]).vocab_size
    x = rng.integers(0, vocab, (d["batch"], d["prompt"])).astype(np.int32)
    toks = [(rng.integers(0, vocab, (d["batch"], 1)).astype(np.int32),
             d["prompt"] + i) for i in range(d["n_dec"])]
    return d["batch"], d["prompt"] + d["n_dec"], x, toks


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_serve8")
    inp = dict(meshes=MESHES, spec_batches=SPEC_BATCHES, spec_seq=SPEC_SEQ,
               serve_archs=SERVE_ARCHS, tp_archs=TP_ARCHS, seq=SEQ,
               out_norm_scale=OUT_NORM_SCALE,
               serve_inputs={(a, b): _serve_inputs(a, b)
                             for a in SERVE_ARCHS for b in SPEC_BATCHES},
               drop_arch=DROP["arch"], drop_inputs=_drop_inputs())
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    script = tmp / "ref_serve8.py"
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


def _specs(shardings):
    return {k: tuple(v.spec) for k, v in _flat(shardings).items()}


# -- the production mesh -----------------------------------------------------

@pytest.mark.parametrize("device", [CPU, "meta"])
def test_production_mesh_shapes(device):
    """``tests/test_distributed.py::test_production_mesh_shapes``'s shapes
    and axes, over repeated ``cpu`` and over ``meta`` devices."""
    m1 = make_production_mesh(devices=[device] * 256)
    assert m1.devices.shape == (16, 16)
    assert m1.axis_names == ("data", "model")
    m2 = make_production_mesh(multi_pod=True, devices=[device] * 512)
    assert m2.devices.shape == (2, 16, 16)
    assert m2.axis_names == ("pod", "data", "model")
    assert all(d == torch.device(device) for d in m2.devices.flat)


def test_production_mesh_needs_its_cards():
    if torch.cuda.device_count() >= 256:
        pytest.skip("256 cards are present")
    with pytest.raises(RuntimeError, match="256 CUDA devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 CUDA devices"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="meta"):
        make_production_mesh(devices=["meta"] * 255 + [CPU])


def test_meta_only_where_a_tree_is_built():
    """``init_cache`` and a mesh of ``meta`` devices only (the dry run's)
    take ``meta``; an entry point that computes does not, nor a mesh that
    mixes ``meta`` with a real device."""
    cfg = _reduced("qwen3-1.7b")
    cache = PM.init_cache(cfg, 2, 8, device="meta")
    assert all(x.device.type == "meta" for _, x in _walk(cache))
    assert make_mesh((2,), ("data",), ["meta"] * 2).devices.shape == (2,)
    with pytest.raises(ValueError, match="meta"):
        PM.init_params(cfg, 0, device="meta")
    with pytest.raises(ValueError, match="meta"):
        make_mesh((2,), ("data",), ["meta", CPU])
    with pytest.raises(ValueError, match="meta"):
        PM.compute_params(cfg, PM.init_params(cfg, 0, device=CPU),
                          device="meta")


# -- cache specs ---------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", PC.ARCHS)
def test_cache_specs_match_reference(ref, arch, mesh):
    for reduced in (False, True):
        cfg = _reduced(arch) if reduced else PC.get_config(arch)
        for b in SPEC_BATCHES:
            cache = PM.init_cache(cfg, b, SPEC_SEQ,
                                  s_enc=SPEC_SEQ if cfg.enc_dec else 0,
                                  device="meta")
            got = _specs(S.cache_shardings(cfg, _mesh(mesh), cache, b))
            assert got == ref["cache_specs"][arch, reduced, b, mesh]
            spec_for = S.cache_pspec_fn(cfg, _mesh(mesh), b)
            assert {k: spec_for(k, v) for k, v in _flat(cache).items()} \
                == got


def test_wkv_takes_the_kv_rule(ref):
    """The reference's ``path.endswith(("k", "v", "xk", "xv"))`` also
    matches rwkv's ``wkv``: at batch 1 its K dim is sharded over ``data``,
    and the ``wkv`` branch never sees it; hymba's ``ssm_state`` does take
    that branch."""
    m = _mesh("4x2")
    rwkv = PC.get_config("rwkv6-1.6b")
    for b, want in ((1, (None, None, "model", "data", None)),
                    (8, (None, "data", "model", None, None))):
        cache = PM.init_cache(rwkv, b, SPEC_SEQ, device="meta")
        got = _specs(S.cache_shardings(rwkv, m, cache, b))
        assert got["layers/pos0/wkv"] == want
        assert ref["cache_specs"]["rwkv6-1.6b", False, b, "4x2"][
            "layers/pos0/wkv"] == want
    hymba = PC.get_config("hymba-1.5b")
    cache = PM.init_cache(hymba, 1, SPEC_SEQ, device="meta")
    ssm = [(k, v) for k, v in _flat(cache).items()
           if k.endswith("ssm_state")]
    spec_for = S.cache_pspec_fn(hymba, m, 1)
    assert ssm and all(spec_for(k, v)[-2:] == (None, None) for k, v in ssm)


# -- input specs and decode shardings ------------------------------------------

@pytest.mark.parametrize("arch", PC.ARCHS)
def test_input_specs_match_reference(ref, arch):
    cfg = PC.get_config(arch)
    for name, shape in PC.SHAPES.items():
        specs = PS.input_specs(cfg, shape)
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(specs).items()}
        assert got == ref["input_specs"][arch, name], name
        assert all(v.device.type == "meta" for v in _flat(specs).values())


@pytest.mark.parametrize("arch", PC.ARCHS)
def test_decode_shardings_match_reference(ref, arch):
    cfg = PC.get_config(arch)
    m = _mesh("4x2")
    for name, shape in PC.SHAPES.items():
        if shape.kind != "decode":
            continue
        specs = PS.input_specs(cfg, shape)
        ps, cs, ts, qs = PS.decode_shardings(cfg, m, specs["cache"],
                                             shape.global_batch)
        want = ref["decode_shardings"][arch, name]
        assert (_specs(ps), _specs(cs), ts.spec, qs.spec) == want, name


# -- sharded prefill and decode --------------------------------------------------

def _run(cfg, params, b, mesh, x, toks, seq=SEQ):
    """Prefill and the decode steps on ``mesh`` (None: one device):
    ``(logits of each, final cache)``, gathered onto the host."""
    p = params if mesh is None else S.shard_tree(
        params, S.params_shardings(cfg, mesh))
    logits, cache = PS.make_prefill_step(cfg, b, seq, mesh)(
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
    for arch in SERVE_ARCHS:
        cfg = _reduced(arch)
        params = params_from_numpy(ref["serve"][arch, "params"], CPU)
        for b in SPEC_BATCHES:
            x, toks = _serve_inputs(arch, b)
            for name in ("one", "4x2", "1x1") + (
                    ("2x4",) if arch in TP_ARCHS else ()):
                out[arch, b, name] = _run(
                    cfg, params, b, None if name == "one" else _mesh(name),
                    x, toks)
    return out


@pytest.mark.parametrize("b", SPEC_BATCHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_reference_and_one_device(ref, served, arch,
                                                          b):
    logits, cache = served[arch, b, "4x2"]
    one_logits, one_cache = served[arch, b, "one"]
    want = ref["serve"][arch, b]
    assert len(logits) == len(want["logits"]) == N_DEC + 1
    for got, w, one in zip(logits, want["logits"], one_logits):
        np.testing.assert_allclose(got.float().numpy(), w, **TOL)
        np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    want_cache = _flat(want["cache"])
    assert set(cache) == set(want_cache) == set(one_cache)
    for k, v in cache.items():
        np.testing.assert_allclose(v.float().numpy(), want_cache[k], **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(v.float().numpy(),
                                   one_cache[k].float().numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("b", SPEC_BATCHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_one_by_one_mesh_is_one_device(served, arch, b):
    logits, cache = served[arch, b, "1x1"]
    one_logits, one_cache = served[arch, b, "one"]
    assert all(torch.equal(g, w) for g, w in zip(logits, one_logits))
    assert all(torch.equal(cache[k], one_cache[k]) for k in one_cache)


@pytest.mark.parametrize("b", SPEC_BATCHES)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_serving_on_2x4_matches_reference_and_one_device(
        ref, served, arch, b):
    """Four model shards: reduced qwen3-1.7b's and gemma2-2b's 2 K/V heads
    each read by two positions, paligemma-3b's one K/V head split inside it
    (its columns over 4 positions, exchanged), rwkv6-1.6b one head a
    position.  Every step's logits and the final cache within 1e-4 of the
    reference's jitted steps on the same mesh and of one device."""
    assert TPP.tp_route(_reduced(arch), _mesh("2x4"))
    _held(served[arch, b, "2x4"], ref["serve"][arch, b, "2x4"],
          served[arch, b, "one"])


def test_route_by_family_and_model_size():
    """Every family computes over the model axis at every model size above
    one whose reference guards ``divides`` accepts (the production mesh's
    16 too): the MoE archs with their experts split over it, hymba's
    hybrid mixer and the encoder-decoder with their heads split, their
    vocabularies (32001, 51865) replicated; a model axis of one keeps the
    storage-only route."""
    meta = {(16, 16): make_production_mesh(devices=["meta"] * 256),
            (4, 4): make_mesh((4, 4), ("data", "model"), ["meta"] * 16),
            (4, 2): make_mesh((4, 2), ("data", "model"), ["meta"] * 8),
            (8, 1): make_mesh((8, 1), ("data", "model"), ["meta"] * 8)}
    for arch in PC.ARCHS:
        cfg = PC.get_config(arch)
        assert TPP.in_scope(cfg), arch
        for shape, m in meta.items():
            want = shape[1] > 1
            assert TPP.divides(cfg, shape[1]) is True, (arch, shape)
            assert TPP.tp_route(cfg, m) is want, (arch, shape)
        assert TPP.tp_route(_reduced(arch), _mesh("2x4"))
        assert TPP.tp_route(_reduced(arch), _mesh("4x2"))
        assert not TPP.tp_route(_reduced(arch), _mesh("4x1"))
    for arch in ("hymba-1.5b", "whisper-small"):
        cfg = PC.get_config(arch)
        assert not any(TPP.vocab_split(cfg, n) for n in (2, 4, 16))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_experts_that_do_not_divide_keep_the_storage_route(arch):
    """The reference's guard replicates an ``"experts"`` (or shared
    ``"mlp"``) dim its model axis does not divide; the port then keeps the
    storage-only route: reduced configs with 6 experts (or, kimi-k2, a
    shared width of 66) at a model axis of 4, which 2 divides.  The
    sharded steps on ``(2, 4)`` still hold to one device."""
    import dataclasses
    cfg = _reduced(arch)
    bad = [dataclasses.replace(cfg, n_experts=6)]
    if cfg.n_shared_experts:
        bad.append(dataclasses.replace(cfg, d_ff_expert=66))
    for c in bad:
        assert not TPP.divides(c, 4) and TPP.divides(c, 2)
        assert not TPP.tp_route(c, _mesh("2x4"))
        assert TPP.tp_route(c, _mesh("4x2"))
        pspecs = dict(_walk(S.params_pspecs(c, _mesh("2x4"))))
        ffn = {k[-1]: v for k, v in pspecs.items() if "ffn" in k}
        assert "model" not in (ffn["w_gate"] if c.n_experts == 6
                               else ffn["shared_gate"])
    c = bad[0]
    params = PM.init_params(c, 0, device=CPU)
    x, toks = _serve_inputs(arch, 8)
    one = _run(c, params, 8, None, x, toks)
    got = _run(c, params, 8, _mesh("2x4"), x, toks)
    for g, o in zip(got[0], one[0]):
        np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), one[1][k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_positions_gather_at_most_their_model_slice(arch, mesh):
    """A prefill and a decode step: each position of each data shard
    gathers, of every leaf sharded over ``"model"`` (an MoE FFN's expert
    stacks and shared experts too), its model slice and no more (1/M of
    the leaf, one layer at a time), never the whole leaf.  An MoE decode
    step runs its FFN on the first data shard's positions over the whole
    batch: only they gather the FFN's params."""
    cfg, m = _reduced(arch), _mesh(mesh)
    size = TPP.model_size(m)
    params = PM.init_params(cfg, 0, device=CPU)
    sharded = {path: leaf.numel() * leaf.element_size()
               for (path, leaf), (_, spec) in zip(
                   _walk(params), _walk(S.params_pspecs(cfg, m)))
               if "model" in spec}
    mixer = "rwkv" if cfg.mixer == "rwkv" else "attn"
    assert {("embed",), ("layers", "pos0", mixer, "wo")} <= set(sharded)
    moe = cfg.ffn == "moe"
    if moe:
        assert {("layers", "pos0", "ffn", k) for k in (
            "w_gate", "w_up", "w_down") + (
            ("shared_gate", "shared_up", "shared_down")
            if cfg.n_shared_experts else ())} <= set(sharded)
    p = S.shard_tree(params, S.params_shardings(cfg, m))
    x, toks = _serve_inputs(arch, 8)
    prefill = PS.make_prefill_step(cfg, 8, SEQ, m)
    _, cache = prefill(p, torch.from_numpy(x))
    decode = PS.make_decode_step(cfg, m)
    decode(p, cache, torch.from_numpy(toks[0][0]), toks[0][1])
    every = set(np.ndindex(*m.devices.shape))
    first = set(PS.tp_shards(m, 8)[0][2])
    for step in (prefill, decode):
        got = step.gathered.by_position
        assert set(got) == every
        for pos, leaves in got.items():
            for path, whole in sharded.items():
                if moe and step is decode and "ffn" in path \
                        and pos not in first:
                    assert path not in leaves, (pos, path)
                    continue
                assert leaves[path] == whole // size, (pos, path)


def test_rwkv_out_norm_spans_every_heads_channels(ref, monkeypatch):
    """rwkv6-1.6b with its heads' values scaled apart (``OUT_NORM_SCALE``)
    on ``(4, 2)``: each position's sum of squares is reduced before
    ``out_norm``, so the logits and the final cache hold to the reference
    at 1e-4; the same steps with each position normalising by its own
    channels' mean square (a per-shard RMS) depart by more."""
    from repro_torch.parallel.tensor_parallel import ModelGroup
    cfg = _reduced("rwkv6-1.6b")
    want = ref["out_norm"]
    params = params_from_numpy(want["params"], CPU)
    x, toks = _serve_inputs("rwkv6-1.6b", 8)
    logits, cache = _run(cfg, params, 8, _mesh("4x2"), x, toks)
    for g, w in zip(logits, want["logits"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    for k, v in _flat(want["cache"]).items():
        np.testing.assert_allclose(cache[k].float().numpy(), v, **TOL,
                                   err_msg=k)
    reduce = ModelGroup.all_reduce

    def per_shard(self, parts, dtype):
        if dtype == torch.float32 and parts[0].shape[-1] == 1:
            return [p * self.size for p in parts]
        return reduce(self, parts, dtype)
    monkeypatch.setattr(ModelGroup, "all_reduce", per_shard)
    bad, _ = _run(cfg, params, 8, _mesh("4x2"), x, toks)
    err = max(float(np.abs(g.numpy() - w).max())
              for g, w in zip(bad, want["logits"]))
    assert err > 1e-4 + 1e-4 * max(float(np.abs(w).max())
                                   for w in want["logits"]), err


@pytest.mark.parametrize("mesh", ["4x2", "2x4", "2x2x2"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_tp_logits_over_the_references_constrain(arch, mesh):
    """The tensor-parallel steps' logits come back over ``resolve_spec(
    shape, ("dp", None, "vocab"), mesh)`` (the reference's ``constrain``
    of its logits), each shard on its placement's device, and read whole
    within 1e-4 of one device (the pod mesh too, where at batch 2 the rows
    split over ``data`` only and the logits' spec leaves the batch whole:
    each shard takes both data shards' rows)."""
    cfg, m = _reduced(arch), _mesh(mesh)
    params = PM.init_params(cfg, 0, device=CPU)
    p = S.shard_tree(params, S.params_shardings(cfg, m))
    for b in SPEC_BATCHES + ((2,) if mesh == "2x2x2" else ()):
        x, toks = _serve_inputs(arch, b)
        tok, pos = toks[0]
        got = PS.make_prefill_step(cfg, b, SEQ, m)(p, torch.from_numpy(x))
        got = (got[0], PS.make_decode_step(cfg, m)(
            p, got[1], torch.from_numpy(tok), pos)[0])
        one = PS.make_prefill_step(cfg, b, SEQ)(params, torch.from_numpy(x))
        one = (one[0], PS.make_decode_step(cfg)(
            params, one[1], torch.from_numpy(tok), pos)[0])
        for lg, o in zip(got, one):
            assert isinstance(lg, S.ShardedTensor)
            assert lg.sharding.spec == resolve_spec(
                lg.shape, ("dp", None, "vocab"), m)
            assert lg.sharding.spec[2] == "model"
            placed = lg.sharding.placement(3)
            assert set(lg.shards) == set(placed)
            assert all(lg.shards[i].device == placed[i] for i in placed)
            np.testing.assert_allclose(S.gather(lg, CPU).numpy(), o.numpy(),
                                       **TOL)


def _held(got, want, one):
    """Every step's logits and the final cache within ``TOL`` of the
    reference's (``want``) and of the one-device port's (``one``)."""
    (logits, cache), (one_logits, one_cache) = got, one
    assert len(logits) == len(want["logits"]) == len(one_logits)
    for g, w, o in zip(logits, want["logits"], one_logits):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        np.testing.assert_allclose(g.numpy(), o.numpy(), **TOL)
    want_cache = _flat(want["cache"])
    assert set(cache) == set(want_cache) == set(one_cache)
    for k, v in cache.items():
        np.testing.assert_allclose(v.float().numpy(), want_cache[k], **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(v.numpy(), one_cache[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", ["4x2", "4x1"])
@pytest.mark.parametrize("routing", ["in_graph", "host"])
def test_moe_mesh_decode_bundles_the_global_batch(ref, routing, mesh,
                                                  monkeypatch):
    """Reduced dbrx-132b at batch 32, its router's columns equal: every
    token takes the first two experts, so the reference's decode step (one
    program over the batch) drops the tokens past the global capacity, 24
    slots, where a data shard's 8 rows (8 slots) would drop none.  The
    port's mesh decode bundles the whole batch once an MoE layer: on ``(4,
    2)`` the data shards' rows on the first shard's two model positions,
    each on its two experts (expert parallelism); on ``(4, 1)`` on the
    first shard's device (``_global_moe_decode``, the storage route).  Its
    logits and final cache within ``TOL`` of the reference's sharded run on
    the same mesh and of one device.  With a runtime installed the host
    route runs once an MoE layer a decode step, not once a data shard or a
    model position."""
    import repro.models.moe as RMOE
    import jax.numpy as jnp
    from repro_torch.models import moe as PMOE
    from repro_torch.runtime import ReapRuntime
    cfg = _reduced(DROP["arch"])
    assert TPP.tp_route(cfg, _mesh(mesh)) is (mesh == "4x2")
    b, seq, x, toks = _drop_inputs()
    params = params_from_numpy(ref["drop"]["params"], CPU)
    router = ref["drop"]["params"]["layers"]["pos0"]["ffn"]["router"][0]
    rows = np.random.default_rng(0).standard_normal(
        (b, cfg.d_model)).astype(np.float32)
    dropped = {}
    for n in (b, b // 4):
        cap = RMOE.expert_capacity(n, cfg.n_experts, cfg.moe_top_k,
                                   cfg.capacity_factor)
        dropped[n] = float(RMOE.route_and_bundle(
            jnp.asarray(rows[:n]), jnp.asarray(router),
            n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
            capacity=cap)[3])
    assert dropped[b] > 0 and dropped[b // 4] == 0, dropped
    one = _run(cfg, params, b, None, x, toks, seq)
    calls = []
    if routing == "host":
        plan_dest = PMOE._host_plan_dest

        def counted(expert_ids, **kw):
            calls.append(np.asarray(expert_ids).shape[0])
            return plan_dest(expert_ids, **kw)
        monkeypatch.setattr(PMOE, "_host_plan_dest", counted)
        monkeypatch.setattr(PMOE, "_HOST_DISPATCH_RT",
                            ReapRuntime(device=CPU))
    got = _run(cfg, params, b, _mesh(mesh), x, toks, seq)
    want = ref["drop"] if mesh == "4x2" else dict(
        ref["drop_4x1"], params=ref["drop"]["params"])
    _held(got, want, one)
    if routing == "host":
        assert calls == [b] * (cfg.n_layers * DROP["n_dec"])


def test_batch_one_cell_shards_the_cache_sequence():
    """At batch 1 the rows do not divide the data axis: one data shard at
    the mesh's first data position, the cache stored with its sequence
    over ``data`` and its heads over ``model``; the logits come back over
    the vocabulary only (the tensor-parallel route), at batch 8 over the
    batch and the vocabulary."""
    cfg = _reduced("qwen3-1.7b")
    m = _mesh("4x2")
    params = S.shard_tree(PM.init_params(cfg, 0, device=CPU),
                          S.params_shardings(cfg, m))
    x, toks = _serve_inputs("qwen3-1.7b", 1)
    logits, cache = PS.make_prefill_step(cfg, 1, SEQ, m)(
        params, torch.from_numpy(x))
    assert isinstance(logits, S.ShardedTensor) and logits.shape[0] == 1
    assert logits.sharding.spec == (None, None, "model")
    k = cache["layers"]["pos0"]["k"]
    assert isinstance(k, S.ShardedTensor)
    assert k.sharding.spec == (None, None, "model", "data", None)
    assert len(k.shards) == 8
    assert len(PS.data_shards(m, 1)) == 1
    logits8, cache8 = PS.make_prefill_step(cfg, 8, SEQ, m)(
        params, torch.zeros((8, PROMPT), dtype=torch.int32))
    assert isinstance(logits8, S.ShardedTensor)
    assert logits8.sharding.spec == ("data", None, "model")
    assert cache8["layers"]["pos0"]["k"].sharding.spec == (
        None, "data", "model", None, None)


def test_rows_read_and_written_through_the_shards():
    m = _mesh("2x2x2")
    t = torch.arange(2 * 8 * 4 * 6, dtype=torch.float32).reshape(2, 8, 4, 6)
    for spec in [(None, ("pod", "data"), "model", None),
                 (None, None, "model", "data"), (None, None, None, None)]:
        leaf = S.shard(t.clone(), S.Sharding(m, spec))
        for lo, hi in ((0, 8), (2, 6), (3, 4)):
            assert torch.equal(PS.read_rows(leaf, 1, lo, hi, CPU),
                               t[:, lo:hi])
        new = -t[:, 3:7]
        PS.write_rows(leaf, 1, 3, new)
        want = t.clone()
        want[:, 3:7] = new
        assert torch.equal(S.gather(leaf, CPU), want)

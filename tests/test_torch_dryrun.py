"""Port parity, the dry run: ``repro_torch.launch.dryrun``'s cells, skips and
bookkeeping, its argument bytes and its cost engine on the CPU against
``repro``.

One module-scoped subprocess imports the reference's dry run, which forces
512 host devices, x64 off.  What is held against what:

* the cell list over ``ARCHS × SHAPES × {16x16, 2x16x16}`` and
  ``cell_is_skipped`` equal to the reference's (12 skipped: ``long_500k``
  for the six archs with full attention only, on both meshes);
* ``model_flops`` and the total params for the ten archs × the four
  ``SHAPES``; the production meshes' shapes and axes;
* the per-device argument bytes of ``test_dryrun_machinery.py``'s four
  cells (reduced, bfloat16 compute, seq 64, batch 8, on ``(4, 2)``): equal
  to the reference's ``memory_analysis().argument_size_in_bytes``, the
  port counting its host scalars (AdamW's step counter, ``pos``) as the
  reference's int32 arguments;
* one full-size cell, qwen3-1.7b ``decode_32k`` on the 16x16 mesh of
  ``meta`` devices, through the CLI under a time limit of its own;
* a tensor-parallel cell's collectives (``tp_reduce``, ``tp_exchange``)
  against their formulas, written in this file (``TP_CELLS``), and an MoE
  serving cell's (``ep_route``, ``ep_rows``: the routing's copies and a
  decode step's rows moved onto the first data shard's positions) with K5
  three times a layer on the position's experts (``EP_CELLS``); the
  production mesh's MoE serving cells on the expert-parallel route, a lone
  position fetching 1/16 of each expert stack of a layer;
* a train cell on the tensor-parallel route: one position's forward and
  backward on ``meta`` in bfloat16, through ``dense_partial``'s backward,
  its ``tp_reduce`` (forward, recompute and backward) against a formula
  written here (``TRAIN_TP_REDUCE``), its layers' slices fetched twice;
  qwen3-1.7b's ``train_4k`` at full size on the 16x16 mesh under 80 GiB a
  device.

The engine itself: ``CostMode``'s FLOP and bytes on known operators, and
K4, K5 and K6 (and their backward kernels) on ``meta`` tensors, each one
operator with its own FLOP formula and no launch.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch.configs as PC
from repro_torch.kernels import _meta
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun as PD
from repro_torch.launch import roofline as PR
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_dryrun_machinery.py's cells
SMALL_CELLS = [("qwen3-1.7b", "train"), ("gemma2-2b", "decode"),
               ("rwkv6-1.6b", "prefill"), ("dbrx-132b", "train"),
               ("dbrx-132b", "decode"), ("kimi-k2-1t-a32b", "prefill")]
# the full-size cell's own time limit, seconds (it takes some 10 on a
# shared host core)
FULL_CELL_TIMEOUT = 300

_REF_SCRIPT = r"""
import pickle, sys
from repro.launch import dryrun as D
import dataclasses, jax
from repro.configs import ARCHS, SHAPES, ShapeConfig, get_config, reduced_config
from repro.launch import roofline as R
from repro.launch.mesh import make_mesh, make_production_mesh

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"n_devices": len(jax.devices())}
out["cells"] = [(a, s, mp) for a in ARCHS for s in SHAPES
                for mp in (False, True)]
out["skips"] = {(a, s): D.cell_is_skipped(a, s) for a in ARCHS
                for s in SHAPES}
out["model_flops"] = {(a, s): R.model_flops(get_config(a), sh)
                      for a in ARCHS for s, sh in SHAPES.items()}
out["meshes"] = [(m.devices.shape, m.axis_names) for m in (
    make_production_mesh(), make_production_mesh(multi_pod=True))]
mesh = make_mesh((4, 2), ("data", "model"))
out["argument_bytes"] = {}
for arch, kind in inp["small_cells"]:
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              compute_dtype="bfloat16")
    shape = ShapeConfig("t", kind, 64, 8)
    _, compiled = D._lower_compile(cfg, shape, mesh)
    out["argument_bytes"][arch, kind] = int(
        compiled.memory_analysis().argument_size_in_bytes)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_dryrun")
    (tmp / "in.pkl").write_bytes(pickle.dumps({"small_cells": SMALL_CELLS}))
    script = tmp / "ref_dryrun.py"
    script.write_text(textwrap.dedent(_REF_SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(tmp / "in.pkl"),
                        str(tmp / "out.pkl")], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    assert out["n_devices"] == 512
    return out


def _small(arch):
    return dataclasses.replace(PC.reduced_config(PC.get_config(arch)),
                               compute_dtype="bfloat16")


def _small_mesh():
    return make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)


# -- bookkeeping ----------------------------------------------------------------

def test_cells_and_skips_match_reference(ref):
    cells = PD.cells(True)
    assert cells == ref["cells"] and len(cells) == 80
    skips = {(a, s): PD.cell_is_skipped(a, s) for a, s, _ in cells}
    assert skips == ref["skips"]
    n_skipped = sum(PD.cell_is_skipped(a, s) is not None
                    for a, s, _ in cells)
    assert n_skipped == 12
    assert {a for (a, s), why in skips.items() if why} == {
        a for a in PC.ARCHS if not PC.get_config(a).subquadratic}
    assert PD.cells(False, "qwen3-1.7b", "train_4k", True) == [
        ("qwen3-1.7b", "train_4k", True)]


@pytest.mark.parametrize("arch", PC.ARCHS)
def test_model_flops_match_reference(ref, arch):
    for name, shape in PC.SHAPES.items():
        assert PR.model_flops(PC.get_config(arch), shape) \
            == ref["model_flops"][arch, name]


def test_production_meshes_match_reference(ref):
    got = [(m.devices.shape, m.axis_names) for m in (
        PD.make_production_mesh(devices=["meta"] * 256),
        PD.make_production_mesh(multi_pod=True, devices=["meta"] * 512))]
    assert got == ref["meshes"]


def test_roofline_terms_on_datasheet_constants():
    """The H100 SXM datasheet figures; each term is its count over its
    rate, the dominant one the largest."""
    assert (PR.PEAK_FLOPS, PR.HBM_BW, PR.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    coll = PR.CollectiveStats({"param_gather": 9e9}, 9e9, 3, [])
    t = PR.roofline_terms({"flops": 989e12, "bytes accessed": 6.7e12},
                          coll, 256)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == (
        1.0, 2.0, 0.02)
    assert t["dominant"] == "memory" and t["bound_s"] == 2.0
    assert t["collective_ops"] == 3
    assert t["collective_per_op"] == {"param_gather": 9e9}


# -- argument bytes ---------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", SMALL_CELLS)
def test_argument_bytes_match_reference(ref, arch, kind):
    cell = PD.cost_cell(_small(arch), PC.ShapeConfig("t", kind, 64, 8),
                        _small_mesh())
    assert cell["memory"]["argument_bytes"] \
        == ref["argument_bytes"][arch, kind]
    assert cell["cost"]["flops"] > 0 and cell["cost"]["bytes accessed"] > 0
    assert cell["memory"]["temp_bytes"] > 0


def test_small_cells_count_every_kernel_on_meta():
    """Each kernel of the path is one operator a call on ``meta``: K4 twice
    a layer in a train step (remat) and its backward once, K5 three times
    an MoE layer and its backward once a product, K6 once a layer."""
    mesh = _small_mesh()
    n = _small("qwen3-1.7b").n_layers
    k = PD.cost_cell(_small("qwen3-1.7b"), PC.ShapeConfig("t", "train", 64,
                                                          8), mesh)["kernels"]
    assert (k["flash_attention"]["calls"],
            k["flash_attention_bwd"]["calls"]) == (2 * n, n)
    assert set(k) == {"flash_attention", "flash_attention_bwd"}
    dbrx = _small("dbrx-132b")
    k = PD.cost_cell(dbrx, PC.ShapeConfig("t", "train", 64, 8),
                     mesh)["kernels"]
    assert (k["moe_gemm"]["calls"], k["moe_gemm_bwd"]["calls"]) == (
        6 * dbrx.n_layers, 3 * dbrx.n_layers)
    rwkv = _small("rwkv6-1.6b")
    k = PD.cost_cell(rwkv, PC.ShapeConfig("t", "prefill", 64, 8),
                     mesh)["kernels"]
    assert set(k) == {"rwkv6"} and k["rwkv6"]["calls"] == rwkv.n_layers
    assert k["rwkv6"]["on_meta"].startswith("fake result")
    k = PD.cost_cell(rwkv, PC.ShapeConfig("t", "train", 64, 8),
                     mesh)["kernels"]
    assert (k["rwkv6"]["calls"], k["rwkv6_bwd"]["calls"]) == (
        2 * rwkv.n_layers, rwkv.n_layers)


# the tensor-parallel cells: (arch, kind, the tp_reduce bytes of the
# busiest position, its tp_exchange bytes) on (4, 2), batch 8 (2 rows a
# data shard), seq 64, d 64, 2 layers, bfloat16 compute.  The first model
# position receives each reduction's M - 1 = 1 partial and sends the sum
# back: (M - 1) n (partial bytes + result bytes) for n elements.  The
# embedding's partials are bfloat16 (2 + 2), the sub-layers' float32
# (4 + 2) over n = rows x tokens x d; rwkv adds each layer's sums of
# squares, float32 both ways (4 + 4) over n = rows x tokens.  paligemma's
# one K/V head (16 columns) splits over the two positions: each receives
# the other's 8 columns of k and of v in every layer and sends its own.
_ROWS, _D, _L, _S = 2, 64, 2, 64
TP_CELLS = [
    ("qwen3-1.7b", "decode",
     _ROWS * _D * (2 + 2) + _L * 2 * _ROWS * _D * (4 + 2), 0),
    ("rwkv6-1.6b", "prefill",
     _ROWS * _S * _D * (2 + 2) + _L * (_ROWS * _S * (4 + 4)
                                       + 2 * _ROWS * _S * _D * (4 + 2)), 0),
    ("paligemma-3b", "prefill",
     _ROWS * _S * _D * (2 + 2) + _L * 2 * _ROWS * _S * _D * (4 + 2),
     _L * 2 * 2 * _ROWS * _S * 8 * 2)]


@pytest.mark.parametrize("arch,kind,reduce,exchange", TP_CELLS)
def test_tp_reduce_bytes_match_the_formula(arch, kind, reduce, exchange):
    """A tensor-parallel cell is costed as one model position's step: the
    collectives ``tp_reduce`` and ``tp_exchange`` of the busiest position
    equal the formulas above, its param gather is its model slice (less
    what it stores), and K4 / K6 run once a layer on its heads."""
    cfg = _small(arch)
    mesh = _small_mesh()
    cell = PD.cost_cell(cfg, PC.ShapeConfig("t", kind, _S, 8), mesh)
    per_op = cell["coll"].per_op
    assert cfg.n_layers == _L and cfg.d_model == _D
    assert cell["n_model_shards"] == 2 and cell["n_data_shards"] == 4
    assert per_op["tp_reduce"] == reduce
    assert per_op["tp_exchange"] == exchange
    assert 0 < per_op["param_gather"] < sum(
        x.numel() * x.element_size() for _, x in PD._walk(
            PD.M.abstract_params(cfg))) / 2
    calls = {k: v["calls"] for k, v in cell["kernels"].items()}
    assert calls == ({} if kind == "decode" else {
        "rwkv6" if cfg.mixer == "rwkv" else "flash_attention": _L})


# the MoE serving cells on (4, 2), batch 8 (2 rows a data shard, 4 data
# shards), seq 64, 2 layers, 4 experts top-2, bfloat16 compute: (arch,
# kind).  The first model position routes each MoE layer and sends the
# other (M - 1 = 1) its slot map: ``dest`` (int64) and the gates (float32)
# over R x T x k entries, ``slot_token`` (int64) over R x E x cap slots,
# R x T the routed rows x tokens (a prefill: its 2 rows of 64 tokens, each
# row bundled at ``expert_capacity(64, ...)``; a decode step: the global
# batch as one row of 8, at ``expert_capacity(8, ...)``).  A decode step
# moves the other 3 data shards' 2 rows (d bfloat16 values each) onto the
# first shard's position and back.
EP_CELLS = [("dbrx-132b", "prefill"), ("dbrx-132b", "decode"),
            ("kimi-k2-1t-a32b", "prefill"), ("kimi-k2-1t-a32b", "decode")]


@pytest.mark.parametrize("arch,kind", EP_CELLS)
def test_moe_cells_take_the_expert_parallel_route(arch, kind):
    """An MoE serving cell is costed as one model position's step on its
    experts: K5 three times a layer (its expert SwiGLU), K4 once a layer in
    a prefill, and the moves ``ep_route`` and ``ep_rows`` (decode only)
    equal to the formulas above, listed beside ``tp_reduce``."""
    from repro_torch.models.moe import expert_capacity
    cfg = _small(arch)
    cell = PD.cost_cell(cfg, PC.ShapeConfig("t", kind, _S, 8),
                        _small_mesh())
    assert cell["n_model_shards"] == 2 and cell["n_data_shards"] == 4
    per_op = cell["coll"].per_op
    k, e = cfg.moe_top_k, cfg.n_experts
    r, t = (1, 8) if kind == "decode" else (_ROWS, _S)
    cap = expert_capacity(t, e, k, cfg.capacity_factor)
    route = r * t * k * (8 + 4) + r * e * cap * 8
    assert per_op["ep_route"] == _L * route
    assert per_op.get("ep_rows", 0) == (
        _L * 2 * 3 * _ROWS * _D * 2 if kind == "decode" else 0)
    assert per_op["tp_reduce"] > 0
    calls = {n: v["calls"] for n, v in cell["kernels"].items()}
    assert calls == dict({"moe_gemm": 3 * _L}, **(
        {"flash_attention": _L} if kind == "prefill" else {}))


# a train cell on (4, 2) (2 rows a data shard, M = 2 model positions, both
# as busy: each receives the other's partials or sends its own, and the
# sums back), qwen3-1.7b reduced, bfloat16 compute: the embedding's
# reduction (bfloat16 both ways, 2 + 2, over n = rows x tokens x d) in
# the forward and the backward; each layer's two sub-layer reductions
# (float32 partials, bfloat16 sums: 4 + 2) in the forward and the
# backward, and under remat the attention's once more in the recompute
# (non-reentrant checkpointing stops recomputing once the last tensor the
# backward needs is back, before the FFN's reduction); the loss's three
# float32 statistics a token to the first position and their gradients
# back (3 x 4 each way over rows x tokens)
_N = _ROWS * _S * _D
TRAIN_TP_REDUCE = 2 * _N * (2 + 2) + _L * (2 + 1 + 2) * _N * (4 + 2) \
    + 2 * _ROWS * _S * 3 * 4


def test_train_cell_takes_the_route_through_dense_partials_backward(
        monkeypatch):
    """A train cell on ``(4, 2)`` is one model position's step in bfloat16
    on ``meta``: its forward and backward, ``dense_partial``'s backward
    (the card's float32-output product) once a row-split product, K4 twice
    a layer (remat) and its backward once, ``tp_reduce`` equal to
    ``TRAIN_TP_REDUCE``, each layer's slices fetched twice (the recompute)
    and the embedding once; its argument bytes every param's shard."""
    from repro_torch.models import layers as PL
    from repro_torch.parallel import sharding as S
    calls, backward = [], PL._MmFloat32.backward

    def counted(ctx, g):
        calls.append(g.shape)
        return backward(ctx, g)
    monkeypatch.setattr(PL._MmFloat32, "backward", staticmethod(counted))
    cfg = _small("qwen3-1.7b")
    mesh = _small_mesh()
    shape = PC.ShapeConfig("t", "train", _S, 8)
    cell = PD.cost_cell(cfg, shape, mesh)
    assert cell["n_model_shards"] == 2 and cell["tp_position"] == 0
    # wo and w_down a layer, each a backward
    assert len(calls) == 2 * _L
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == {
        "flash_attention": 2 * _L, "flash_attention_bwd": _L}
    assert cell["coll"].per_op["tp_reduce"] == TRAIN_TP_REDUCE
    assert cell["coll"].per_op["grad_reduce"] > 0
    seen = {}
    PD._run_tp_cell(cfg, shape, mesh, S.params_shardings(cfg, mesh),
                    CostMode(), 0, seen)
    assert seen[("embed",)] == 1 and seen[("final_norm",)] == 1
    assert all(n == 2 for path, n in seen.items() if path[0] == "layers")


def test_full_size_train_cell_fits_a_device():
    """qwen3-1.7b's ``train_4k`` at full size and depth on the 16x16 mesh
    of ``meta`` devices: one model position's step, under 80 GiB a device
    (the storage route gathered every param and the whole vocabulary's
    float32 logits onto each data shard: some 200 GiB)."""
    cfg = PC.get_config("qwen3-1.7b")
    mesh = PD.make_production_mesh(devices=["meta"] * 256)
    cell = PD.cost_cell(cfg, PC.SHAPES["train_4k"], mesh)
    assert cell["n_model_shards"] == 16
    mem = cell["memory"]
    total = mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"] - mem["alias_bytes"]
    assert 0 < total < 80 * 2 ** 30


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_production_moe_cells_fetch_a_slice_of_the_experts(arch):
    """On the 16x16 mesh the MoE serving cells take the tensor-parallel
    route, and the lone costed position fetches, of a layer's expert
    stacks and shared experts, 1/16 (its experts, its columns), of its
    router the whole."""
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.tensor_parallel import tp_route
    cfg = PC.get_config(arch)
    mesh = PD.make_production_mesh(devices=["meta"] * 256)
    assert tp_route(cfg, mesh)
    fetch = PD._meta_fetch(cfg, S.params_shardings(cfg, mesh))
    got = fetch(("layers", "pos0", "ffn"), 0, rank=3)
    assert len(got) == 1
    whole = PD.M.abstract_params(cfg)["layers"]["pos0"]["ffn"]
    names = ["w_gate", "w_up", "w_down"] + (
        ["shared_gate", "shared_up", "shared_down"]
        if cfg.n_shared_experts else [])
    assert set(got[0]) == set(names) | {"router"}
    for name in names:
        assert got[0][name].numel() * 16 == whole[name][0].numel(), name
    assert got[0]["router"].shape == whole["router"].shape[1:]
    assert got[0]["w_gate"].shape[0] == cfg.n_experts // 16


def test_one_full_size_cell(tmp_path):
    """qwen3-1.7b ``decode_32k`` at full size and depth on the 16x16 mesh
    of ``meta`` devices, through the CLI, under its own time limit."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=FULL_CELL_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK]   qwen3-1.7b__decode_32k__16x16" in r.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b__decode_32k__16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert set(rec) >= {"arch", "shape", "mesh", "n_chips", "compile_s",
                        "memory", "scan_correction", "roofline",
                        "model_flops_global", "total_params",
                        "model_vs_hlo_flops"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "total_nonaliased_gib"}
    assert rec["scan_correction"] == {"applied": False}
    cfg = PC.get_config("qwen3-1.7b")
    mf, total = PR.model_flops(cfg, PC.SHAPES["decode_32k"])
    assert (rec["model_flops_global"], rec["total_params"]) == (mf, total)
    r = rec["roofline"]
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    assert r["collective_per_op"]["param_gather"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    # the donated cache is aliased; its shard is in the arguments
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"][
        "argument_bytes"]


# -- the engine ---------------------------------------------------------------------

def test_cost_mode_counts_flops_and_bytes():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    with CostMode() as mode:
        c = a @ b
        d = c.t()                              # a view: nothing moves
        e = d.sum()
    s = mode.summary()
    assert s["flops"] == 2 * 64 * 32 * 16
    assert s["bytes"] == (64 * 32 + 32 * 16 + 64 * 16) * 4 \
        + (64 * 16 + 1) * 4
    assert s["temp_bytes"] == (64 * 16 + 1) * 4
    assert e.shape == () and s["kernels"] == {}


def test_kernels_on_meta_are_one_operator_each():
    dev = "meta"
    q = torch.empty((2, 8, 256, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.empty((2, 4, 256, 64), dtype=torch.bfloat16, device=dev)
    x = torch.empty((6, 16, 64), device=dev)
    w = torch.empty((3, 64, 32), device=dev)
    r = torch.empty((2, 4, 128, 16), device=dev)
    v = torch.empty((2, 4, 128, 32), device=dev)
    u = torch.empty((4, 16), device=dev)
    with CostMode() as mode:
        o = kops.flash_attention(q, kv, kv, causal=True, window=100)
        y = kops.moe_gemm(x, w, [0, 1, 2, 0, 1, 2])
        o6, st = kops.rwkv6(r, r, v, r, u, chunk=32)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert y.shape == (6, 16, 32) and y.dtype == x.dtype
    assert o6.shape == (2, 4, 128, 32) and st.shape == (2, 4, 16, 32)
    assert o6.dtype == st.dtype == torch.float32
    k = mode.summary()["kernels"]
    pairs = _meta.attention_pairs(256, True, 100)
    assert pairs == sum(min(i + 1, 100) for i in range(256))
    assert k["flash_attention"] == {"calls": 1,
                                    "flops": 4 * 2 * 8 * pairs * 64}
    assert k["moe_gemm"] == {"calls": 1, "flops": 2 * 6 * 16 * 64 * 32}
    assert k["rwkv6"]["calls"] == 1
    assert k["rwkv6"]["flops"] == _meta.k6_flop(r.shape, v.shape, 32)
    assert mode.summary()["aten_ops"] == 3
    # the operators compute nothing: a host tensor never reaches them
    with pytest.raises(RuntimeError, match="meta tensors only"):
        _meta.ops()["flash_attention"](q.new_empty(q.shape, device="cpu"),
                                       *(kv.new_empty(kv.shape,
                                                      device="cpu"),) * 2,
                                       True, 0, 0.0, 0.125)


def test_kernel_backward_on_meta():
    q = torch.empty((1, 4, 64, 16), device="meta", requires_grad=True)
    r = torch.empty((1, 2, 64, 16), device="meta", requires_grad=True)
    x = torch.empty((4, 8, 16), device="meta", requires_grad=True)
    w = torch.empty((2, 16, 16), device="meta", requires_grad=True)
    with CostMode() as mode:
        o = kops.flash_attention(q, q, q)
        o6, st = kops.rwkv6(r, r, r, r, torch.empty((2, 16), device="meta"),
                            chunk=16)
        y = kops.moe_gemm(x, w, [0, 1, 0, 1], bk=16, bf=16)
        (o.sum() + o6.sum() + st.sum() + y.sum()).backward()
    k = mode.summary()["kernels"]
    assert {n: c["calls"] for n, c in k.items()} == {
        "flash_attention": 1, "flash_attention_bwd": 1, "rwkv6": 1,
        "rwkv6_bwd": 1, "moe_gemm": 1, "moe_gemm_bwd": 1}
    assert q.grad.shape == q.shape and r.grad.shape == r.shape
    assert x.grad.shape == x.shape and w.grad.shape == w.shape

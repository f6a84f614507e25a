"""Sharded execution of the port (``launch/mesh.py``, ``parallel/sharding.py``,
``runtime/shard.py`` and the three ``shard_plan`` hooks) on the CPU.

A mesh of repeated ``cpu`` devices stands in for a fleet, as the
reference's tests force several host devices into one process.  Every
shardable op is bit-for-bit the single-host result at 1, 3 and 8 shards,
cold, warm and through a plan store (mirroring
``tests/test_op_conformance.py``).  Against the reference at 4 shards, run
in a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
as ``tests/test_distributed.py`` does: ``ShardedPlan`` bounds and per-shard
plans bit-identical, fingerprint digests with ``("shards", 4)`` equal,
gather values within the reference's tolerance, MoE bundles and SpMM values
exact, and a ``ShardedPlan`` written by either package's plan store read by
the other's.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.parallel.sharding as ref_sharding
import repro_torch.core as P
from _torch_parity import assert_csr_match, assert_same_fields
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding
from repro_torch.runtime import ReapRuntime
from repro_torch.runtime import ops as _ops
from repro_torch.runtime.plan_cache import deserialize_plan, serialize_plan
from repro_torch.runtime.shard import (ShardedPlan, data_shard_count,
                                       shard_bounds, shard_devices,
                                       sharded_spgemm_gather)

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"
CONCRETE = [t for t in _ops.list_ops() if _ops.get_op(t).route is None]
SHARDABLE = [t for t in CONCRETE if _ops.get_op(t).capabilities.shardable]
SHARD_COUNTS = [1, 3, 8]

_A = P.random_csr(150, 150, 0.04, np.random.default_rng(0), "banded")
_W = P.random_csr(128, 96, 0.06, np.random.default_rng(3), "blocky")
_TOKENS = np.random.default_rng(4).standard_normal((40, 16)).astype(
    np.float32)
_ROUTE8 = np.random.default_rng(5).integers(0, 8, (40, 2))
_ROUTE6 = np.random.default_rng(6).integers(0, 6, (40, 2))
_X16 = np.random.default_rng(7).standard_normal((16, 128)).astype(
    np.float32)
_X5 = _X16[:5].copy()

# tag -> (operands, run kw, runtime overrides)
CASES = {
    "spgemm_gather": ((_A, _A), {}, dict(tile=64)),
    "spmm": ((_X16, _W), {}, dict(block=32)),
    "moe_dispatch": ((_TOKENS, _ROUTE8), dict(n_experts=8), {}),
}


def _mesh(n):
    return make_mesh((n,), ("data",), [CPU] * n)


def _runtime(tag, **extra):
    return ReapRuntime(n_chunks=1, overlap=False, device=CPU,
                       **CASES[tag][2], **extra)


def _arrays(result):
    """Every value array of an op result (CSR → its three arrays)."""
    if isinstance(result, P.CSR):
        return [result.indptr, result.indices, result.data]
    if isinstance(result, np.ndarray):
        return [result]
    if torch.is_tensor(result):
        return [result.numpy()]
    if isinstance(result, tuple):
        return [a for r in result for a in _arrays(r)]
    return []


def _assert_bits(r0, r1):
    a0, a1 = _arrays(r0), _arrays(r1)
    assert a0 and len(a0) == len(a1)
    for x0, x1 in zip(a0, a1):
        assert x0.dtype == x1.dtype and x0.shape == x1.shape
        assert x0.tobytes() == x1.tobytes()


# ---------------------------------------------------------------------------
# The mesh and the axis helpers
# ---------------------------------------------------------------------------

class TestMesh:
    def test_explicit_devices_may_repeat(self):
        mesh = make_mesh((2, 3), ("pod", "data"), ["cpu"] * 6)
        assert mesh.devices.shape == (2, 3)
        assert mesh.axis_names == ("pod", "data")
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)

    @pytest.mark.parametrize("shape,axes,devices", [
        ((2,), ("data",), ["cpu"] * 3),        # too many devices
        ((2,), ("data", "model"), ["cpu"] * 2),  # rank mismatch
        ((0,), ("data",), []),                 # empty axis
    ])
    def test_bad_meshes_raise(self, shape, axes, devices):
        with pytest.raises(ValueError):
            make_mesh(shape, axes, devices)

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((2,), ("data",), ["cuda:0"] * 2)
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((2,), ("data",))

    @pytest.mark.parametrize("shape,axes", [
        ((4,), ("data",)), ((2, 4), ("pod", "data")),
        ((4, 2), ("data", "model")), ((2, 2), ("pipe", "model"))])
    def test_axis_helpers_match_reference(self, shape, axes):
        """The reference's helpers read only ``axis_names`` and
        ``devices.shape``, so both run on the port's mesh."""
        mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
        assert sharding.dp_axes(mesh) == ref_sharding.dp_axes(mesh)
        for names in (None, "data", ("pod", "data"), ("model",)):
            assert sharding.axis_size(mesh, names) == \
                ref_sharding.axis_size(mesh, names)
            for dim in (6, 8):
                assert sharding.guarded(mesh, dim, names) == \
                    ref_sharding.guarded(mesh, dim, names)

    def test_shard_devices_follow_the_data_axes(self):
        devs = ["cpu"] * 8
        mesh = make_mesh((4, 2), ("data", "model"), devs)
        assert data_shard_count(mesh) == 4
        assert len(shard_devices(mesh)) == 4
        mesh = make_mesh((2, 4), ("pod", "data"), devs)
        assert data_shard_count(mesh) == len(shard_devices(mesh)) == 8

    @pytest.mark.parametrize("n,k", [(10, 3), (2, 8), (0, 4), (150, 8)])
    def test_shard_bounds_match_reference(self, n, k):
        from repro.runtime.shard import shard_bounds as ref_bounds
        b = shard_bounds(n, k)
        assert b.dtype == np.int64 and b.shape == (k + 1,)
        assert b.tobytes() == ref_bounds(n, k).tobytes()


# ---------------------------------------------------------------------------
# Sharded against single-host, bit for bit (mirrors test_op_conformance.py)
# ---------------------------------------------------------------------------

def test_expected_ops_are_shardable():
    """The three data-parallel ops admit sharding; declarations and hooks
    agree registry-wide — and match the reference's declarations."""
    from repro.runtime import ops as ref_ops
    assert set(SHARDABLE) >= {"spgemm_gather", "spmm", "moe_dispatch"}
    for tag in CONCRETE:
        spec = _ops.get_op(tag)
        assert (spec.shard_plan is not None) == spec.capabilities.shardable
        assert spec.capabilities.shardable == \
            ref_ops.get_op(tag).capabilities.shardable


@pytest.mark.parametrize("n", SHARD_COUNTS)
@pytest.mark.parametrize("tag", SHARDABLE)
def test_sharded_vs_single_host_bit_for_bit(tag, n):
    operands, kw, _ = CASES[tag]
    r0, _ = _runtime(tag).run(tag, *operands, **kw)
    rt = _runtime(tag)
    r1, s1 = rt.run(tag, *operands, mesh=_mesh(n), **kw)
    assert not s1["cache_hit"]
    assert s1["n_shards"] == n
    _assert_bits(r0, r1)
    # warm: the shard artifact round-trips the cache keyed by
    # (fingerprint, shards) and reproduces the same bits
    r2, s2 = rt.run(tag, *operands, mesh=_mesh(n), **kw)
    assert s2["cache_hit"]
    _assert_bits(r0, r2)


@pytest.mark.parametrize("n", SHARD_COUNTS)
@pytest.mark.parametrize("tag", SHARDABLE)
def test_sharded_store_round_trip(tag, n, tmp_path):
    """A fresh runtime sharing the plan store answers the sharded call from
    disk and still matches the single-host result exactly."""
    operands, kw, _ = CASES[tag]
    r0, _ = _runtime(tag).run(tag, *operands, **kw)
    store = str(tmp_path / "plans")
    _runtime(tag, store_dir=store).run(tag, *operands, mesh=_mesh(n), **kw)
    r2, s2 = _runtime(tag, store_dir=store).run(tag, *operands,
                                                mesh=_mesh(n), **kw)
    assert s2["store_hit"] and s2["cache_hit"]
    _assert_bits(r0, r2)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("n", [3, 8])
def test_spmm_token_counts_below_the_shard_count(t, n):
    """Shards of one row, or none, still give the single-host bits (no
    shard falls onto the one-row product path when the call has more)."""
    x = _X16[:t]
    y0, _ = _runtime("spmm").run("spmm", x, _W)
    y1, st = _runtime("spmm").run("spmm", x, _W, mesh=_mesh(n))
    assert st["method"] == "spmm_sharded" and y1.shape == (t, _W.n_cols)
    assert y0.tobytes() == y1.tobytes()


@pytest.mark.parametrize("n,sharded", [(3, True), (4, False), (5, False)])
def test_moe_dispatch_falls_back_when_experts_do_not_divide(n, sharded):
    (b0, _), _ = _runtime("moe_dispatch").run(
        "moe_dispatch", _TOKENS, _ROUTE6, n_experts=6)
    (b1, plan), st = _runtime("moe_dispatch").run(
        "moe_dispatch", _TOKENS, _ROUTE6, n_experts=6, mesh=_mesh(n))
    assert st["sharded"] is sharded and st["method"] == "dispatch_sharded"
    assert b0.tobytes() == b1.tobytes() and plan.n_experts == 6


def test_moe_dispatch_tensor_tokens_give_tensor_bundles():
    tokens = torch.from_numpy(_TOKENS)
    (b0, _), _ = _runtime("moe_dispatch").run(
        "moe_dispatch", tokens, _ROUTE8, n_experts=8)
    (b1, _), st = _runtime("moe_dispatch").run(
        "moe_dispatch", tokens, _ROUTE8, n_experts=8, mesh=_mesh(4))
    assert st["sharded"] and torch.is_tensor(b1)
    assert torch.equal(b0, b1)


def test_fingerprints_are_namespaced_by_shard_count():
    """``("shards", n)`` joins the fingerprint's params: the pattern digest
    stays, but each mesh extent misses and keeps a cache entry of its
    own."""
    operands, kw, _ = CASES["spgemm_gather"]
    rt = _runtime("spgemm_gather")
    _, s0 = rt.run("spgemm_gather", *operands, **kw)
    for n in (1, 3, 8):
        _, st = rt.run("spgemm_gather", *operands, mesh=_mesh(n), **kw)
        assert not st["cache_hit"]
        assert st["fingerprint"] == s0["fingerprint"]
    assert len(rt.cache) == 4
    shards = sorted(dict(fp.params).get("shards", 0)
                    for fp in rt.cache._entries)
    assert shards == [0, 1, 3, 8]


def test_mesh_shape_is_the_default_and_an_explicit_mesh_wins():
    operands, kw, _ = CASES["spgemm_gather"]
    rt = _runtime("spgemm_gather", mesh_shape=(3,))
    _, s1 = rt.run("spgemm_gather", *operands, **kw)
    assert s1["method"] == "gather_sharded" and s1["n_shards"] == 3
    _, s2 = rt.run("spgemm_gather", *operands, mesh=_mesh(8), **kw)
    assert s2["n_shards"] == 8
    # a two-axis shape is (pod, data), both data-parallel, as in the
    # reference
    rt2 = _runtime("spgemm_gather", mesh_shape=(2, 2))
    _, s3 = rt2.run("spgemm_gather", *operands, **kw)
    assert s3["n_shards"] == 4
    # non-shardable ops ignore the mesh
    blk = P.random_csr(64, 64, 0.1, np.random.default_rng(9), "blocky")
    _, s4 = rt.run("spgemm_block", blk, blk)
    assert s4["method"] == "block" and "n_shards" not in s4


def test_sharded_plan_serializes_and_keeps_per_shard_plans():
    _, _, plan = sharded_spgemm_gather(_A, _A, _mesh(3), tile=64)
    assert isinstance(plan, ShardedPlan) and len(plan.plans) == 3
    again = deserialize_plan(serialize_plan(plan))
    assert_same_fields(plan, again)
    assert sum(p.c_nnz for p in plan.plans) == \
        P.spgemm_ref_numpy(_A, _A).nnz


# ---------------------------------------------------------------------------
# Against the reference at 4 shards (one subprocess for the module)
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import pickle, sys
import numpy as np
from repro.core import CSR
from repro.launch.mesh import make_mesh
from repro.runtime import ReapRuntime
from repro.runtime.plan_cache import serialize_plan
from repro.runtime.shard import sharded_spgemm_gather

inp = pickle.load(open(sys.argv[1], "rb"))
port_store, ref_store, out_path = sys.argv[2], sys.argv[3], sys.argv[4]
a, w = CSR(*inp["a"]), CSR(*inp["w"])
mesh = make_mesh((4,), ("data",))
calls = {
    "spgemm_gather": ((a, a), {}, dict(tile=64)),
    "spmm16": ((inp["x16"], w), {}, dict(block=32)),
    "spmm5": ((inp["x5"], w), {}, dict(block=32)),
    "moe8": ((inp["tokens"], inp["route8"]), dict(n_experts=8), {}),
    "moe6": ((inp["tokens"], inp["route6"]), dict(n_experts=6), {}),
}
out = {"n_devices": len(mesh.devices.flat)}
_, _, plan = sharded_spgemm_gather(a, a, mesh, tile=64)
out["plan"] = serialize_plan(plan)


def tag_of(name):
    return "spgemm_gather" if name == "spgemm_gather" else \
        "spmm" if name.startswith("spmm") else "moe_dispatch"


def values(result):
    if isinstance(result, CSR):
        return [result.indptr, result.indices, result.data]
    if isinstance(result, tuple):
        return [np.asarray(result[0])]
    return [np.asarray(result)]


for name, (operands, kw, rkw) in calls.items():
    base = dict(n_chunks=1, overlap=False, **rkw)
    r, st = ReapRuntime(store_dir=ref_store, **base).run(
        tag_of(name), *operands, mesh=mesh, **kw)
    r2, st2 = ReapRuntime(store_dir=port_store, **base).run(
        tag_of(name), *operands, mesh=mesh, **kw)
    out[name] = dict(values=values(r), fingerprint=st["fingerprint"],
                     method=st["method"], n_shards=st["n_shards"],
                     sharded=st.get("sharded"),
                     port_store_hit=bool(st2["store_hit"]),
                     port_store_values=values(r2))
pickle.dump(out, open(out_path, "wb"))
"""


def _csr_tuple(a):
    return (a.n_rows, a.n_cols, a.indptr, a.indices, a.data)


_REF_CALLS = {
    "spgemm_gather": ("spgemm_gather", (_A, _A), {}, dict(tile=64)),
    "spmm16": ("spmm", (_X16, _W), {}, dict(block=32)),
    "spmm5": ("spmm", (_X5, _W), {}, dict(block=32)),
    "moe8": ("moe_dispatch", (_TOKENS, _ROUTE8), dict(n_experts=8), {}),
    "moe6": ("moe_dispatch", (_TOKENS, _ROUTE6), dict(n_experts=6), {}),
}


def _port_call(name, **extra):
    tag, operands, kw, rkw = _REF_CALLS[name]
    rt = ReapRuntime(n_chunks=1, overlap=False, device=CPU, **rkw, **extra)
    return rt.run(tag, *operands, mesh=_mesh(4), **kw)


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """The reference's sharded results at 4 forced host devices, and its
    reads of a plan store the port wrote at 4 shards."""
    tmp = tmp_path_factory.mktemp("ref4")
    port_store, ref_store = tmp / "port_plans", tmp / "ref_plans"
    for name in _REF_CALLS:
        _port_call(name, store_dir=str(port_store))
    inp = dict(a=_csr_tuple(_A), w=_csr_tuple(_W), x16=_X16, x5=_X5,
               tokens=_TOKENS, route8=_ROUTE8, route6=_ROUTE6)
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    script = tmp / "ref4.py"
    script.write_text(textwrap.dedent(_REF_SCRIPT))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, str(script), str(tmp / "in.pkl"), str(port_store),
         str(ref_store), str(tmp / "out.pkl")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    assert out["n_devices"] == 4
    out["ref_store"] = str(ref_store)
    return out


def test_sharded_plan_matches_reference(ref4):
    _, _, plan = sharded_spgemm_gather(_A, _A, _mesh(4), tile=64)
    ref_plan = deserialize_plan(ref4["plan"])      # the port's types
    assert isinstance(ref_plan, ShardedPlan)
    assert ref_plan.bounds.tobytes() == plan.bounds.tobytes()
    assert_same_fields(plan, ref_plan)
    assert serialize_plan(plan).keys() == ref4["plan"].keys()


@pytest.mark.parametrize("name", list(_REF_CALLS))
def test_sharded_fingerprints_and_stats_match_reference(name, ref4):
    _, st = _port_call(name)
    ref = ref4[name]
    assert st["fingerprint"] == ref["fingerprint"]
    assert (st["method"], st["n_shards"], st.get("sharded")) == \
        (ref["method"], ref["n_shards"], ref["sharded"])


def test_gather_values_match_reference(ref4):
    c, _ = _port_call("spgemm_gather")
    indptr, indices, data = ref4["spgemm_gather"]["values"]
    assert_csr_match(c, P.CSR(c.n_rows, c.n_cols, indptr, indices, data))


@pytest.mark.parametrize("name", ["moe8", "moe6"])
def test_moe_bundles_match_reference_exactly(name, ref4):
    (bundles, _), _ = _port_call(name)
    want = ref4[name]["values"][0]
    assert bundles.dtype == want.dtype and bundles.tobytes() == \
        want.tobytes()


@pytest.mark.parametrize("name", ["spmm16", "spmm5"])
def test_spmm_values_match_reference(name, ref4):
    y, _ = _port_call(name)
    np.testing.assert_allclose(y, ref4[name]["values"][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", list(_REF_CALLS))
def test_plan_store_crosses_packages_both_ways(name, ref4):
    """The reference answers a sharded call from the port's plan store, and
    the port from the reference's, each with its own results."""
    ref = ref4[name]
    assert ref["port_store_hit"]
    for x0, x1 in zip(ref["values"], ref["port_store_values"]):
        assert x0.tobytes() == x1.tobytes()
    r0, _ = _port_call(name)
    r1, st = _port_call(name, store_dir=ref4["ref_store"])
    assert st["store_hit"]
    _assert_bits(r0, r1)

"""Registry-wide conformance battery of the port, mirroring
``tests/test_op_conformance.py`` over ``repro_torch.runtime.list_ops()`` on
the CPU: every concrete op has an example; its plan is pure (fresh values →
same fingerprint, bit-identical payload); its payload round-trips
bit-stably; a same-pattern call hits the cache; where a chunked executor
exists it agrees with the sync one; capabilities are well-formed.  Each op
a later slice registers needs an entry in ``EXAMPLES``."""
import dataclasses

import numpy as np
import pytest

import repro_torch.core as P
from repro_torch.runtime import ReapRuntime, RuntimeConfig
from repro_torch.runtime import ops as _ops
from repro_torch.runtime.plan_cache import deserialize_plan, serialize_plan

CPU = "cpu"
ALL_TAGS = _ops.list_ops()
CONCRETE = [t for t in ALL_TAGS if _ops.get_op(t).route is None]
CHUNKED = [t for t in CONCRETE if _ops.get_op(t).execute_chunked is not None]

_GEN = P.random_csr(128, 128, 0.04, np.random.default_rng(0), "banded")
_BLK = P.random_csr(128, 128, 0.08, np.random.default_rng(1), "blocky")
_SPD = P.random_spd_csr(96, 0.06, np.random.default_rng(2))
_W = P.random_csr(128, 96, 0.06, np.random.default_rng(3), "blocky")
_MASK = P.random_csr(128, 128, 0.03, np.random.default_rng(4), "blocky")
_ROUTING = np.random.default_rng(5).integers(0, 6, (40, 2))


def _revalue(a, seed):
    vals = np.random.default_rng(seed).standard_normal(a.nnz)
    if a is _SPD:       # keep it positive definite: scale, do not redraw
        vals = a.data * (1.0 + 0.1 * np.abs(vals))
    return P.CSR(a.n_rows, a.n_cols, a.indptr, a.indices,
                 vals.astype(a.data.dtype))


def _dense(seed, shape):
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(
        np.float32)


# tag -> (operands(value_seed), runtime overrides)
EXAMPLES = {
    "spgemm_gather": (lambda s: (_revalue(_GEN, s),) * 2, {}),
    "spgemm_block": (lambda s: (_revalue(_BLK, s),) * 2, dict(block=16)),
    "cholesky": (lambda s: (_revalue(_SPD, s),), {}),
    "spmm": (lambda s: (_dense(s, (16, 128)), _revalue(_W, s)),
             dict(block=32)),
    "spmv": (lambda s: (_revalue(_SPD, s), _dense(s, (96,)).astype(
        np.float64)), dict(block=32)),
    "block_attention": (lambda s: (*(_dense(s + i, (1, 2, 128, 16))
                                     for i in range(3)),
                                   _revalue(_MASK, s)), dict(block=32)),
    "moe_dispatch": (lambda s: (_dense(s, (40, 16)), _ROUTING), {}),
}
_KW = {"moe_dispatch": dict(n_experts=6)}


def _runtime(tag, **extra):
    kw = dict(n_chunks=1, overlap=False, device=CPU)
    kw.update(EXAMPLES[tag][1], **extra)
    return ReapRuntime(**kw)


def _payload(tag, seed):
    spec = _ops.get_op(tag)
    operands = EXAMPLES[tag][0](seed)
    cfg = RuntimeConfig(n_chunks=1, overlap=False, device=CPU,
                        **EXAMPLES[tag][1])
    kw = dict(_KW.get(tag, {}))
    if spec.prepare is not None:
        kw = spec.prepare(operands, cfg, **kw)
    fp = spec.fingerprint(operands, cfg, chunked=False, **kw)
    return fp, serialize_plan(spec.inspect(operands, cfg, fp, **kw))


def _values(result):
    if isinstance(result, P.CSR):
        return [result.indptr, result.indices, result.data]
    if isinstance(result, tuple):
        return [v for r in result for v in _values(r)]
    return [result] if isinstance(result, np.ndarray) else []


def _same_payload(p, q):
    return sorted(p) == sorted(q) and all(
        np.asarray(p[k]).dtype == np.asarray(q[k]).dtype
        and np.asarray(p[k]).tobytes() == np.asarray(q[k]).tobytes()
        for k in p)


@pytest.mark.parametrize("tag", CONCRETE)
def test_example_coverage_and_capabilities(tag):
    assert tag in EXAMPLES, f"op {tag!r} has no conformance example"
    spec = _ops.get_op(tag)
    summary = _ops.capability_summary(spec)
    assert summary["routing"] in _ops.CAPABILITY_ROUTINGS
    assert summary["dtypes"]
    assert summary["chunked"] == (spec.execute_chunked is not None)


@pytest.mark.parametrize("tag", CONCRETE)
def test_plan_purity_and_round_trip(tag):
    fp0, pay0 = _payload(tag, 0)
    fp1, pay1 = _payload(tag, 1)
    assert fp0 == fp1
    assert _same_payload(pay0, pay1)
    plan = deserialize_plan(pay0)
    assert dataclasses.is_dataclass(plan)
    assert _same_payload(serialize_plan(plan), pay0)


@pytest.mark.parametrize("tag", CONCRETE)
def test_cache_hit_same_result(tag):
    rt = _runtime(tag)
    operands = EXAMPLES[tag][0](3)
    first, s0 = rt.run(tag, *operands, **_KW.get(tag, {}))
    again, s1 = rt.run(tag, *operands, **_KW.get(tag, {}))
    assert not s0["cache_hit"] and s1["cache_hit"]
    for u, v in zip(_values(first), _values(again)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("tag", CONCRETE)
def test_store_round_trip(tag, tmp_path):
    """A fresh runtime sharing ``store_dir`` answers from disk, with the
    same result."""
    operands = EXAMPLES[tag][0](5)
    kw = _KW.get(tag, {})
    first, s0 = _runtime(tag, store_dir=str(tmp_path)).run(tag, *operands,
                                                           **kw)
    fresh = _runtime(tag, store_dir=str(tmp_path))
    again, s1 = fresh.run(tag, *operands, **kw)
    assert not s0["cache_hit"] and s1["cache_hit"] and s1["store_hit"]
    assert s1["fingerprint"] == s0["fingerprint"]
    assert fresh.cache_stats()["per_op"][tag]["store_hits"] == 1
    for u, v in zip(_values(first), _values(again)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("tag", CHUNKED)
@pytest.mark.parametrize("overlap", [False, True])
def test_chunked_matches_sync(tag, overlap):
    operands = EXAMPLES[tag][0](4)
    sync, _ = _runtime(tag).run(tag, *operands, **_KW.get(tag, {}))
    chunked, st = _runtime(tag, n_chunks=4, overlap=overlap).run(
        tag, *operands, **_KW.get(tag, {}))
    assert st["n_chunks"] > 1
    for u, v in zip(_values(chunked), _values(sync)):
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6)

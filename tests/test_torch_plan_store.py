"""The port's plan store and fleet store: the cases of
``tests/test_plan_store.py`` and ``tests/test_shared_store.py`` on
``repro_torch.runtime`` (warm restart, corruption heal, schema move-aside,
byte-budget GC, refcounted blob GC with its grace window, the CLIs), and
stores shared with ``repro``: a store written by either package is read by
the other, one pattern inspected by both into one fleet directory leaves
one blob, and the port's GC spares the blobs a reference ``exec/``
manifest holds."""
import json
import os

import numpy as np
import pytest
from _torch_parity import assert_same_fields

import repro.core as R
import repro.runtime as RR
import repro_torch.core as P
import repro_torch.runtime as PR
from repro_torch.runtime import PlanCache, PlanStore, SharedBlobs
from repro_torch.runtime.plan_store import (MANIFEST, SCHEMA_VERSION,
                                            fingerprint_from_json,
                                            fingerprint_to_json, store_key)
from repro_torch.runtime.plan_store import main as plan_store_cli
from repro_torch.runtime.shared_store import main as shared_store_cli

CPU = "cpu"


def _rand(pkg, n, density, seed, pattern="uniform"):
    return pkg.random_csr(n, n, density, np.random.default_rng(seed),
                          pattern)


def _payloads(store_dir):
    d = store_dir / "plans"
    return sorted(p for p in d.iterdir() if not p.name.startswith(".")) \
        if d.is_dir() else []


def _gather_fp(a):
    return P.fingerprint_pattern("spgemm_gather", (a, a), tile=1024)


def _port_rt(**kw):
    return PR.ReapRuntime(device=CPU, n_chunks=1, overlap=False, **kw)


def _ref_rt(**kw):
    return RR.ReapRuntime(n_chunks=1, overlap=False, use_pallas=False, **kw)


def _write_manifest(root, shas):
    root.mkdir(parents=True, exist_ok=True)
    entries = {f"k{i}": dict(payload=f"blob:{sha}", bytes=1, last_used=0.0)
               for i, sha in enumerate(shas)}
    (root / MANIFEST).write_text(json.dumps(
        dict(schema=SCHEMA_VERSION, entries=entries)))


# ---------------------------------------------------------------------------
# The port's own store
# ---------------------------------------------------------------------------

class TestPlanStore:
    def test_fingerprint_json_round_trip(self):
        a = _rand(P, 30, 0.1, 0)
        fp = P.fingerprint_pattern("spgemm_block", (a, a), block=16)
        back = fingerprint_from_json(json.loads(json.dumps(
            fingerprint_to_json(fp))))
        assert back == fp and hash(back) == hash(fp)
        assert store_key(back) == store_key(fp)

    def test_all_op_tags_restart_warm(self, tmp_path):
        rng = np.random.default_rng(50)
        ga, ba = _rand(P, 70, 0.08, 51), _rand(P, 64, 0.1, 52, "blocky")
        spd = P.random_spd_csr(50, 0.08, rng)
        eids = rng.integers(0, 8, (48, 2))
        tokens = rng.standard_normal((48, 16)).astype(np.float32)

        def run(rt):
            return [rt.spgemm(ga, ga, method="gather")[1],
                    rt.spgemm(ba, ba, method="block")[1],
                    rt.cholesky(spd)[2],
                    rt.moe_dispatch(tokens, eids, n_experts=8)[2]]

        kw = dict(device=CPU, store_dir=str(tmp_path), n_chunks=3, block=16)
        rt1 = PR.ReapRuntime(**kw)
        assert not any(st["cache_hit"] for st in run(rt1))
        assert rt1.store.stats.saves >= 4
        rt2 = PR.ReapRuntime(**kw)                  # a restarted process
        warm = run(rt2)
        assert all(st["cache_hit"] and st["store_hit"] for st in warm)
        assert rt2.store.stats.loads >= 4
        assert rt2.cache_stats()["store"]["entries"] >= 4

    def _populated(self, tmp_path):
        a = _rand(P, 60, 0.08, 21)
        fp, plan = _gather_fp(a), P.inspect_spgemm_gather(a, a)
        PlanStore(tmp_path).put(fp, plan)
        return fp, plan

    @pytest.mark.parametrize("damage", ["truncate", "flip"])
    def test_corrupt_payload_misses(self, tmp_path, damage):
        fp, _ = self._populated(tmp_path)
        payload = _payloads(tmp_path)[0]
        blob = bytearray(payload.read_bytes())
        if damage == "truncate":
            blob = blob[:64]
        else:
            blob[len(blob) // 2] ^= 0xFF
        payload.write_bytes(bytes(blob))
        store = PlanStore(tmp_path)
        assert store.get(fp) is None and store.stats.corrupt == 1
        assert len(store) == 0

    def test_runtime_heals_corruption(self, tmp_path):
        a = _rand(P, 80, 0.08, 23)
        _port_rt(store_dir=str(tmp_path)).spgemm(a, a, method="gather")
        for payload in _payloads(tmp_path):
            payload.write_bytes(payload.read_bytes()[:32])
        rt2 = _port_rt(store_dir=str(tmp_path))
        c, st = rt2.spgemm(a, a, method="gather")
        assert not st["cache_hit"]                  # rebuilt transparently
        np.testing.assert_allclose(c.to_dense(),
                                   P.spgemm_ref_numpy(a, a).to_dense(),
                                   rtol=1e-4, atol=1e-5)
        report = rt2.store.verify()
        assert report["ok"] and not report["corrupt"]   # healed

    @pytest.mark.parametrize("manifest", ["schema", "garbage"])
    def test_bad_manifest_moved_aside(self, tmp_path, manifest):
        fp, plan = self._populated(tmp_path)
        path = tmp_path / MANIFEST
        if manifest == "schema":
            data = json.loads(path.read_text())
            data["schema"] = SCHEMA_VERSION + 1
            path.write_text(json.dumps(data))
        else:
            path.write_text("{not json")
        store = PlanStore(tmp_path)
        assert store.get(fp) is None and len(store) == 0
        assert (tmp_path / "manifest.corrupt").exists()
        store.put(fp, plan)                         # still usable
        assert PlanStore(tmp_path).get(fp) is not None

    def test_byte_budget_evicts_lru(self, tmp_path):
        store = PlanStore(tmp_path, byte_budget=None)
        fps = []
        for i in range(4):
            a = _rand(P, 50 + i, 0.1, 30 + i)
            fps.append(_gather_fp(a))
            store.put(fps[-1], P.inspect_spgemm_gather(a, a))
        total = store.summary()["bytes"]
        store.get(fps[0])                           # 0 becomes MRU
        assert store.gc(byte_budget=total // 2)
        assert store.summary()["bytes"] <= total // 2
        assert fps[0] in store and fps[1] not in store
        assert len(_payloads(tmp_path)) == len(store)

    def test_orphans_swept_and_capacity_zero_skips_store(self, tmp_path):
        fp, _ = self._populated(tmp_path)
        (tmp_path / "plans" / "deadbeef.npz").write_bytes(b"orphan")
        PlanStore(tmp_path).gc()
        assert not (tmp_path / "plans" / "deadbeef.npz").exists()
        cache = PlanCache(capacity=0, store=PlanStore(tmp_path))
        assert cache.get(fp) is None and cache.store.stats.loads == 0

    def test_cli(self, tmp_path, capsys):
        fp, _ = self._populated(tmp_path)
        assert plan_store_cli(["ls", str(tmp_path)]) == 0
        assert "spgemm_gather" in capsys.readouterr().out
        assert plan_store_cli(["verify", str(tmp_path)]) == 0
        assert "1 ok, 0 corrupt" in capsys.readouterr().out
        assert plan_store_cli(["gc", str(tmp_path), "--budget-mb", "0"]) == 0
        assert PlanStore(tmp_path).get(fp) is None

    def test_no_store_by_default(self):
        rt = _port_rt()
        assert rt.store is None and "store" not in rt.cache_stats()


class TestSharedBlobs:
    def test_gc_removes_only_unreferenced(self, tmp_path):
        blobs = SharedBlobs(tmp_path / "s")
        live, dead = blobs.add(b"live"), blobs.add(b"dead")
        assert blobs.add(b"live") == live           # dedup
        _write_manifest(blobs.store_root("plans"), [live])
        _write_manifest(blobs.store_root("exec"), [live])
        assert blobs.refcounts() == {live: 2}
        assert blobs.gc(grace_s=0.0) == [dead]
        _write_manifest(blobs.store_root("plans"), [])
        assert blobs.gc(grace_s=0.0) == []          # exec still holds it
        _write_manifest(blobs.store_root("exec"), [])
        assert blobs.gc(grace_s=0.0) == [live]

    def test_grace_window_and_mtime_refresh(self, tmp_path):
        blobs = SharedBlobs(tmp_path / "s")
        sha = blobs.add(b"mid-publish")
        assert blobs.gc() == [] and blobs.path(sha).exists()
        os.utime(blobs.path(sha), (1.0, 1.0))
        blobs.add(b"mid-publish")                   # dedup hit refreshes
        assert blobs.path(sha).stat().st_mtime > 1.0

    def test_verify_reports(self, tmp_path):
        blobs = SharedBlobs(tmp_path / "s")
        ok, unref = blobs.add(b"referenced"), blobs.add(b"unreferenced")
        bad = blobs.add(b"will be corrupted")
        blobs.path(bad).write_bytes(b"mutated in place")
        _write_manifest(blobs.store_root("plans"), [ok, "0" * 64])
        report = blobs.verify()
        assert report["ok"] == [ok] and bad in report["corrupt"]
        assert unref in report["unreferenced"]
        assert report["dangling"] == ["0" * 64]

    def test_runtime_fleet_store(self, tmp_path, capsys):
        root = tmp_path / "fleet"
        a = _rand(P, 160, 0.04, 7)
        rt = _port_rt(shared_store_dir=str(root))
        c0, _ = rt.spgemm(a, a, method="gather")
        entries = rt.store._entries or {}
        assert entries and all(str(e["payload"]).startswith("blob:")
                               for e in entries.values())
        junk = rt.shared.add(b"no manifest references this")
        live = set(rt.shared.refcounts())
        removed = rt.shared.gc(grace_s=0.0)
        assert removed == [junk] and not set(removed) & live
        rt2 = _port_rt(shared_store_dir=str(root))  # answers from disk
        c2, st = rt2.spgemm(a, a, method="gather")
        assert st["store_hit"]
        np.testing.assert_array_equal(c0.data, c2.data)
        assert shared_store_cli(["ls", str(root)]) == 0
        assert "blobs" in capsys.readouterr().out
        assert shared_store_cli(["verify", str(root)]) == 0
        assert "0 corrupt" in capsys.readouterr().out
        rt2.store.gc(byte_budget=0)                 # drop every ref
        assert shared_store_cli(["gc", str(root), "--grace-s", "0"]) == 0
        assert not list(rt.shared.blob_dir.iterdir())


# ---------------------------------------------------------------------------
# Stores shared by the two packages
# ---------------------------------------------------------------------------

def _calls(pkg, rt, op):
    """One call of ``op`` on ``rt`` (inputs from fixed seeds through
    ``pkg``'s own formats) → its stats."""
    rng = np.random.default_rng(60)
    if op == "spgemm_block":
        a = _rand(pkg, 64, 0.1, 61, "blocky")
        return rt.spgemm(a, a, method="block")[1]
    if op == "cholesky":
        spd = pkg.random_spd_csr(60, 0.08, rng)
        return rt.cholesky(spd)[2]
    ids = rng.integers(0, 8, (48, 2))
    tokens = rng.standard_normal((48, 16)).astype(np.float32)
    return rt.moe_dispatch(tokens, ids, n_experts=8)[2]


OPS = ["spgemm_block", "cholesky", "moe_dispatch"]


class TestCrossPackage:
    @pytest.mark.parametrize("op", OPS)
    @pytest.mark.parametrize("writer", ["reference", "port"])
    def test_store_read_by_the_other_package(self, tmp_path, op, writer):
        kw = dict(store_dir=str(tmp_path), block=16)
        pkgs = [(R, _ref_rt(**kw)), (P, _port_rt(**kw))]
        if writer == "port":
            pkgs.reverse()
        (w_pkg, w_rt), (r_pkg, r_rt) = pkgs
        st_w = _calls(w_pkg, w_rt, op)
        assert not st_w["cache_hit"]
        st_r = _calls(r_pkg, r_rt, op)
        assert st_r["store_hit"] and st_r["fingerprint"] == st_w["fingerprint"]
        # equal plan arrays, each read by its own package's store
        (fp_p,) = PlanStore(tmp_path).fingerprints()
        (fp_r,) = RR.PlanStore(tmp_path).fingerprints()
        plan_p = PlanStore(tmp_path).get(fp_p)
        plan_r = RR.PlanStore(tmp_path).get(fp_r)
        assert type(plan_p).__module__.startswith("repro_torch.")
        assert type(plan_r).__module__.startswith("repro.")
        assert_same_fields(plan_p, plan_r)

    @pytest.mark.parametrize("first", ["reference", "port"])
    def test_one_pattern_one_blob_in_a_fleet(self, tmp_path, first):
        root = tmp_path / "fleet"
        rts = [(R, lambda: _ref_rt(shared_store_dir=str(root), block=16)),
               (P, lambda: _port_rt(shared_store_dir=str(root), block=16))]
        if first == "port":
            rts.reverse()
        stats = [_calls(pkg, make(), "spgemm_block") for pkg, make in rts]
        assert not stats[0]["store_hit"] and stats[1]["store_hit"]
        plans = SharedBlobs(root).refcounts()
        manifest = json.loads((root / "plans" / MANIFEST).read_text())
        plan_refs = {e["payload"][5:] for e in manifest["entries"].values()}
        assert len(plan_refs) == 1 and plans[plan_refs.pop()] == 1

    def test_port_gc_spares_reference_exec_blobs(self, tmp_path):
        root = tmp_path / "fleet"
        rt_r = _ref_rt(shared_store_dir=str(root))
        a = _rand(R, 120, 0.05, 70)
        rt_r.spgemm(a, a, method="gather")          # plans/ and exec/ refs
        exec_manifest = json.loads((root / "exec" / MANIFEST).read_text())
        exec_shas = {e["payload"][5:] for e in
                     exec_manifest["entries"].values()}
        assert exec_shas, "the reference wrote no executable refs"
        blobs = SharedBlobs(root)
        junk = blobs.add(b"unreferenced")
        live = set(blobs.refcounts())
        assert exec_shas <= live
        assert blobs.gc(grace_s=0.0) == [junk]
        assert all(blobs.path(s).exists() for s in live)
        # the reference still answers from the swept fleet directory
        rt_r2 = _ref_rt(shared_store_dir=str(root))
        _, st = rt_r2.spgemm(a, a, method="gather")
        assert st["store_hit"] and st["exec_cache_hit"]

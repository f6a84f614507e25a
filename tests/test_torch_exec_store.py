"""The port's kernel-library store (``runtime/exec_store.py``), its wiring
through ``kernels/_build.py``, ``ReapRuntime``, ``ServeScheduler.prewarm``
and the serve CLI, on the CPU.

The failure modes mirror ``tests/test_exec_store.py`` with ``nvcc``
replaced by a fake compiler (a script that writes bytes derived from the
source) and ``dlopen`` by a recorder that refuses anything but the fake
compiler's output, so a corrupt payload that reached ``dlopen`` would fail
the test:

* a corrupt payload is a counted miss that rebuilds, never loaded;
* an environment mismatch is a miss, never a crash;
* the disk LRU keeps to its budget, at put time too;
* a corrupt manifest restarts empty;
* a fresh process over a populated store runs zero compiles;
* ``ls``, ``verify`` and ``gc`` work;
* each package's blob GC spares the other's refs in a fleet directory.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import repro.configs as RC
import repro.launch.scheduler as RS
import repro.launch.serve as RV
import repro.models.model as RM
import repro.runtime.shared_store as ref_shared
import repro_torch.configs as PC
import repro_torch.core as P
import repro_torch.launch.scheduler as PS
import repro_torch.launch.serve as PV
import repro_torch.models.model as PM
import _fake_toolchain as fake_toolchain
from _fake_toolchain import KERNELS
from repro_torch.kernels import _build
from repro_torch.runtime import (ReapRuntime, RuntimeConfig,
                                 add_runtime_args, default_runtime,
                                 set_default_runtime)
from repro_torch.runtime import ops as _ops
from repro_torch.runtime.exec_store import (LIB_DIR, ExecCache, ExecStore,
                                           current_exec_cache, environment,
                                           use_exec_cache)
from repro_torch.runtime.exec_store import main as exec_store_cli
from repro_torch.runtime.shared_store import KERNELS_SUBDIR, SharedBlobs

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = "cpu"


@pytest.fixture
def fake(monkeypatch, tmp_path):
    return fake_toolchain.install(monkeypatch, tmp_path)


_good = fake_toolchain.good


def _populate(root, names=KERNELS):
    cache = ExecCache(ExecStore(root))
    libs = cache.load_many(names)
    assert cache.stats.compiles == len(names) and cache.stats.loads == 0
    assert cache.stats.saves == len(names)
    return {n: lib.blob for n, lib in libs.items()}


# ---------------------------------------------------------------------------
# Memory → store → nvcc
# ---------------------------------------------------------------------------

class TestExecCache:
    def test_environment_names_the_toolchain_and_card(self, fake):
        env = environment()
        assert set(env) == {"nvcc", "torch", "cuda", "device_name",
                            "capability"}
        assert env["nvcc"] == "Cuda compilation tools, release 0.0, fake-1"
        assert env["device_name"] == "none"     # this machine has no card

    def test_build_once_then_load_from_the_store(self, fake, tmp_path):
        built = _populate(tmp_path / "exec")
        assert set(built) == set(KERNELS)
        cache = ExecCache(ExecStore(tmp_path / "exec"))
        libs = cache.load_many(KERNELS)
        assert cache.stats.compiles == 0 and cache.stats.loads == 6
        assert {n: lib.blob for n, lib in libs.items()} == built
        assert all(_good(b) for b in fake)

    def test_memory_hits_and_no_store(self, fake):
        cache = ExecCache()
        a = cache.load("bsr_spmm")
        assert cache.load("bsr_spmm") is a
        assert (cache.stats.compiles, cache.stats.mem_hits) == (1, 1)
        assert cache.summary()["mem_entries"] == 1

    def test_load_resolves_through_the_cache_in_effect(self, fake, tmp_path):
        cache = ExecCache(ExecStore(tmp_path / "exec"))
        assert current_exec_cache() is None
        with use_exec_cache(cache):
            assert current_exec_cache() is cache
            lib = _build.load("rwkv6_scan")
            assert _build.load_all("rwkv6_scan", "moe_gemm")["rwkv6_scan"] \
                is lib
        assert cache.stats.compiles == 2 and len(cache.store) == 2
        assert not _build.BUILD_DIR.joinpath(
            _build.library_path("rwkv6_scan").name).exists()
        # with none in effect: the digest-named library under BUILD_DIR
        lib2 = _build.load("rwkv6_scan")
        assert _build.library_path("rwkv6_scan").exists()
        assert lib2.blob == lib.blob and _build.load("rwkv6_scan") is lib2

    def test_failed_build_raises_and_stores_nothing(self, fake, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("FAKE_NVCC_FAIL", "moe_gemm")
        cache = ExecCache(ExecStore(tmp_path / "exec"))
        with pytest.raises(RuntimeError, match="kernel build failed"):
            cache.load_many(("bsr_spmm", "moe_gemm"))
        assert len(cache.store) == 0 and not fake

    def test_source_or_flags_change_the_key(self, fake, tmp_path,
                                            monkeypatch):
        _populate(tmp_path / "exec", ("bsr_spmm",))
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
        cache = ExecCache(ExecStore(tmp_path / "exec"))
        cache.load("bsr_spmm")
        assert cache.stats.compiles == 1 and len(cache.store) == 2


# ---------------------------------------------------------------------------
# Failure modes (mirrors tests/test_exec_store.py)
# ---------------------------------------------------------------------------

class TestFailureModes:
    def test_corrupt_payload_rebuilds_without_dlopen(self, fake, tmp_path):
        root = tmp_path / "exec"
        built = _populate(root, ("flash_attention",))
        fake.clear()
        payloads = list((root / LIB_DIR).glob("*.so"))
        assert len(payloads) == 1
        blob = bytearray(payloads[0].read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        payloads[0].write_bytes(bytes(blob))

        store = ExecStore(root)
        cache = ExecCache(store)
        lib = cache.load("flash_attention")
        assert lib.blob == built["flash_attention"]       # rebuilt, equal
        assert bytes(blob) not in fake and all(_good(b) for b in fake)
        assert store.stats.corrupt == 1
        assert (cache.stats.compiles, cache.stats.saves) == (1, 1)
        # and the healed store loads cleanly in yet another "process"
        cache3 = ExecCache(ExecStore(root))
        cache3.load("flash_attention")
        assert (cache3.stats.compiles, cache3.stats.loads) == (0, 1)

    def test_unloadable_bytes_never_reach_dlopen(self, fake, tmp_path):
        """Bytes that are not a library but match a (forged) digest would
        reach dlopen; a digest mismatch never does: the payload is
        replaced with garbage of another length."""
        root = tmp_path / "exec"
        _populate(root, ("bsr_spgemm",))
        fake.clear()
        next((root / LIB_DIR).glob("*.so")).write_bytes(b"\x7fELF garbage")
        cache = ExecCache(ExecStore(root))
        cache.load("bsr_spgemm")
        assert fake and all(_good(b) for b in fake)

    def test_env_mismatch_is_a_miss_not_a_crash(self, fake, tmp_path):
        root = tmp_path / "exec"
        built = _populate(root, ("rwkv6_scan",))
        store = ExecStore(root)
        stored_key = next(iter(store._load_manifest_locked()))
        store.env = dict(store.env, device_name="another card")
        assert store.get(stored_key) is None
        assert store.stats.env_miss == 1
        # the env is folded into the cache key too, so the mismatched
        # process builds under its own key and both entries coexist
        cache = ExecCache(store)
        assert cache.load("rwkv6_scan").blob == built["rwkv6_scan"]
        assert cache.stats.compiles == 1
        fresh = ExecStore(root)
        assert len(fresh) == 2
        report = fresh.verify()
        assert not report["corrupt"] and len(report["stale_env"]) == 1

    def test_disk_lru_respects_byte_budget(self, fake, tmp_path):
        root = tmp_path / "exec"
        store = ExecStore(root, byte_budget=None)
        cache = ExecCache(store)
        cache.load_many(KERNELS)
        assert cache.stats.saves == 6
        sizes = [int(e["bytes"])
                 for e in store._load_manifest_locked().values()]
        assert len(set(sizes)) > 1
        budget = sum(sorted(sizes)[:2]) + max(sizes) // 2
        evicted = store.gc(budget)
        assert evicted
        s = store.summary()
        assert s["bytes"] <= budget
        assert s["entries"] == 6 - len(evicted)
        assert len(list((root / LIB_DIR).glob("*.so"))) == s["entries"]

    def test_put_time_gc_under_tiny_budget(self, fake, tmp_path):
        root = tmp_path / "exec"
        probe = ExecStore(root, byte_budget=None)
        ExecCache(probe).load("bsr_spmm")
        one = probe.summary()["bytes"]
        probe.clear()
        store = ExecStore(root, byte_budget=int(one * 1.5))
        ExecCache(store).load_many(("bsr_spmm", "bsr_spmm", "rwkv6_scan",
                                    "moe_gemm"))
        assert store.stats.evicted >= 1
        assert store.summary()["bytes"] <= int(one * 1.5)

    def test_corrupt_manifest_restarts_empty(self, fake, tmp_path):
        root = tmp_path / "exec"
        _populate(root, ("bsr_spmm",))
        (root / "manifest.json").write_text("{not json")
        store = ExecStore(root)
        assert len(store) == 0
        assert store.stats.corrupt == 1
        assert (root / "manifest.corrupt").exists()
        cache = ExecCache(store)
        cache.load("bsr_spmm")
        assert cache.stats.compiles == 1 and len(store) == 1

    def test_corrupt_shared_blob_is_discarded_and_rebuilt(self, fake,
                                                          tmp_path):
        blobs = SharedBlobs(tmp_path / "fleet")
        store = ExecStore(blobs.store_root(KERNELS_SUBDIR), shared=blobs)
        built = ExecCache(store).load("moe_gemm").blob
        sha = hashlib.sha256(built).hexdigest()
        blobs.path(sha).write_bytes(b"rot")
        fake.clear()
        store2 = ExecStore(blobs.store_root(KERNELS_SUBDIR), shared=blobs)
        cache = ExecCache(store2)
        assert cache.load("moe_gemm").blob == built
        assert store2.stats.corrupt == 1 and cache.stats.compiles == 1
        assert blobs.path(sha).read_bytes() == built
        assert all(_good(b) for b in fake)


# ---------------------------------------------------------------------------
# A fresh process over a populated store runs no compiler
# ---------------------------------------------------------------------------

_RESTART = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[3])
from _fake_toolchain import KERNELS, install


class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


install(Patch(), Path(sys.argv[2]))
from repro_torch.runtime.exec_store import ExecCache, ExecStore
store = ExecStore(sys.argv[1])
cache = ExecCache(store)
libs = cache.load_many(KERNELS)
print("COMPILES", cache.stats.compiles)
print("LOADS", cache.stats.loads)
print("CORRUPT", store.stats.corrupt)
print("NAMES", ",".join(sorted(lib.name for lib in libs.values())))
"""


class TestWarmRestartE2E:
    def test_fresh_process_runs_no_compiler(self, tmp_path):
        script = tmp_path / "restart.py"
        script.write_text(_RESTART)
        env = dict(os.environ, PYTHONPATH=SRC)
        tests_dir = str(Path(__file__).resolve().parent)

        def run():
            out = subprocess.run(
                [sys.executable, str(script), str(tmp_path / "exec"),
                 str(tmp_path / "tool"), tests_dir],
                capture_output=True, text=True, env=env, timeout=300)
            assert out.returncode == 0, out.stderr
            rows = dict(line.split(" ", 1)
                        for line in out.stdout.splitlines() if " " in line)
            assert rows["NAMES"] == ",".join(sorted(KERNELS))
            return int(rows["COMPILES"]), int(rows["LOADS"]), \
                int(rows["CORRUPT"])

        (tmp_path / "tool").mkdir()
        assert run() == (6, 0, 0)
        assert run() == (0, 6, 0)
        payload = sorted((tmp_path / "exec" / LIB_DIR).glob("*.so"))[0]
        payload.write_bytes(payload.read_bytes()[:-7] + b"corrupt")
        assert run() == (1, 5, 1)
        assert run() == (0, 6, 0)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

class TestCLI:
    def test_ls_verify_gc(self, fake, tmp_path, capsys):
        root = tmp_path / "exec"
        _populate(root, ("bsr_spmm",))
        assert exec_store_cli(["ls", str(root)]) == 0
        out = capsys.readouterr().out
        assert "1 kernel libraries" in out and "bsr_spmm" in out
        assert exec_store_cli(["verify", str(root)]) == 0
        assert "1 ok, 0 corrupt" in capsys.readouterr().out
        next((root / LIB_DIR).glob("*.so")).write_bytes(b"garbage")
        assert exec_store_cli(["verify", str(root)]) == 1
        assert "1 corrupt" in capsys.readouterr().out
        assert exec_store_cli(["verify", str(root), "--prune"]) == 0
        capsys.readouterr()
        assert exec_store_cli(["ls", str(root)]) == 0
        assert "empty" in capsys.readouterr().out

    def test_gc_budget(self, fake, tmp_path, capsys):
        root = tmp_path / "exec"
        _populate(root, ("bsr_spmm",))
        assert exec_store_cli(["gc", str(root), "--budget-mb", "0"]) == 0
        assert "evicted 1 entries" in capsys.readouterr().out

    def test_module_entry_point(self, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.runtime.exec_store", "ls",
             str(tmp_path / "none")], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
        assert out.returncode == 0 and "empty" in out.stdout


# ---------------------------------------------------------------------------
# The runtime: flags, exec_cache_hit, the fleet layout
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_op():
    """A registered op whose executor loads K2's library, as a CUDA
    executor does on its first launch."""
    spec = _ops.get_op("spmm")

    def execute(plan, operands, cfg, *, overlap, **kw):
        _build.load("bsr_spmm")
        return spec.execute_sync(plan, operands, cfg, overlap=overlap, **kw)

    _ops.register_op(_ops.OpSpec(
        tag="spmm_loading_k2", fingerprint=spec.fingerprint,
        inspect=spec.inspect, execute_sync=execute,
        allowed_kw=("dtype",)))
    yield "spmm_loading_k2"
    _ops.unregister_op("spmm_loading_k2")


class TestRuntime:
    def test_from_args_takes_the_full_flag_set(self):
        parser = argparse.ArgumentParser()
        add_runtime_args(parser)
        cfg = RuntimeConfig.from_args(parser.parse_args(
            ["--plan-store", "p", "--plan-store-budget-mb", "2",
             "--exec-store", "e", "--exec-store-budget-mb", "3.5",
             "--shared-store", "f", "--mesh-shape", "2x4",
             "--cache-entries", "5", "--n-chunks", "2", "--no-overlap",
             "--no-kernel", "--device", "cpu"]))
        assert (cfg.store_dir, cfg.store_budget_bytes) == ("p", 2_000_000)
        assert (cfg.exec_store_dir, cfg.exec_budget_bytes) == \
            ("e", 3_500_000)
        assert cfg.shared_store_dir == "f" and cfg.mesh_shape == (2, 4)
        assert (cfg.cache_entries, cfg.n_chunks, cfg.overlap,
                cfg.use_kernel, cfg.device) == (5, 2, False, False, "cpu")
        help_text = parser.format_help()
        assert "raises" not in help_text and "not ported" not in help_text

    def test_config_fields_cover_the_reference(self):
        import dataclasses

        import repro.runtime.api as RA
        ref = {f.name for f in dataclasses.fields(RA.RuntimeConfig)}
        port = {f.name for f in dataclasses.fields(RuntimeConfig)}
        # the port names the reference's use_pallas ``use_kernel`` and adds
        # the executors' device
        assert ref - {"use_pallas"} <= port
        assert port - ref == {"use_kernel", "device"}

    def test_mesh_and_exec_store_construct_and_run(self, tmp_path):
        rt = ReapRuntime(RuntimeConfig(mesh_shape=(4,),
                                       exec_store_dir=str(tmp_path / "e"),
                                       device=CPU))
        a = P.random_csr(80, 80, 0.05, np.random.default_rng(0))
        c, st = rt.run("spgemm_gather", a, a)
        assert st["method"] == "gather_sharded" and st["n_shards"] == 4
        assert st["exec_cache_hit"] is True     # no kernel on the host
        np.testing.assert_allclose(c.to_dense(),
                                   P.spgemm_ref_numpy(a, a).to_dense(),
                                   rtol=1e-5, atol=1e-5)
        assert rt.cache_stats()["exec"]["compiles"] == 0

    def test_run_reports_exec_cache_hit(self, fake, kernel_op, tmp_path):
        w = P.random_csr(64, 64, 0.1, np.random.default_rng(1))
        x = np.ones((3, 64), np.float32)
        rt = ReapRuntime(device=CPU, block=16,
                         exec_store_dir=str(tmp_path / "e"))
        _, s1 = rt.run(kernel_op, x, w)
        _, s2 = rt.run(kernel_op, x, w)
        assert (s1["exec_cache_hit"], s2["exec_cache_hit"]) == (False, True)
        rt2 = ReapRuntime(device=CPU, block=16,
                          exec_store_dir=str(tmp_path / "e"))
        _, s3 = rt2.run(kernel_op, x, w)
        assert s3["exec_cache_hit"] is True
        assert (rt2.exec.stats.loads, rt2.exec.stats.compiles) == (1, 0)
        # no exec store: the stat is absent
        _, s4 = ReapRuntime(device=CPU, block=16).run(kernel_op, x, w)
        assert "exec_cache_hit" not in s4

    def test_shared_store_attaches_both_halves(self, tmp_path):
        rt = ReapRuntime(device=CPU, shared_store_dir=str(tmp_path / "f"))
        assert rt.store.root == tmp_path / "f" / "plans"
        assert rt.exec.store.root == tmp_path / "f" / KERNELS_SUBDIR
        assert rt.exec.store.shared is rt.shared
        # an explicit exec_store_dir wins over the shared layout
        rt2 = ReapRuntime(device=CPU, shared_store_dir=str(tmp_path / "f"),
                          exec_store_dir=str(tmp_path / "e"))
        assert rt2.exec.store.root == tmp_path / "e"
        assert rt2.exec.store.shared is None

    def test_default_runtime_installs_its_exec_cache(self, tmp_path):
        rt = ReapRuntime(device=CPU, exec_store_dir=str(tmp_path / "e"))
        try:
            assert set_default_runtime(rt) is default_runtime()
            assert current_exec_cache() is rt.exec
        finally:
            set_default_runtime(None)
        assert current_exec_cache() is None


class TestFleetGC:
    def _fleet(self, root):
        blobs = SharedBlobs(root)
        store = ExecStore(blobs.store_root(KERNELS_SUBDIR), shared=blobs)
        ExecCache(store).load_many(("bsr_spmm", "rwkv6_scan"))
        manifest = json.loads((root / KERNELS_SUBDIR /
                               "manifest.json").read_text())
        shas = {e["payload"][len("blob:"):]
                for e in manifest["entries"].values()}
        assert len(shas) == 2
        return blobs, shas

    def test_reference_gc_spares_port_kernel_blobs(self, fake, tmp_path):
        root = tmp_path / "fleet"
        _, shas = self._fleet(root)
        ref = ref_shared.SharedBlobs(root)
        junk = ref.add(b"unreferenced")
        assert shas <= set(ref.refcounts())
        assert ref.gc(grace_s=0.0) == [junk]
        assert all(ref.path(s).exists() for s in shas)
        # the port still loads both from the swept fleet
        cache = ExecCache(ExecStore(root / KERNELS_SUBDIR,
                                    shared=SharedBlobs(root)))
        cache.load_many(("bsr_spmm", "rwkv6_scan"))
        assert (cache.stats.compiles, cache.stats.loads) == (0, 2)

    def test_port_gc_spares_kernel_and_reference_exec_blobs(self, fake,
                                                            tmp_path):
        import repro.core as RCORE
        from repro.runtime import ReapRuntime as RefRuntime
        root = tmp_path / "fleet"
        blobs, shas = self._fleet(root)
        a = RCORE.random_csr(100, 100, 0.05, np.random.default_rng(70))
        RefRuntime(shared_store_dir=str(root)).spgemm(a, a, method="gather")
        live = set(blobs.refcounts())
        assert shas <= live and len(live) > len(shas)
        junk = blobs.add(b"unreferenced")
        assert blobs.gc(grace_s=0.0) == [junk]
        assert all(blobs.path(s).exists() for s in live)


# ---------------------------------------------------------------------------
# prewarm and the serve CLI
# ---------------------------------------------------------------------------

def _ref_and_port(arch):
    from repro_torch.models.params import params_from_numpy
    cfg = RC.reduced_config(RC.get_config(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    return cfg, params, PC.reduced_config(PC.get_config(arch)), pp


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b", "dbrx-132b"])
def test_prewarm_warms_the_reference_buckets_and_leaves_no_state(arch):
    rcfg, rparams, pcfg, pp = _ref_and_port(arch)
    trace = PS.synthetic_trace(8, seed=3, vocab=pcfg.vocab_size)
    lens = [len(r.prompt) for r in trace]
    ref = RS.ServeScheduler(rcfg, rparams, max_batch=3, max_seq=32)
    sch = PS.ServeScheduler(pcfg, pp, max_batch=3, max_seq=32, device=CPU)
    assert sch.prefill_buckets(lens) == ref.prefill_buckets(lens)
    stats = dict(sch.stats)
    assert sch.prewarm(lens) == len(ref.prefill_buckets(lens))
    assert sch.stats == stats and sch.step_idx == 0
    assert not sch.queue and sch.drained()
    assert not PM.cache_slot_occupancy(sch.cache).any()
    assert sch.latency_summary()["ttft"]["n"] == 0
    done = sch.run(trace)
    cold = PS.ServeScheduler(pcfg, pp, max_batch=3, max_seq=32,
                             device=CPU).run(trace)
    assert [(c.rid, c.tokens, c.finished_step) for c in done] == \
        [(c.rid, c.tokens, c.finished_step) for c in cold]


@pytest.mark.parametrize("arch,kernels", [
    ("qwen3-1.7b", ("flash_attention",)),
    ("gemma3-27b", ("flash_attention",)),
    ("hymba-1.5b", ("flash_attention", "rwkv6_scan")),
    ("rwkv6-1.6b", ("rwkv6_scan",)),
    ("dbrx-132b", ("flash_attention", "moe_gemm")),
    ("whisper-small", ("flash_attention",)),
])
def test_kernel_libraries_of_each_model(arch, kernels):
    assert PS.kernel_libraries(PC.get_config(arch)) == kernels


def test_prewarm_kernels_load_through_the_store(fake, tmp_path):
    """What ``prewarm`` loads on a card, through the exec cache in effect:
    a second process's cache loads them all from the store."""
    cfg = PC.get_config("hymba-1.5b")
    with use_exec_cache(ExecCache(ExecStore(tmp_path / "e"))) as c1:
        _build.load_all(*PS.kernel_libraries(cfg))
    with use_exec_cache(ExecCache(ExecStore(tmp_path / "e"))) as c2:
        _build.load_all(*PS.kernel_libraries(cfg))
    assert (c1.stats.compiles, c2.stats.compiles, c2.stats.loads) == \
        (2, 0, 2)


def test_capability_report_matches_reference():
    """The serve CLI's registered-ops report, line for line the
    reference's for every op both packages register."""
    port = PV._capability_report().splitlines()
    ref = RV._capability_report().splitlines()
    tag = lambda line: line.split(":")[0].strip()      # noqa: E731
    common = {tag(x) for x in port} & {tag(x) for x in ref}
    assert common == set(_ops.list_ops())
    assert [x for x in port if tag(x) in common] == \
        [x for x in ref if tag(x) in common]
    shardable = {tag(x) for x in port if x.endswith("+shardable")}
    assert shardable == {"spgemm_gather", "spmm", "moe_dispatch"}


_CLI = ["--arch", "qwen3-1.7b", "--continuous", "--requests", "4",
        "--max-batch", "2", "--max-seq", "32", "--device", CPU]


def test_cli_prewarm_with_exec_store_prints_the_store_and_ops(tmp_path,
                                                              capsys):
    try:
        PV.main([*_CLI, "--prewarm", "--exec-store", str(tmp_path / "e"),
                 "--expect-completions", "4"])
        assert current_exec_cache() is not None
    finally:
        set_default_runtime(None)
    out = capsys.readouterr().out
    assert "[serve] prewarmed" in out and "through the exec store" in out
    assert f"exec store {tmp_path / 'e'}: 0 kernel libraries" in out
    assert "registered ops" in out and "spmm: [float32,float64] " \
        "host+shardable" in out
    assert "exec cache: 0 nvcc runs, 0 loaded from store" in out


@pytest.mark.parametrize("extra,message", [
    ([], "requires --exec-store"),
    (["--exec-store", "STORE"], "expected zero nvcc runs"),
])
def test_cli_expect_zero_compiles_gate(extra, message, tmp_path):
    """On the host no kernel loads, so the warm-restart gate must fail: it
    needs at least one library loaded from the store."""
    extra = [str(tmp_path / "e") if x == "STORE" else x for x in extra]
    try:
        with pytest.raises(SystemExit, match=message):
            PV.main([*_CLI, "--expect-zero-compiles", *extra])
    finally:
        set_default_runtime(None)

"""Port parity, runtime: ``repro_torch.runtime.ReapRuntime(device="cpu")``
against ``repro.runtime.ReapRuntime`` — sync and chunked, overlap on and
off, plan cache hits, ``RunStats`` fields, byte-equal plan payloads that
deserialize across both packages — plus the port's guards: no JAX or
``repro`` import anywhere in the port or ``chip_smoke.py``, and entry points
that default to CUDA and raise without a card."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import (FAMILIES, assert_csr_match, family_csr,
                           revalue)

import repro.core as R
import repro.runtime as RR
import repro_torch.core as P
import repro_torch.runtime as PR

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def assert_payloads_equal(p, r):
    assert sorted(p) == sorted(r)
    for key in r:
        u, v = np.asarray(p[key]), np.asarray(r[key])
        assert u.dtype == v.dtype and u.shape == v.shape, key
        assert u.tobytes() == v.tobytes(), key


class TestRuntimeParity:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("n_chunks,overlap",
                             [(1, True), (4, False), (4, True)])
    @pytest.mark.parametrize("method", ["gather", "block"])
    def test_spgemm_matches_reference(self, family, n_chunks, overlap,
                                      method):
        a_r = family_csr(R, family, 96, 96, 0.05, 21)
        a_p = family_csr(P, family, 96, 96, 0.05, 21)
        rt_r = RR.ReapRuntime(n_chunks=n_chunks, overlap=overlap, block=16,
                              use_pallas=False)
        rt_p = PR.ReapRuntime(n_chunks=n_chunks, overlap=overlap, block=16,
                              device=CPU)
        c_r, s_r = rt_r.spgemm(a_r, a_r, method=method)
        c_p, s_p = rt_p.spgemm(a_p, a_p, method=method)
        assert_csr_match(c_p, c_r)
        assert s_p["fingerprint"] == s_r["fingerprint"]
        assert s_p["method"] == s_r["method"] and not s_p["cache_hit"]
        assert sorted(s_p) == sorted(s_r)
        # same pattern, fresh values: warm plan, still the reference's result
        c_r2, _ = rt_r.spgemm(revalue(R, a_r, 22), revalue(R, a_r, 22),
                              method=method)
        c_p2, s_p2 = rt_p.spgemm(revalue(P, a_p, 22), revalue(P, a_p, 22),
                                 method=method)
        assert s_p2["cache_hit"]
        assert_csr_match(c_p2, c_r2)

    def test_auto_route_and_cache_stats(self):
        a_p = family_csr(P, "blockdiag", 96, 96, 0.1, 23)
        a_r = family_csr(R, "blockdiag", 96, 96, 0.1, 23)
        rt_p = PR.ReapRuntime(block=16, device=CPU)
        rt_r = RR.ReapRuntime(block=16, use_pallas=False)
        c_p, s_p = rt_p.spgemm(a_p, a_p)
        c_r, s_r = rt_r.spgemm(a_r, a_r)
        assert s_p["method"] == s_r["method"] == "block_chunked"
        assert_csr_match(c_p, c_r)
        rt_p.spgemm(a_p, a_p)
        st = rt_p.cache_stats()
        assert (st["hits"], st["misses"]) == (1, 1)
        assert st["per_op"]["spgemm_block"]["warm_rate"] == 0.5

    @pytest.mark.parametrize("overlap", [False, True])
    def test_cholesky_matches_reference(self, overlap):
        a_r = R.random_spd_csr(80, 0.08, np.random.default_rng(24))
        a_p = P.random_spd_csr(80, 0.08, np.random.default_rng(24))
        _, v_r, s_r = RR.ReapRuntime().cholesky(a_r, overlap=overlap)
        rt = PR.ReapRuntime(device=CPU)
        _, v_p, s_p = rt.cholesky(a_p, overlap=overlap)
        np.testing.assert_allclose(v_p, v_r, rtol=1e-10, atol=1e-12)
        assert s_p["fingerprint"] == s_r["fingerprint"]
        assert sorted(s_p) == sorted(s_r)
        _, _, s_p2 = rt.cholesky(a_p, overlap=not overlap)
        assert s_p2["cache_hit"]

    def test_runstats_fields_mirror_reference(self):
        names = [f.name for f in dataclasses.fields(PR.RunStats)]
        assert names == [f.name for f in dataclasses.fields(RR.RunStats)]
        # every op the reference registers
        assert PR.list_ops() == RR.list_ops()
        assert PR.list_ops() == ["block_attention", "cholesky",
                                 "moe_dispatch", "spgemm", "spgemm_block",
                                 "spgemm_gather", "spmm", "spmv"]


class TestSerialization:
    @staticmethod
    def _plans(pkg, rt_pkg, gather_kw, block_kw):
        a = family_csr(pkg, "blockdiag", 96, 80, 0.06, 31)
        b = family_csr(pkg, "blockdiag", 80, 64, 0.06, 32)
        s = pkg.random_spd_csr(50, 0.1, np.random.default_rng(33))
        _, _, gset = rt_pkg.spgemm_gather_chunked(a, b, n_chunks=3,
                                                  **gather_kw)
        _, _, bset = rt_pkg.spgemm_block_chunked(a, b, block=16, n_chunks=3,
                                                 **block_kw)
        return dict(gather=pkg.inspect_spgemm_gather(a, b, 256),
                    block=pkg.inspect_spgemm_block(a, b, 16),
                    cholesky=pkg.inspect_cholesky(s),
                    gather_chunkset=gset, block_chunkset=bset)

    @pytest.mark.parametrize("kind", ["gather", "block", "cholesky",
                                      "gather_chunkset", "block_chunkset"])
    def test_payloads_byte_equal_and_cross_readable(self, kind):
        plan_p = self._plans(P, PR, dict(device=CPU), dict(device=CPU))[kind]
        plan_r = self._plans(R, RR, {}, dict(use_pallas=False))[kind]
        pay_p, pay_r = PR.serialize_plan(plan_p), RR.serialize_plan(plan_r)
        assert_payloads_equal(pay_p, pay_r)
        from_ref = PR.deserialize_plan(pay_r)       # reference → port
        to_ref = RR.deserialize_plan(pay_p)         # port → reference
        assert type(from_ref).__module__.startswith("repro_torch.")
        assert type(to_ref).__module__.startswith("repro.")
        assert_payloads_equal(PR.serialize_plan(from_ref), pay_r)
        assert_payloads_equal(RR.serialize_plan(to_ref), pay_p)

    def test_deserialized_plan_executes(self):
        a = family_csr(P, "banded", 80, 80, 0.06, 34)
        plan = P.inspect_spgemm_block(a, a, 16)
        plan2 = PR.deserialize_plan(PR.serialize_plan(plan))
        c, _ = P.spgemm(a, a, plan=plan2, device=CPU)
        c_ref, _ = P.spgemm(a, a, plan=plan, device=CPU)
        assert_csr_match(c, c_ref)


class TestGuards:
    def test_port_imports_no_jax_or_repro(self):
        """Import every module of the port in a fresh interpreter."""
        code = (
            "import pkgutil, sys, importlib, repro_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]\n"
            "assert len(mods) >= 15, mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={"PYTHONPATH": str(ROOT / "src"),
                                  "PATH": "/usr/bin:/bin"},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.strip()) >= 15

    def test_chip_smoke_imports_no_jax_or_repro(self):
        tree = ast.parse((ROOT / "chip_smoke.py").read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert "repro_torch" in roots
        assert not roots & {"jax", "jaxlib", "repro"}, roots

    def test_entry_points_default_to_cuda_and_raise_without_card(
            self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert PR.RuntimeConfig().device == "cuda"
        a = P.random_csr(20, 20, 0.2, np.random.default_rng(0))
        s = P.random_spd_csr(20, 0.2, np.random.default_rng(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PR.ReapRuntime()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.spgemm(a, a)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.cholesky(s)
        c, _ = P.spgemm(a, a, device=CPU)
        assert_csr_match(c, P.spgemm_ref_numpy(a, a))

    @pytest.mark.parametrize("field,value", [
        ("store_dir", "plans"), ("exec_store_dir", "exec"),
        ("shared_store_dir", "fleet"), ("mesh_shape", (2,))])
    def test_unported_fields_raise(self, field, value, tmp_path):
        """The executable store and the mesh still raise; the plan and
        fleet stores are ported and attach a plan store."""
        if field in ("store_dir", "shared_store_dir"):
            rt = PR.ReapRuntime(device=CPU, **{field: str(tmp_path / value)})
            assert rt.store is not None
            assert (rt.shared is not None) == (field == "shared_store_dir")
            return
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PR.ReapRuntime(device=CPU, **{field: value})

    def test_from_args(self):
        import argparse
        parser = argparse.ArgumentParser()
        PR.add_runtime_args(parser)
        cfg = PR.RuntimeConfig.from_args(parser.parse_args(
            ["--device", "cpu", "--n-chunks", "2", "--no-kernel",
             "--no-overlap", "--plan-store", "s",
             "--plan-store-budget-mb", "2.5"]), cache_entries=3)
        assert (cfg.device, cfg.n_chunks, cfg.use_kernel, cfg.overlap,
                cfg.cache_entries) == ("cpu", 2, False, False, 3)
        assert (cfg.store_dir, cfg.store_budget_bytes) == ("s", 2_500_000)
        assert PR.RuntimeConfig.from_args(parser.parse_args([])) == \
            PR.RuntimeConfig()

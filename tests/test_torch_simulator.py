"""The port's REAP analytic simulator (``repro_torch.core.simulator``)
against the reference's, on the CPU.

For seeded ``random_csr`` matrices of each pattern family and Cholesky
plans from ``random_spd_csr``, every output of ``spgemm_workload``,
``simulate_spgemm_cpu`` / ``_reap``, ``simulate_cholesky_cpu`` / ``_reap``
and ``gflops`` is bit-equal to the reference's, for all five REAP variants.
Then the model-property cases of ``tests/test_simulator_bench.py`` run on
the port's simulator.  The constants model the paper's CPU-FPGA platform,
not the H100.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.simulator as RS
from repro.core import inspect_cholesky as ref_inspect_cholesky
from repro.core import random_csr as ref_random_csr
from repro.core.formats import random_spd_csr as ref_random_spd_csr
from repro_torch.core import inspect_cholesky, random_csr, random_spd_csr
from repro_torch.core import simulator as PS

VARIANTS = ("REAP_32", "REAP_64", "REAP_128", "REAP_64C", "REAP_32C")
FAMILIES = ("uniform", "powerlaw", "banded", "blocky")


def _bits(x):
    """A float (or a dict of floats and strings) → something compared bit
    for bit."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, str):
        return x
    return np.float64(x).tobytes()


def test_constants_and_variants_equal_the_references():
    assert PS.CPU_FREQ == RS.CPU_FREQ
    assert PS.CPU_FLOPS_PER_CYCLE == RS.CPU_FLOPS_PER_CYCLE
    for name in VARIANTS:
        assert dataclasses.asdict(getattr(PS, name)) == \
            dataclasses.asdict(getattr(RS, name)), name


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,density", [(256, 0.01), (512, 2e-3),
                                       (192, 0.08)])
def test_spgemm_model_bit_equal(family, seed, n, density):
    a = random_csr(n, n, density, np.random.default_rng(seed), family)
    b = random_csr(n, n, density, np.random.default_rng(seed + 7), family)
    ra = ref_random_csr(n, n, density, np.random.default_rng(seed), family)
    rb = ref_random_csr(n, n, density, np.random.default_rng(seed + 7),
                        family)
    stats, ref_stats = PS.spgemm_workload(a, b), RS.spgemm_workload(ra, rb)
    assert _bits(stats) == _bits(ref_stats)
    for threads in (1, 4, 16):
        assert _bits(PS.cpu_cost_per_pp(stats["density"], threads)) == \
            _bits(RS.cpu_cost_per_pp(ref_stats["density"], threads))
        assert _bits(PS.simulate_spgemm_cpu(stats, threads)) == \
            _bits(RS.simulate_spgemm_cpu(ref_stats, threads))
    for name in VARIANTS:
        got = PS.simulate_spgemm_reap(stats, getattr(PS, name))
        want = RS.simulate_spgemm_reap(ref_stats, getattr(RS, name))
        assert _bits(got) == _bits(want), name
        assert _bits(PS.gflops(stats["pp"], got["total_s"])) == \
            _bits(RS.gflops(ref_stats["pp"], want["total_s"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,density", [(120, 0.05), (400, 0.02),
                                       (600, 0.05)])
def test_cholesky_model_bit_equal(seed, n, density):
    plan = inspect_cholesky(random_spd_csr(n, density,
                                           np.random.default_rng(seed)))
    ref_plan = ref_inspect_cholesky(ref_random_spd_csr(
        n, density, np.random.default_rng(seed)))
    assert _bits(PS.simulate_cholesky_cpu(plan)) == \
        _bits(RS.simulate_cholesky_cpu(ref_plan))
    for name in VARIANTS:
        got = PS.simulate_cholesky_reap(plan, getattr(PS, name))
        want = RS.simulate_cholesky_reap(ref_plan, getattr(RS, name))
        assert _bits(got) == _bits(want), name
        assert _bits(PS.gflops(plan.flops(), got["fpga_s"])) == \
            _bits(RS.gflops(ref_plan.flops(), want["fpga_s"]))


# -- the model's properties (tests/test_simulator_bench.py, on the port) ----

def _stats(density=1e-3, n=2048, seed=0):
    a = random_csr(n, n, density, np.random.default_rng(seed))
    s = PS.spgemm_workload(a, a)
    s["density"] = density
    return s


class TestSpgemmSim:
    def test_workload_counts_match_inspector(self):
        from repro_torch.core import inspect_spgemm_gather
        a = random_csr(256, 256, 0.01, np.random.default_rng(1))
        s = PS.spgemm_workload(a, a)
        plan = inspect_spgemm_gather(a, a)
        assert s["pp"] == plan.n_pp
        assert s["c_nnz"] == plan.c_nnz

    def test_reap32_memory_bound_at_14gbs(self):
        assert PS.simulate_spgemm_reap(_stats(), PS.REAP_32)["bound"] \
            == "memory"

    def test_more_pipelines_and_bw_help(self):
        s = _stats()
        t32 = PS.simulate_spgemm_reap(s, PS.REAP_32)["fpga_s"]
        t64 = PS.simulate_spgemm_reap(s, PS.REAP_64)["fpga_s"]
        assert t64 < t32

    def test_reap_beats_cpu_when_sparse(self):
        s = _stats(density=1e-3, n=8192)
        cpu = PS.simulate_spgemm_cpu(s, threads=1)
        fpga = PS.simulate_spgemm_reap(s, PS.REAP_32)["total_s"]
        assert cpu / fpga > 1.0

    def test_cpu_wins_when_dense(self):
        s = _stats(density=0.2, n=512, seed=3)
        cpu = PS.simulate_spgemm_cpu(s, threads=1)
        fpga = PS.simulate_spgemm_reap(s, PS.REAP_32)["total_s"]
        assert cpu / fpga < 1.5

    def test_cpu_cost_model_monotone_in_density(self):
        ds = [1e-5, 1e-4, 1e-3, 1e-2, 1e-1]
        costs = [PS.cpu_cost_per_pp(d) for d in ds]
        assert all(a > b for a, b in zip(costs, costs[1:]))
        assert 4.0 < costs[0] < 10.0
        assert costs[-1] < 2.5


class TestCholeskySim:
    def _plan(self, n=400, density=0.02, seed=0):
        return inspect_cholesky(random_spd_csr(n, density,
                                               np.random.default_rng(seed)))

    def test_dependency_limited_idle_grows_with_pipelines(self):
        plan = self._plan()
        i32 = PS.simulate_cholesky_reap(plan, PS.REAP_32C)["idle_frac"]
        i64 = PS.simulate_cholesky_reap(plan, PS.REAP_64C)["idle_frac"]
        assert i64 >= i32

    def test_reap64_faster_than_reap32(self):
        plan = self._plan(n=600, density=0.05, seed=2)
        t32 = PS.simulate_cholesky_reap(plan, PS.REAP_32C)["fpga_s"]
        t64 = PS.simulate_cholesky_reap(plan, PS.REAP_64C)["fpga_s"]
        assert t64 <= t32 * 1.05


def test_simulator_imports_nothing_of_jax():
    import ast
    from pathlib import Path
    tree = ast.parse(Path(PS.__file__).read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")]

"""REAP analytic performance simulator (mirrors the paper's methodology).

Port of ``repro.core.simulator``, numpy for numpy, over the port's
``formats.CSR``, ``etree.CholeskyPlan`` and
``inspector.inspect_spgemm_gather``.  Its constants are the paper's
CPU–FPGA platform (the DE5net-Arria 10 REAP variants and the Xeon 6130
baseline): it models that platform and says nothing of the H100 the
port's kernels run on.

The paper evaluates with a trace-driven cycle simulator fed by synthesized
RTL frequencies and a bandwidth-queue DRAM model (§IV "Simulation
framework").  We reproduce that model analytically from the *actual
workload statistics* of each matrix (partial-product counts, level-set
widths from our own inspector) plus the paper's hardware constants:

  REAP-N: N pipelines; 1 partial product / cycle / pipeline (CAM match +
  multiplier + sorter + merger are pipelined at 1 elem/cycle); frequency
  and bandwidth per variant from §V; FPGA time = max(compute, memory) —
  the streaming overlap the paper's design achieves.

  CPU: cost-per-partial-product model with a cache-locality term that
  falls with density (the paper's §I claim: index/match overhead is 2–5×
  the math at low locality, amortized away on denser matrices).

Calibration targets (paper): REAP-32 vs MKL-1core geomean ≈ 3.2× for
SpGEMM; REAP-32/64 vs CHOLMOD ≈ 1.18× / 1.85×; CPU wins only at the
densest matrices (Fig 9); Cholesky gains capped by dependency idle
cycles (Fig 10 discussion).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .etree import CholeskyPlan
from .formats import CSR


@dataclasses.dataclass(frozen=True)
class ReapVariant:
    name: str
    pipelines: int
    freq_hz: float
    read_bw: float          # bytes/s
    write_bw: float
    mults_per_pipe: int = 1


# §V hardware points (DE5net-Arria 10 synthesis + pmbw-measured DRAM)
REAP_32 = ReapVariant("REAP-32", 32, 250e6, 14e9, 14e9)
REAP_64 = ReapVariant("REAP-64", 64, 250e6, 147e9, 73e9)
REAP_128 = ReapVariant("REAP-128", 128, 220e6, 147e9, 73e9)
REAP_64C = ReapVariant("REAP-64", 64, 238e6, 147e9, 73e9, mults_per_pipe=16)
REAP_32C = ReapVariant("REAP-32", 32, 250e6, 14e9, 14e9, mults_per_pipe=8)

CPU_FREQ = 2.1e9            # Xeon 6130
CPU_FLOPS_PER_CYCLE = 16    # AVX-512 FMA path used by MKL on dense streams


def spgemm_workload(a: CSR, b: CSR) -> Dict[str, float]:
    """Exact workload statistics for C = A·B (no numeric work)."""
    b_row_len = np.diff(b.indptr)
    pp = float(b_row_len[a.indices].sum())       # partial products
    # unique outputs ≈ c_nnz; cheap upper-bound estimate avoids full inspect
    from .inspector import inspect_spgemm_gather
    c_nnz = float(inspect_spgemm_gather(a, b).c_nnz)
    return dict(pp=pp, nnz_a=float(a.nnz), nnz_b=float(b.nnz), c_nnz=c_nnz,
                n_rows=float(a.n_rows),
                density=a.nnz / max(1, a.n_rows * a.n_cols))


def cpu_cost_per_pp(density: float, threads: int = 1) -> float:
    """Cycles per partial product for the CPU library path.

    Index matching + hash/accumulator access dominate at low density
    (cache-hostile: ~8 cycles/pp — the paper's §I "2–5× the math" plus the
    match itself); streaming/vectorized at high density (~0.6 cycles/pp).
    Calibrated to the paper's anchors: REAP-32 geomean ≈ 3.2× (Fig 6) and
    the CPU crossover at the densest inputs (Fig 9).
    """
    irregular = 8.0 / (1.0 + (density / 5e-3) ** 0.5)
    regular = 0.6
    per_pp = regular + irregular
    # imperfect multithread scaling (paper: best at 16T, sublinear)
    eff = threads ** 0.75
    return per_pp / eff


def simulate_spgemm_cpu(stats: Dict[str, float], threads: int = 1) -> float:
    cycles = stats["pp"] * cpu_cost_per_pp(stats["density"], threads)
    return cycles / CPU_FREQ


def simulate_spgemm_reap(stats: Dict[str, float], hw: ReapVariant) -> Dict:
    """FPGA time = max(pipeline compute, DRAM stream) + CPU preprocessing
    (overlapped after the first round — reported separately)."""
    compute_s = stats["pp"] / (hw.pipelines * hw.freq_hz)
    # stream: A once, matched B rows per A row (the pp stream), C out
    read_bytes = 8 * (stats["nnz_a"] + stats["pp"])
    write_bytes = 8 * stats["c_nnz"]
    memory_s = read_bytes / hw.read_bw + write_bytes / hw.write_bw
    fpga_s = max(compute_s, memory_s)
    # CPU pass: pointer-chasing reformat of A (≈8 cycles/nnz: CSR walk +
    # bundle emit) + schedule emission (≈1 cycle/pp), ~2-wide effective ILP.
    # Calibrated so preprocessing exceeds FPGA time only on the lowest-
    # density inputs (paper Fig 7 finding).
    pre_s = (stats["nnz_a"] * 14 + stats["pp"] * 1.5) / (CPU_FREQ * 2)
    return dict(fpga_s=fpga_s, compute_s=compute_s, memory_s=memory_s,
                preprocess_s=pre_s,
                total_s=max(fpga_s, pre_s),   # overlapped after round 1
                bound="memory" if memory_s > compute_s else "compute")


def simulate_cholesky_cpu(plan: CholeskyPlan) -> float:
    """CHOLMOD simplicial LL^T numeric phase model (sequential column
    walk; ~1.55 cycles per multiply-sub — CHOLMOD's simplicial path is
    pointer-heavy but cache-resident for these band profiles; calibrated
    to the paper's 1.18×/1.85× anchors)."""
    flops = plan.flops()
    return flops * 1.55 / CPU_FREQ


def simulate_cholesky_reap(plan: CholeskyPlan, hw: ReapVariant) -> Dict:
    """Level-set execution: level ℓ runs its columns on min(N, width)
    pipelines; each pipeline is a dot-product PE chain with
    ``mults_per_pipe`` multipliers; per-level drain latency included —
    this reproduces the paper's 'idle cycles grow with pipelines'."""
    level_latency = 64 / hw.freq_hz         # pipeline fill+drain
    total = 0.0
    idle = 0.0
    for ell in range(plan.n_levels):
        width = len(plan.cols_per_level[ell])
        work = 2.0 * plan.upd_src1[ell].shape[0] + width * 8
        active = min(hw.pipelines, max(width, 1))
        t = work / (active * hw.mults_per_pipe * hw.freq_hz) + level_latency
        total += t
        idle += (hw.pipelines - active) / hw.pipelines * t
    bytes_l = 16.0 * plan.nnz
    memory_s = bytes_l / hw.read_bw
    return dict(fpga_s=max(total, memory_s), compute_s=total,
                memory_s=memory_s, idle_frac=idle / max(total, 1e-12))


def gflops(stats_pp: float, seconds: float) -> float:
    return 2.0 * stats_pp / seconds / 1e9

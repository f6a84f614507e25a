#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the result line:

1. device — the card's name, and its name and power limit from nvidia-smi;
2. build — compile kernel K1 (``bsr_spgemm``) and print ptxas's report;
3. kernel against plain — K1 against ``bsr_spgemm_plain`` on the card at
   the filter3D sync-plan shapes, on one bucketed chunk schedule with its
   dead trailing group, and at bs = 32 (limit 1e-5, TF32 off);
4. main path — ``ReapRuntime(device="cuda")`` at Table I sizes: filter3D
   A·A (auto → chunked block path, K1), again with fresh values (plan cache
   hit), cage12 A·A (auto → gather path), filter3D through the sync block
   path, and Pre_poisson Cholesky in float64, overlapped and sync.  Each
   SpGEMM is held against ``spgemm_ref_numpy`` (exact CSR structure, values
   to rtol = atol = 1e-4), each factor against ``cholesky_baseline_numpy``
   and by its residual ‖L·Lᵀ − A‖_F / ‖A‖_F ≤ 1e-10 from sparse products;
5. times — wall time per call (and the numpy references' host time),
   device busy share of warm calls under ``torch.profiler``, K1 / plain /
   library yardstick from CUDA events at the filter3D sync-plan shapes,
   K1 on one chunk with and without its bucketed dead tail, K1's bound,
   peak device memory, and the kernels line with the main path's launch
   counts.

The last line is ``{"ok": true, "device": {...}}``.  Matrices are generated
from fixed seeds with the published (rows, nnz, pattern) of Table I; no
SuiteSparse file is read.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Table I of the paper: (name, rows, nnz, structure of the stand-in)
FILTER3D = ("filter3D", 106_000, 2_700_000, "banded")
CAGE12 = ("cage12", 130_000, 2_000_000, "uniform")
PRE_POISSON = ("Pre_poisson", 12_000, 715_000, "banded")

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
K1_TOL = 1e-5
SPGEMM_TOL = 1e-4
CHOL_RESIDUAL = 1e-10
TIMED_LAUNCHES = 30


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def table1_csr(spec, seed: int):
    from repro_torch.core import random_csr
    _, rows, nnz, pattern = spec
    return random_csr(rows, rows, nnz / (rows * float(rows)),
                      np.random.default_rng(seed), pattern)


def compare(name: str, got, want, tol: float) -> float:
    """max |got - want| after asserting allclose(rtol=atol=tol)."""
    import torch
    diff = (got - want).abs()
    max_abs = diff.max().item() if diff.numel() else 0.0
    max_rel = (diff / want.abs().clamp_min(1e-30)).max().item() \
        if diff.numel() else 0.0
    ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    emit(phase="kernel_vs_plain", case=name, shape=list(got.shape),
         max_abs_err=max_abs, max_rel_err=max_rel, tol=tol, ok=ok)
    check(ok, f"K1 disagrees with its plain version ({name})")
    return max_abs


def numpy_ref(a):
    """``spgemm_ref_numpy(a, a)`` and its host time (the CPU stand-in)."""
    from repro_torch.core import spgemm_ref_numpy
    t0 = time.perf_counter()
    ref = spgemm_ref_numpy(a, a)
    return ref, time.perf_counter() - t0


def check_spgemm(name: str, c, ref, ref_s: float) -> None:
    same = (np.array_equal(c.indptr, ref.indptr)
            and np.array_equal(c.indices, ref.indices))
    check(same, f"{name}: CSR structure differs from spgemm_ref_numpy")
    ok = np.allclose(c.data, ref.data, rtol=SPGEMM_TOL, atol=SPGEMM_TOL)
    err = float(np.abs(c.data.astype(np.float64) - ref.data).max()) \
        if c.nnz else 0.0
    emit(phase="check", case=name, nnz=int(c.nnz), max_abs_err=err,
         tol=SPGEMM_TOL, ok=bool(ok), numpy_ref_s=ref_s)
    check(ok, f"{name}: values differ from spgemm_ref_numpy")


def chol_residual(plan, vals, a) -> float:
    """‖L·Lᵀ − A‖_F / ‖A‖_F with sparse products (never a dense n² L)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import norm
    n = plan.n
    lo = sp.csc_matrix((vals, plan.row_idx, plan.col_ptr), shape=(n, n))
    am = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(n, n))
    return float(norm(lo @ lo.T - am) / norm(am))


def timed(fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_share(case: str, fn) -> None:
    """Wall time of ``fn`` against the device time the profiler records
    (kernels and copies), under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    # device-side events only: a CPU op's device total repeats its kernels
    events = [(e.key, e.self_device_time_total)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and "Activity Buffer" not in e.key]
    busy = sum(us for _, us in events) / 1e6
    top = sorted((ev for ev in events if ev[1] > 0), key=lambda ev: -ev[1])
    emit(phase="profile", case=case, wall_s=wall, device_busy_s=busy,
         device_busy_share=busy / wall,
         top_device_us=[[k[:60], us] for k, us in top[:6]])


def event_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.core import (CSR, cholesky_baseline_numpy,
                                  inspect_spgemm_block, random_csr,
                                  random_spd_csr)
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spgemm import (bsr_spgemm,
                                                bsr_spgemm_plain,
                                                bsr_spgemm_schedule,
                                                prepare_schedule)
    from repro_torch.runtime import (ReapRuntime, bucket_block_schedule,
                                     build_block_chunkset)

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build("bsr_spgemm")
    emit(phase="build", kernel="bsr_spgemm",
         seconds=time.perf_counter() - t0)
    for line in _build.build_log("bsr_spgemm").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())

    # -- 3. kernel against plain -------------------------------------------
    t0 = time.perf_counter()
    fa = table1_csr(FILTER3D, 0)
    cage = table1_csr(CAGE12, 1)
    _, rows, nnz, _ = PRE_POISSON
    spd = random_spd_csr(rows, nnz / (rows * float(rows)),
                         np.random.default_rng(2), "banded")
    emit(phase="generate", seconds=time.perf_counter() - t0,
         filter3D_nnz=fa.nnz, cage12_nnz=cage.nnz, pre_poisson_nnz=spd.nnz)

    def ids(*arrays):
        return [torch.from_numpy(np.asarray(x)).to(dev) for x in arrays]

    plan = inspect_spgemm_block(fa, fa, 128)
    a_blocks = torch.from_numpy(plan.a_pat.scatter(fa.data)).to(dev)
    b_blocks = torch.from_numpy(plan.b_pat.scatter(fa.data)).to(dev)
    k1_sched = prepare_schedule(plan.schedule)
    plan_ids = ids(plan.a_id, plan.b_id, plan.out_id)
    n_out = plan.n_out_blocks
    errs = [compare("filter3D sync plan, bs=128",
                    bsr_spgemm_schedule(k1_sched, a_blocks, b_blocks,
                                        n_out_blocks=n_out),
                    bsr_spgemm_plain(a_blocks, b_blocks, *plan_ids,
                                     n_out_blocks=n_out), K1_TOL)]

    chunkset = build_block_chunkset(plan, 4)
    ch = chunkset.chunk(1)
    sched = bucket_block_schedule(ch)
    check(sched["pair_cap"] > ch.n_pairs, "chunk has no dead group")
    ca = np.zeros((sched["a_cap"], 128, 128), np.float32)
    ca[ch.a_eblk, ch.a_erow, ch.a_ecol] = fa.data[ch.a_sel]
    cb = np.zeros((sched["b_cap"], 128, 128), np.float32)
    cb[ch.b_eblk, ch.b_erow, ch.b_ecol] = fa.data[ch.b_sel]
    ca, cb = torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev)
    n_cap = sched["out_cap"] + 1
    errs.append(compare(
        f"filter3D bucketed chunk 1 (pairs {ch.n_pairs} -> "
        f"{sched['pair_cap']}, dead group -> tile {sched['out_cap']})",
        bsr_spgemm_schedule(sched, ca, cb, n_out_blocks=n_cap),
        bsr_spgemm_plain(ca, cb, *ids(sched["a_id"], sched["b_id"],
                                      sched["out_id"]),
                         n_out_blocks=n_cap), K1_TOL))

    small = random_csr(8192, 8192, 0.002, np.random.default_rng(3), "blocky")
    p32 = inspect_spgemm_block(small, small, 32)
    s_blocks = torch.from_numpy(p32.a_pat.scatter(small.data)).to(dev)
    errs.append(compare(
        "blocky 8192, bs=32",
        bsr_spgemm_schedule(p32.schedule, s_blocks, s_blocks,
                            n_out_blocks=p32.n_out_blocks),
        bsr_spgemm_plain(s_blocks, s_blocks,
                         *ids(p32.a_id, p32.b_id, p32.out_id),
                         n_out_blocks=p32.n_out_blocks), K1_TOL))
    torch.cuda.synchronize()

    # -- 4. main path -------------------------------------------------------
    calls = []

    def call(case, fn, launches_before):
        out, wall = timed(fn)
        stats = out[-1]
        row = dict(phase="main_path", case=case, call_s=wall,
                   k1_launches=bsr_spgemm.launches - launches_before,
                   **{k: stats.get(k) for k in (
                       "method", "cache_hit", "inspect_s", "plan_s",
                       "execute_s", "wall_s", "hidden_s", "n_chunks",
                       "overlap") if stats.get(k) is not None})
        emit(**row)
        calls.append(row)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bsr_spgemm.launches = 0
    rt = ReapRuntime(device="cuda")

    n0 = bsr_spgemm.launches
    c, st = call("filter3D A@A auto, cold", lambda: rt.spgemm(fa, fa), n0)
    check(st["method"] == "block_chunked", f"route {st['method']}")
    check(bsr_spgemm.launches > n0, "K1 did not launch on the chunked path")
    ref_fa, ref_fa_s = numpy_ref(fa)
    check_spgemm("filter3D block_chunked", c, ref_fa, ref_fa_s)

    fa2 = CSR(fa.n_rows, fa.n_cols, fa.indptr, fa.indices,
              np.random.default_rng(10).standard_normal(fa.nnz)
              .astype(np.float32))
    n0 = bsr_spgemm.launches
    c, st = call("filter3D A@A auto, fresh values (warm)",
                 lambda: rt.spgemm(fa2, fa2), n0)
    check(st["cache_hit"] is True, "same pattern missed the plan cache")
    check_spgemm("filter3D block_chunked warm", c, *numpy_ref(fa2))

    for label in ("cold", "warm"):
        c, st = call(f"cage12 A@A auto, {label}",
                     lambda: rt.spgemm(cage, cage), bsr_spgemm.launches)
        check(st["method"] == "gather_chunked", f"route {st['method']}")
    check_spgemm("cage12 gather_chunked", c, *numpy_ref(cage))

    rt_sync = ReapRuntime(device="cuda", n_chunks=1, overlap=False)
    for label in ("cold", "warm"):
        n0 = bsr_spgemm.launches
        c, st = call(f"filter3D A@A sync block path, {label}",
                     lambda: rt_sync.spgemm(fa, fa), n0)
        check(st["method"] == "block", f"route {st['method']}")
        check(bsr_spgemm.launches > n0, "K1 did not launch on the sync path")
    check_spgemm("filter3D block sync", c, ref_fa, ref_fa_s)

    for label, overlap in (("overlapped, cold", True), ("sync, warm", False)):
        chol_plan, vals, st = call(
            f"Pre_poisson Cholesky fp64 {label}",
            functools.partial(rt.cholesky, spd, dtype=torch.float64,
                              overlap=overlap), bsr_spgemm.launches)
        check(st["cache_hit"] is (not overlap), "Cholesky cache accounting")
        base, base_s = cholesky_baseline_numpy(chol_plan,
                                               chol_plan.a_values(spd))
        resid = chol_residual(chol_plan, vals, spd)
        ok = bool(np.allclose(vals, base, rtol=1e-10, atol=1e-12)
                  and resid <= CHOL_RESIDUAL)
        emit(phase="check", case=f"Pre_poisson Cholesky {label}",
             n_levels=chol_plan.n_levels, nnz_l=chol_plan.nnz,
             residual=resid,
             max_abs_err_vs_baseline=float(np.abs(vals - base).max()),
             numpy_baseline_s=base_s, ok=ok)
        check(ok, f"Cholesky ({label}) disagrees with the baseline")

    torch.cuda.synchronize()
    main_launches = bsr_spgemm.launches
    peak = torch.cuda.max_memory_allocated()
    emit(phase="main_path_done", k1_launches=main_launches,
         max_memory_allocated_bytes=peak)

    # device busy share of warm calls (after the count is read: the
    # profiled calls launch K1 again)
    device_share("filter3D A@A chunked, warm", lambda: rt.spgemm(fa2, fa2))
    device_share("filter3D A@A sync, warm", lambda: rt_sync.spgemm(fa, fa))
    device_share("cage12 A@A chunked, warm", lambda: rt.spgemm(cage, cage))
    device_share("Pre_poisson Cholesky overlapped, warm",
                 lambda: rt.cholesky(spd, dtype=torch.float64))

    # -- 5. times at the filter3D sync-plan shapes -------------------------
    k1_ms = event_ms(lambda: bsr_spgemm_schedule(
        k1_sched, a_blocks, b_blocks, n_out_blocks=n_out))
    plain_ms = event_ms(lambda: bsr_spgemm_plain(
        a_blocks, b_blocks, *plan_ids, n_out_blocks=n_out))

    def library():
        prods = torch.bmm(a_blocks[plan_ids[0]], b_blocks[plan_ids[1]])
        return a_blocks.new_zeros((n_out, 128, 128)).index_add_(
            0, plan_ids[2], prods)

    library_ms = event_ms(library)
    flop = 2 * plan.n_pairs * 128 ** 3
    nbytes = (a_blocks.numel() + b_blocks.numel() + n_out * 128 * 128) * 4 \
        + k1_sched.ids.nbytes
    flop_ms, byte_ms = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    emit(phase="times", case="filter3D sync plan", n_pairs=plan.n_pairs,
         n_out_blocks=n_out, flop=flop, bytes=nbytes, k1_ms=k1_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         k1_tflops=flop / k1_ms / 1e9, flop_bound_ms=flop_ms,
         byte_bound_ms=byte_ms, card=card)
    # the chunk path hands K1 the live pairs only; the bucketed schedule's
    # dead tail is one group that a single thread block would run alone
    emit(phase="times", case=f"filter3D chunk 1, {ch.n_pairs} live pairs",
         k1_bucketed_ms=event_ms(lambda: bsr_spgemm_schedule(
             sched, ca, cb, n_out_blocks=n_cap)),
         k1_live_pairs_ms=event_ms(lambda: bsr_spgemm_schedule(
             sched["k1"], ca, cb, n_out_blocks=n_cap)),
         dead_pairs=sched["pair_cap"] - ch.n_pairs, card=card)
    print(json.dumps({"kernels": [{
        "name": "bsr_spgemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bsr_spgemm.cu",
        "replaces": "src/repro/kernels/bsr_spgemm.py:41",
        "launches": main_launches, "max_abs_err": max(errs),
        "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Measurements of the port's kernels on one NVIDIA card, beside
``chip_smoke.py``: each prints JSON lines, the first naming the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it.

    PYTHONPATH=src python scripts/card_studies.py k1-carry
    PYTHONPATH=src python scripts/card_studies.py k3-numerics
    PYTHONPATH=src python scripts/card_studies.py k5-carry
    PYTHONPATH=src python scripts/card_studies.py k5-bf16
    PYTHONPATH=src python scripts/card_studies.py kernel-times
    PYTHONPATH=src python scripts/card_studies.py k5-stream
    PYTHONPATH=src python scripts/card_studies.py k6-time
    PYTHONPATH=src python scripts/card_studies.py hymba-repeat [--seeds 10 --runs 5]
    PYTHONPATH=src python scripts/card_studies.py situ-repeat [--runs 200]
    PYTHONPATH=src python scripts/card_studies.py pipeline-grad
    PYTHONPATH=src python scripts/card_studies.py first-meta
    PYTHONPATH=src python scripts/card_studies.py k4-bwd-split
    PYTHONPATH=src python scripts/card_studies.py k5-bwd-routes
    PYTHONPATH=src python scripts/card_studies.py k6-bwd-routes
    PYTHONPATH=src python scripts/card_studies.py tp-memory

* ``k1-carry`` — K1 at ``chip_smoke.py`` phase 3's three cases (filter3D's
  sync plan and its bucketed chunk 1 at bs = 128, a blocky 8192 at
  bs = 32) with the tensor cores' partial sums carried into the IEEE fp32
  accumulator every N = 8, 16, 32, 64 and 128 deep (the shipped kernel's
  N is ``chip_smoke.K1_CARRY_DEPTH``; the others are ``csrc/bsr_spgemm.cu``
  built again with ``-DREPRO_K1_CARRY=N`` into libraries of their own):
  each one's largest error against the plain
  version, its largest error over K1's limit (1e-5 (1 + |plain|), 1 at the
  limit), both its and the plain version's error against a float64 run of
  the plain version, and its time.  bs = 32 runs the FMA kernel, which has
  no carry.
* ``k3-numerics`` — K3 in float32 through the plan route: on ``wgmma`` at
  the Llama-3-8B shape (softcap 0 and 50) and at Llama's heads with V
  stacked on its near negation (outputs that cancel); on ``mma.sync`` at
  Llama's heads with block 64 and at gemma2-2b's heads (D = 256, softcap
  50).  The shipped kernel (its TF32 split: big part by truncation, the
  small part as is; ``mma.sync`` carrying every 64 deep)
  against builds whose ``mma.sync`` path carries every 32 deep
  (``-DREPRO_K3_CARRY=32``) or once a sub-tile (``=0``) and one with
  split_tf32's rounding of both parts (``-DREPRO_K3_SPLIT_RN``): each
  one's largest error against the plain version and over K3's limit
  (1e-4 (1 + |plain|)), and its time.
* ``k5-carry`` — K5 in float32 at DBRX-132B's MoE shapes (``chip_smoke.py``
  phase 9's bundles: the gate and down products of a prefill of 2 × 2048
  tokens and of a decode step of 64), with the tensor cores' partial sums
  carried into the accumulator every 32-deep slice (``carry1``, the
  shipped kernel) and without a carry (``carry0``: ``csrc/moe_gemm.cu``
  built again with ``-DREPRO_K5_NO_CARRY``): the largest error against the
  version and the time of each, beside ``torch.bmm`` (TF32 off); then the
  whole layer (``moe_ffn_host``) with each, against the layer with the
  plain ``moe_gemm`` (``chip_smoke.py``'s ``MOE_TOL``).  The decode shapes
  run the FMA kernel, which has no carry.
* ``k5-bf16`` — K5 in bfloat16 at dbrx-132b's in-graph bundles
  (``chip_smoke.py`` phases 16 and 20: gate and down of a prefill of
  2 × 1024 tokens, 32 bundles of cap 320, and of decode steps at batch 1
  and 2, 16 and 32 bundles of cap 8; random weights, seed 96), each build
  of ``csrc/moe_gemm.cu`` timed by CUDA events and held against the plain
  version by ||got − want|| / ||want||: on the tile route the shipped
  kernel (256 columns, 4 stages, sums in place) against 3 stages, 128
  columns at 4 and 6 stages, and 128 columns with the tensor cores' sums
  carried into an IEEE fp32 accumulator every 64 and 512 deep
  (``-DREPRO_K5_TMA_BN``, ``_STAGES``, ``_CARRY``); on the decode route
  the shipped kernel (two 64-column weight boxes a slice, 5 stages, two
  blocks an SM) against 8 stages (one block an SM), one box a slice at 4,
  8 and 16 stages, four boxes at 4 (``-DREPRO_K5_DECODE_BOXES``,
  ``_STAGES``) and the other candidate, the float32 rows kernel's
  streaming in bfloat16 (``-DREPRO_K5_DECODE_ROWS``); on both routes TMA
  reading without L2 promotion (``-DREPRO_K5_NO_L2_PROMOTION``; shipped: 256
  bytes),
  the shipped kernel walking the bundles in their own order
  (``pack_schedule(grouped=False)``: no expert grouping) and the
  ``mma.sync`` kernel; beside one ``torch.bmm`` over (E, rows × cap, d)
  and the bound (bf16 peak, HBM).
* ``kernel-times`` — K2 (filter3D ``spmm``, T = 256), K4 (hymba-1.5b's
  2048-token bfloat16 prefill), K6 (hymba's SSM heads, T = 2048) and K5
  (DBRX-132B's gate product at cap 1280 and 24, expert map on the card)
  on random inputs: per call by CUDA events and on the device (calls
  captured in a CUDA graph), with the tree whose ``repro_torch`` ran.  To
  hold two trees against each other on one card, copy this file into the
  other tree's ``scripts/`` and run both in turns (A, B, B, A).
* ``k5-stream`` — how fast one DBRX-132B weight stack (16 experts of
  6144 × 10752 float32, 4.23 GB) can be read: ``w.sum()`` (contiguous) and
  ``w.amax(dim=1)`` (every column down the rows, the order of a decode
  product), beside K5 and ``torch.bmm`` (TF32 off) at the decode gate's
  shape (16 bundles of 24 rows).
* ``k6-time`` — K6 against its plain version and its time at hymba-1.5b's
  SSM heads (H = 25, K = 16, V = 64, chunk 64) for T = 64 … 2048 and B = 1, 2.
* ``hymba-repeat`` — ``tests/test_torch_gpu.py::
  test_hymba_prefill_launches_k4_and_k6_per_layer``'s inputs (2-layer
  hymba-1.5b, float32 compute, 128 tokens; the test's params are seed 0)
  with params seeds 0 … ``--seeds`` − 1 on the card, ``--runs`` runs each:
  each run's logits against the host's, as the largest |card − host| over
  the test's limit 1e-3 + 1e-3·|host|, and every K4, K6 and dense-product
  call of the card's prefill against the host's plain version of the same
  call on the card call's own inputs.
* ``situ-repeat`` — ``chip_smoke.py`` phase 13's card prefill (2-layer
  hymba-1.5b, float32 compute, 2048 tokens, params seed 71) ``--runs``
  times, every other run with bfloat16 products running on a side stream:
  every K4, K6 and dense output and the logits against the first run's,
  bit for bit; then the host's prefill at 8 and at 1 thread against each
  other, and the first card run against the host as phase 13 reads it
  (the largest |card − host| over 1e-3 + 1e-3·|host|).
* ``pipeline-grad`` — ``pipeline_apply`` over a ``(4, 1)`` ("pipe",
  "model") mesh of ``cuda:0`` × 4 at ``tests/test_torch_gpu.py::
  test_pipeline_apply_on_card``'s inputs (seed 0: w 4 × 256 × 256, x 8
  microbatches of 32 × 256, stages ``tanh(h @ w)``, TF32 off) and at
  ``chip_smoke.py`` phase 42's (seed 42, d 2048, 8 microbatches of 8 × 256
  rows): the output and the gradients of w and x, from the pipeline and
  from the four stages in sequence in float32, each against the stages in
  sequence in float64 — the largest elementwise error and
  ||err|| / ||float64|| of each — and the pipeline's largest elementwise
  difference from the float32 sequential run.
* ``first-meta`` — in fresh processes, the seconds of a process's first
  ``torch.stack`` of two ``meta`` tensors (the first operator that needs a
  Python meta kernel: it imports sympy and torch's decompositions) and of a
  second one, and whether sympy was imported; then, in another fresh
  process, the first ``make_prefill_step`` over a (2, 2) mesh of
  ``cuda:0`` × 4 at reduced qwen3-1.7b (batch 8 × 32), K4 built
  beforehand, and a second one: the serving path touches no Python meta
  kernel.
* ``k4-bwd-split`` — K4's backward in bfloat16 at ``chip_smoke.py`` phase
  30's shapes (``K4_BWD_TIMED``, inputs from the same seed): the device
  microseconds of its dq pass and of its dk/dv pass a call, each its
  kernel's events summed under ``torch.profiler`` over 10 warm calls (a
  fresh process: in ``chip_smoke.py``'s long run, late profiler sessions
  record no device event), beside the whole call by CUDA events.
* ``k5-bwd-routes`` — K5's backward in bfloat16, dx and dw each, on the
  ``wgmma`` route (TMA-fed, the shipped one at these widths) and on
  ``mma_sync`` (the first design, which now takes only widths that are not
  a multiple of 8), by CUDA events, at ``chip_smoke.py``'s
  ``K5_BWD_CASES`` "dbrx-132b training, gate and up" (32 bundles of cap
  320), "dbrx-132b widths, cap 8" and "kimi-k2 widths, cap 24", beside
  ``torch.bmm`` on inputs grouped by expert where the map groups evenly:
  the reading behind ``bwd_route`` leaving the cap out of the choice.
* ``k6-bwd-routes`` — K6's backward in bfloat16 (float32 w, no dstate) at
  ``chip_smoke.py`` phase 35's two training shapes (``K6_BWD_HEADS`` at
  T 2048, chunk 64), on the ``"mma"`` route (the shipped one) and the
  ``"fma"`` route (the first design, through ``_k6_bwd``'s ``route``), by
  CUDA events, and each route's device microseconds by kernel, its
  events summed under ``torch.profiler`` over 10 warm calls.
* ``tp-memory`` — where the peak of a sharded serving step sits: phase
  45's float32 prefill and one decode step of qwen3-1.7b on one device and
  on the tensor-parallel (2, 2) mesh of ``cuda:0`` x 4, the memory
  allocated and its peak at each block's entry and exit and at the cache
  reads and writes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("card_studies: no CUDA device")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    name = out[0] if out else "nvidia-smi: no output"
    emit(study="device", kind=torch.cuda.get_device_name(0), nvidia_smi=name)
    torch.backends.cuda.matmul.allow_tf32 = False
    return name


@contextlib.contextmanager
def kernel_build(kernel: str, *defines: str):
    """``kernel``'s wrapper bound to a build of ``csrc/<kernel>.cu`` with
    ``-D`` ``defines`` (none: the shipped kernel), which lands in ``build/``
    under a digest of its own."""
    from repro_torch.kernels import _build
    flags = _build.NVCC_FLAGS
    _build.NVCC_FLAGS = flags + tuple(f"-D{d}" for d in defines)
    _build._LOADED.pop(kernel, None)
    try:
        yield
    finally:
        _build.NVCC_FLAGS = flags
        _build._LOADED.pop(kernel, None)


def k1_carry(name: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels.bsr_spgemm import (bsr_spgemm_plain,
                                                bsr_spgemm_schedule)
    dev = torch.device("cuda")
    cases, _, _ = cs.k1_cases(cs.table1_csr(cs.FILTER3D, 0), dev)
    for label, (sched, a, b, n, ids) in cases.items():
        want = bsr_spgemm_plain(a, b, *ids, n_out_blocks=n)
        exact = bsr_spgemm_plain(a.double(), b.double(), *ids,
                                 n_out_blocks=n)
        row = dict(study="k1_carry", case=label, tol=cs.K1_TOL,
                   want_abs_max=want.abs().max().item(),
                   plain_vs_float64_max_abs_err=(want - exact).abs().max()
                   .item(), card=name)
        for carry in (8, 16, 32, 64, 128):
            shipped = carry == cs.K1_CARRY_DEPTH
            with kernel_build("bsr_spgemm", *([] if shipped else
                                              [f"REPRO_K1_CARRY={carry}"])):
                got = bsr_spgemm_schedule(sched, a, b, n_out_blocks=n)
                diff = (got - want).abs()
                row[f"n{carry}_max_abs_err"] = diff.max().item()
                row[f"n{carry}_err_over_limit"] = (
                    diff / (cs.K1_TOL * (1 + want.abs()))).max().item()
                row[f"n{carry}_vs_float64_max_abs_err"] = (
                    got - exact).abs().max().item()
                row[f"n{carry}_ms"] = cs.event_ms(
                    lambda: bsr_spgemm_schedule(sched, a, b, n_out_blocks=n))
        emit(**row)


def cancelling_attention(gen, s=2048, bs=128, h=32, hkv=8, d=128):
    """Attention whose outputs nearly cancel: kv blocks past s / 2 repeat
    the keys of the first half with V stacked as -V (1 + 1e-3 r), and each
    q block sees a block and its twin (``tests/test_torch_gpu.py::
    test_k3_holds_cancelling_sums`` at Llama-3-8B's heads).  Returns q, k,
    v and the plan."""
    from repro_torch.core import COO, CSR
    from repro_torch.kernels.flash_attention import inspect_block_attention
    nb = s // bs // 2
    rng = np.random.default_rng(31)
    vis = rng.random((2 * nb, nb)) < 0.6
    vis[np.arange(2 * nb), rng.integers(0, nb, 2 * nb)] = True
    qb, kb = np.nonzero(np.concatenate([vis, vis], axis=1))
    mask = CSR.from_coo(COO(s, s, qb * bs, kb * bs,
                            np.ones(qb.size, np.float32)))
    dev = gen.device
    q = torch.randn((1, h, s, d), generator=gen, device=dev)
    k0, v0 = (torch.randn((1, hkv, s // 2, d), generator=gen, device=dev)
              for _ in range(2))
    r = torch.randn(v0.shape, generator=gen, device=dev)
    return (q, torch.cat([k0, k0], 2), torch.cat([v0, -v0 * (1 + 1e-3 * r)],
                                                 2),
            inspect_block_attention(mask, bs))


def k3_numerics(name: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (
        block_sparse_attention_plain, block_sparse_attention_plan,
        inspect_block_attention)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    q, k, v = cs.llama_qkv(gen)
    plan = inspect_block_attention(cs.llama_mask()[0], cs.LLAMA["block"])
    gemma = [torch.randn((1, n, 2048, 256), generator=gen, device=dev)
             for n in (8, 4, 4)]
    llama64 = [torch.randn((1, n, 2048, 128), generator=gen, device=dev)
               for n in (32, 8, 8)]
    cases = {"Llama-3-8B f32, softcap 0 (wgmma)": (q, k, v, plan, 0.0),
             "Llama-3-8B f32, softcap 50 (wgmma)": (q, k, v, plan, 50.0),
             "Llama-3-8B heads, S=2048, V cancelling (wgmma)": (
                 *cancelling_attention(gen), 0.0),
             "Llama-3-8B heads, S=2048, block 64 (mma.sync)": (
                 *llama64, inspect_block_attention(
                     cs.window_mask(2048, 64, 16)[0], 64), 0.0),
             "gemma2-2b heads, D=256, S=2048, block 128, softcap 50 "
             "(mma.sync)": (*gemma, inspect_block_attention(
                 cs.window_mask(2048, 128, 8)[0], 128), 50.0)}
    variants = {"shipped": (), "carry32": ("REPRO_K3_CARRY=32",),
                "no_carry": ("REPRO_K3_CARRY=0",),
                "split_rn": ("REPRO_K3_SPLIT_RN",)}
    for label, (q, k, v, p, cap) in cases.items():
        ids = [torch.from_numpy(x).to(dev) for x in (p.kv_ids, p.n_kv)]
        want = block_sparse_attention_plain(q, k, v, *ids, softcap=cap,
                                            scale=q.shape[-1] ** -0.5,
                                            seq=p.seq)
        row = dict(study="k3_numerics", case=label, tol=cs.K3_TOL,
                   want_abs_max=want.abs().max().item(), card=name)
        for variant, defines in variants.items():
            with kernel_build("block_sparse_attention", *defines):
                diff = (block_sparse_attention_plan(q, k, v, p, softcap=cap)
                        - want).abs()
                row[f"{variant}_max_abs_err"] = diff.max().item()
                row[f"{variant}_err_over_limit"] = (
                    diff / (cs.K3_TOL * (1 + want.abs()))).max().item()
                row[f"{variant}_ms"] = cs.event_ms(
                    lambda: block_sparse_attention_plan(q, k, v, p,
                                                        softcap=cap))
        emit(**row)


def kernel_times(name: str) -> None:
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.rir import ScheduleBundle
    from repro_torch.kernels.bsr_spmm import (bsr_spmm, inspect_spmm,
                                              prepare_spmm_schedule)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_gemm_schedule
    from repro_torch.kernels.rwkv6_scan import rwkv6
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(90)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def row(kernel, case, fn):
        emit(study="kernel_times", tree=str(Path(repro_torch.__file__)
                                            .parents[2]),
             kernel=kernel, case=case, ms=cs.event_ms(fn),
             device_ms=cs.device_ms(fn), card=name)

    fa = cs.table1_csr(cs.FILTER3D, 0)
    plan = inspect_spmm(fa, 128)
    k2s = prepare_spmm_schedule(plan.schedule, plan.n_j_blocks)
    x = randn(cs.SPMM_TOKENS, plan.pat.n_rows)
    tiles = torch.from_numpy(plan.scatter(fa.data)).to(dev)
    row("K2", f"filter3D spmm T={cs.SPMM_TOKENS}",
        lambda: bsr_spmm(x, tiles, k2s, n_j_blocks=plan.n_j_blocks))
    del x, tiles
    cfg = cs.hymba_config()
    bf16 = torch.bfloat16
    q = randn(1, cfg.n_heads, 2048, cfg.d_head, dtype=bf16)
    k, v = (randn(1, cfg.n_kv_heads, 2048, cfg.d_head, dtype=bf16)
            for _ in range(2))
    row("K4", "hymba-1.5b prefill S=2048 bf16",
        lambda: flash_attention(q, k, v, window=cfg.window))
    r, kk = (randn(1, cfg.n_heads, 2048, cfg.ssm_state, dtype=bf16)
             for _ in range(2))
    vv = randn(1, cfg.n_heads, 2048, cfg.d_head, dtype=bf16)
    w = torch.sigmoid(4 * randn(1, cfg.n_heads, 2048, cfg.ssm_state)).clamp(
        1e-6, 1 - 1e-6)
    u = torch.zeros(cfg.n_heads, cfg.ssm_state, device=dev)
    row("K6", "hymba-1.5b SSM heads T=2048",
        lambda: rwkv6(r, kk, vv, w, u, chunk=64))
    d, e, f = (cs.DBRX[n] for n in ("d_model", "n_experts", "d_ff_expert"))
    wt = randn(e, d, f) * d ** -0.5
    be = ScheduleBundle("moe_dispatch",
                        {"bundle_expert": np.arange(e, dtype=np.int32)})
    for label, cap in (("prefill gate, cap 1280", 1280),
                       ("decode gate, cap 24", 24)):
        xb = randn(e, cap, d)
        row("K5", f"DBRX {label}", lambda xb=xb: moe_gemm_schedule(be, xb, wt))


def k5_carry(name: str) -> None:
    import chip_smoke as cs
    import repro_torch.kernels.moe_gemm as K5
    from repro_torch.models.moe import (expert_capacity, host_route,
                                        moe_ffn_host)
    from repro_torch.runtime import ReapRuntime
    dev = torch.device("cuda")
    d, e, k = (cs.DBRX[n] for n in ("d_model", "n_experts", "top_k"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(50)
    p = cs.dbrx_moe_weights(gen)
    rt = ReapRuntime(device="cuda")
    no_carry = {1: (), 0: ("REPRO_K5_NO_CARRY",)}
    for call, (b, s) in cs.MOE_CALLS.items():
        x = torch.randn((b, s, d), generator=gen, device=dev)
        tokens = x.reshape(-1, d)
        ids, _ = host_route(tokens, p["router"], top_k=k)
        cap = expert_capacity(tokens.shape[0], e, k,
                              cs.DBRX["capacity_factor"])
        xb, plan, _ = rt.moe_dispatch(tokens, ids, n_experts=e, capacity=cap)
        be = plan.schedule
        be_t = torch.from_numpy(be["bundle_expert"]).to(dev)
        h = torch.nn.functional.silu(K5.moe_gemm_plain(xb, p["w_gate"], be_t)) \
            * K5.moe_gemm_plain(xb, p["w_up"], be_t)
        for label, a, w in (("gate", xb, p["w_gate"]),
                            ("down", h, p["w_down"])):
            want = K5.moe_gemm_plain(a, w, be_t)
            row = dict(study="k5_carry", case=f"DBRX {call} {label}",
                       shape=list(a.shape) + [w.shape[-1]], card=name)
            for carry in (1, 0):
                with kernel_build("moe_gemm", *no_carry[carry]):
                    got = K5.moe_gemm(a, w, be)
                    diff = (got - want).abs()
                    row[f"carry{carry}_max_abs_err"] = diff.max().item()
                    row[f"carry{carry}_max_err_over_tol"] = (
                        diff / (cs.K5_TOL * (1 + want.abs()))).max().item()
                    row[f"carry{carry}_ms"] = cs.event_ms(
                        lambda a=a, w=w, be=be: K5.moe_gemm(a, w, be), 10)
            row["bmm_ms"] = cs.event_ms(lambda a=a, w=w: torch.bmm(a, w), 10)
            row["want_abs_max"] = want.abs().max().item()
            emit(**row)
            del want, got
        del xb, h
        want, _ = cs.moe_ffn_plain(x, p)
        row = dict(study="k5_carry_layer", case=f"DBRX moe_ffn_host {call}",
                   tol=cs.MOE_TOL, card=name)
        for carry in (1, 0):
            with kernel_build("moe_gemm", *no_carry[carry]):
                out, _ = moe_ffn_host(
                    x, p, rt, n_experts=e, top_k=k,
                    capacity_factor=cs.DBRX["capacity_factor"])
            row[f"carry{carry}_max_abs_err"] = (out - want).abs().max().item()
            row[f"carry{carry}_within_tol"] = bool(torch.allclose(
                out, want, rtol=cs.MOE_TOL, atol=cs.MOE_TOL))
        emit(**row)
        del want, out


def k5_bf16(name: str) -> None:
    import functools
    from unittest import mock

    import chip_smoke as cs
    import repro_torch.kernels.moe_gemm as K
    from repro_torch.core.rir import ScheduleBundle
    dev = torch.device("cuda")
    cfg = cs.dbrx_config()
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    gen = torch.Generator(device=dev)
    gen.manual_seed(96)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    weights = {"gate": randn(e, d, f, scale=d ** -0.5),
               "down": randn(e, f, d, scale=f ** -0.5)}
    variants = {
        "wgmma_tiles": {"shipped": (), "stages3": ("REPRO_K5_TMA_STAGES=3",),
                        "bn128_stages4": ("REPRO_K5_TMA_BN=128",
                                          "REPRO_K5_TMA_STAGES=4"),
                        "bn128_stages6": ("REPRO_K5_TMA_BN=128",),
                        "bn128_carry64": ("REPRO_K5_TMA_BN=128",
                                          "REPRO_K5_TMA_CARRY=64"),
                        "bn128_carry512": ("REPRO_K5_TMA_BN=128",
                                           "REPRO_K5_TMA_CARRY=512")},
        "wgmma_decode": {"shipped": (),
                         "boxes2_stages8": ("REPRO_K5_DECODE_STAGES=8",),
                         "boxes1_stages4": ("REPRO_K5_DECODE_BOXES=1",
                                            "REPRO_K5_DECODE_STAGES=4"),
                         "boxes1_stages8": ("REPRO_K5_DECODE_BOXES=1",
                                            "REPRO_K5_DECODE_STAGES=8"),
                         "boxes1_stages16": ("REPRO_K5_DECODE_BOXES=1",
                                             "REPRO_K5_DECODE_STAGES=16"),
                         "boxes4_stages4": ("REPRO_K5_DECODE_BOXES=4",
                                            "REPRO_K5_DECODE_STAGES=4"),
                         "rows_candidate": ("REPRO_K5_DECODE_ROWS",)}}
    for route in variants.values():   # TMA's L2 promotion: 256 bytes, none
        route["l2_none"] = ("REPRO_K5_NO_L2_PROMOTION",)
    cases = [("prefill", 2, 320), ("decode, batch 1", 1, 8),
             ("decode, batch 2", 2, 8)]
    for case, rows, cap in cases:
        nb = rows * e
        be = np.tile(np.arange(e, dtype=np.int32), rows)
        be_t = torch.from_numpy(be).to(dev)
        for label, w in weights.items():
            d_in, d_out = w.shape[1:]
            x = randn(nb, cap, d_in)
            want = K.moe_gemm_plain(x, w, be_t).float()
            flop = 2 * nb * cap * d_in * d_out
            nbytes = (x.numel() + w.numel() + nb * cap * d_out) * 2
            route = K.bf16_route(cap, d_in, d_out)
            a_e = x.reshape(rows, e, cap, d_in).transpose(0, 1).reshape(
                e, rows * cap, d_in)
            row = dict(study="k5_bf16", case=f"in-graph DBRX {case} {label}",
                       shape=[nb, cap, d_in, d_out], route=route,
                       bound_ms=max(flop / cs.BF16_FLOPS,
                                    nbytes / cs.HBM_BYTES_S) * 1e3,
                       bmm_ms=cs.event_ms(lambda: torch.bmm(a_e, w), 10),
                       card=name)

            def read(key, sched, n=10):
                got = K.moe_gemm(x, w, sched)
                row[f"{key}_rel_norm"] = ((got.float() - want).norm()
                                          / want.norm()).item()
                row[f"{key}_ms"] = cs.event_ms(
                    lambda: K.moe_gemm(x, w, sched), n)

            for variant, defines in variants[route].items():
                with kernel_build("moe_gemm", *defines):
                    read(variant, ScheduleBundle("moe_ffn",
                                                 {"bundle_expert": be}))
            with mock.patch.object(K, "pack_schedule", functools.partial(
                    K.pack_schedule, grouped=False)):
                read("ungrouped", ScheduleBundle("moe_ffn",
                                                 {"bundle_expert": be}))
            with mock.patch.object(K, "bf16_route", lambda *a: "mma_sync"):
                read("mma_sync", be_t.cpu().numpy(), 3)
            emit(**row)
            del x, want, a_e


def k5_stream(name: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels.moe_gemm import moe_gemm
    dev = torch.device("cuda")
    d, e, f = (cs.DBRX[n] for n in ("d_model", "n_experts", "d_ff_expert"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(51)
    w = torch.randn((e, d, f), generator=gen, device=dev) * d ** -0.5
    x = torch.randn((e, 24, d), generator=gen, device=dev)
    be = np.arange(e, dtype=np.int32)
    emit(study="k5_stream", bytes=w.numel() * 4,
         sum_ms=cs.event_ms(lambda: w.sum(), 10),
         amax_down_rows_ms=cs.event_ms(lambda: w.amax(dim=1), 10),
         k5_decode_gate_ms=cs.event_ms(lambda: moe_gemm(x, w, be), 10),
         bmm_ms=cs.event_ms(lambda: torch.bmm(x, w), 10),
         hbm_bound_ms=w.numel() * 4 / cs.HBM_BYTES_S * 1e3, card=name)


def k6_time(name: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(76)
    h, kk, vv = 25, 16, 64
    for b in (1, 2):
        for t in (64, 256, 1024, 2048):
            r, k = (torch.randn((b, h, t, kk), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            v = torch.randn((b, h, t, vv), generator=gen, device=dev) \
                .to(torch.bfloat16)
            w = torch.sigmoid(4 * torch.randn((b, h, t, kk), generator=gen,
                                              device=dev)).clamp(1e-6,
                                                                 1 - 1e-6)
            u = torch.randn((h, kk), generator=gen, device=dev)
            args = (r, k, v, w, u)
            (o, st), (o_p, st_p) = (fn(*args, chunk=64)
                                    for fn in (rwkv6, rwkv6_plain))
            emit(study="k6_time", B=b, T=t,
                 o_max_abs_err=(o - o_p).abs().max().item(),
                 state_max_abs_err=(st - st_p).abs().max().item(),
                 ms=cs.event_ms(lambda a=args: rwkv6(*a, chunk=64)),
                 device_ms=cs.device_ms(lambda a=args: rwkv6(*a, chunk=64)),
                 plain_ms=cs.event_ms(
                     lambda a=args: rwkv6_plain(*a, chunk=64), 5),
                 card=name)


def hymba_repeat(name: str, runs: int, seeds: int) -> None:
    import repro_torch.models.blocks as B
    import repro_torch.models.model as M
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import ssm as SS
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                              compute_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (1, 128),
                         generator=torch.Generator().manual_seed(0))
    calls = []

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def recorded(kind, fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if args and torch.is_tensor(args[0]) and args[0].is_cuda:
                want = fn(*map(cpu, args), **{k: cpu(v) for k, v in
                                              kw.items()})
                got = out if isinstance(out, tuple) else (out,)
                want = want if isinstance(want, tuple) else (want,)
                calls.append((kind, max((g.cpu().float() - w_.float())
                                        .abs().max().item()
                                        for g, w_ in zip(got, want))))
            return out
        return wrapper

    worst, fails, worst_ratio = {}, 0, 0.0
    for seed in range(seeds):
        B.flash_attention, B.rwkv6_chunked, B.dense = (
            A.flash_attention, SS.rwkv6_chunked, LY.dense)
        params = M.init_params(cfg, seed, device=dev)
        host_logits = M.prefill(cfg, _to_cpu(params), toks,
                                M.init_cache(cfg, 1, 160, device="cpu"))[0]
        B.flash_attention = recorded("k4", A.flash_attention)
        B.rwkv6_chunked = recorded("k6", SS.rwkv6_chunked)
        B.dense = recorded("dense", LY.dense)
        for run in range(runs):
            calls.clear()
            logits, _ = M.prefill(cfg, params, toks.to(dev),
                                  M.init_cache(cfg, 1, 160, device=dev))
            got = logits.cpu()
            diff = (got - host_logits).abs()
            # the test's limit, |got - want| <= 1e-3 + 1e-3 |want|
            ratio = (diff / (1e-3 + 1e-3 * host_logits.abs())).max().item()
            ok = ratio <= 1.0
            fails += not ok
            worst_ratio = max(worst_ratio, ratio)
            per = {}
            for kind, e in calls:
                per[kind] = max(per.get(kind, 0.0), e)
                worst[kind] = max(worst.get(kind, 0.0), e)
            emit(study="hymba_repeat", params_seed=seed, run=run,
                 logits_max_abs_err=diff.max().item(),
                 logits_abs_max=host_logits.abs().max().item(),
                 err_over_limit=ratio, within_limit=ok,
                 per_kind_max_err=per,
                 per_call=[[k, e] for k, e in calls if k != "dense"],
                 card=name)
    emit(study="hymba_repeat_summary", seeds=seeds, runs_per_seed=runs,
         failures=fails, worst_err_over_limit=worst_ratio,
         worst_per_kind=worst, card=name)


def situ_repeat(name: str, runs: int) -> None:
    import chip_smoke as cs
    import repro_torch.models.blocks as B
    import repro_torch.models.model as M
    dev = torch.device("cuda")
    cfg = dataclasses.replace(cs.hymba_config(),
                              n_layers=cs.HYMBA_SITU["n_layers"],
                              compute_dtype="float32")
    s, n_dec = cs.HYMBA_SITU["prompt"], cs.HYMBA_SITU["decode"]
    params = M.init_params(cfg, 71, device=dev)
    toks = torch.from_numpy(np.random.default_rng(72).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32))
    outs, kinds = [], []

    def recorded(kind, fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if args and torch.is_tensor(args[0]) and args[0].is_cuda:
                for o in out if isinstance(out, tuple) else (out,):
                    outs.append(o.detach().clone())
                    kinds.append(kind)
            return out
        return wrapper

    saved = B.flash_attention, B.rwkv6_chunked, B.dense
    B.flash_attention, B.rwkv6_chunked, B.dense = (
        recorded("k4", saved[0]), recorded("k6", saved[1]),
        recorded("dense", saved[2]))
    side = torch.cuda.Stream()
    load = torch.randn((8192, 8192), device=dev, dtype=torch.bfloat16)
    side.wait_stream(torch.cuda.current_stream())
    first, differing = None, 0
    try:
        for run in range(runs):
            outs.clear()
            kinds.clear()
            if run % 2:
                with torch.cuda.stream(side):
                    for _ in range(4):
                        load = (load @ load).clamp_(-1, 1)
            logits, _ = M.prefill(cfg, params, toks.to(dev),
                                  M.init_cache(cfg, 1, s + n_dec, device=dev))
            outs.append(logits)
            kinds.append("logits")
            if first is None:
                first = list(outs)
                continue
            for i, (got, want) in enumerate(zip(outs, first)):
                if not torch.equal(got, want):
                    differing += 1
                    emit(study="situ_repeat", run=run, call=i,
                         kind=kinds[i], side_load=bool(run % 2),
                         max_abs_diff=(got - want).abs().max().item(),
                         card=name)
                    break
    finally:
        B.flash_attention, B.rwkv6_chunked, B.dense = saved
    torch.cuda.synchronize()
    host = _to_cpu(params)
    threads = torch.get_num_threads()
    host_logits = []
    for n in (threads, 1):
        torch.set_num_threads(n)
        host_logits.append(M.prefill(cfg, host, toks, M.init_cache(
            cfg, 1, s + n_dec, device="cpu"))[0])
    torch.set_num_threads(threads)
    want = host_logits[0]
    diff = (first[-1].cpu() - want).abs()
    emit(study="situ_repeat_summary", runs=runs, calls_per_run=len(first),
         runs_differing=differing,
         host_equal_at_1_thread=bool(torch.equal(*host_logits)),
         host_threads=threads, max_abs_err=diff.max().item(),
         worst_over_limit=(diff / (cs.LM_TOL + cs.LM_TOL * want.abs()))
         .max().item(), card=name)


def pipeline_grad(name: str) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    dev = torch.device("cuda:0")
    mesh = make_mesh((4, 1), ("pipe", "model"), ["cuda:0"] * 4)
    for case, seed, d, micro, rows in (
            ("test_pipeline_apply_on_card", 0, 256, 8, (32,)),
            ("chip_smoke phase 42", 42, 2048, 8, (8, 256))):
        gen = torch.Generator(device=dev).manual_seed(seed)
        w = torch.randn(4, d, d, generator=gen, device=dev) / d ** 0.5
        x = torch.randn(micro, *rows, d, generator=gen, device=dev)
        ct = torch.randn(x.shape, generator=gen, device=dev)

        def run(dtype, piped):
            w_, x_ = (t.to(dtype).requires_grad_(True) for t in (w, x))
            if piped:
                y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]),
                                   {"w": w_}, x_, mesh=mesh)
            else:
                y = x_
                for s_ in range(4):
                    y = torch.tanh(y @ w_[s_])
            return (y.detach(), *torch.autograd.grad(
                (y * ct.to(dtype)).sum(), [w_, x_]))

        exact = run(torch.float64, False)
        pipe, seq = run(torch.float32, True), run(torch.float32, False)
        for label, a, b, e in zip(("y", "dw", "dx"), pipe, seq, exact):
            row = {"max_abs": e.abs().max().item()}
            for who, t in (("pipeline", a), ("sequential_f32", b)):
                err = t.double() - e
                row[who] = {"max_abs_err": err.abs().max().item(),
                            "rel_norm": (err.norm() / e.norm()).item()}
            row["pipeline_vs_sequential_max_abs"] = (
                a - b).abs().max().item()
            emit(study="pipeline-grad", case=case, d=d, tensor=label, **row,
                 card=name)


_FIRST_META = r"""
import json, sys, time, torch
t = torch.empty(3, device="meta")
t0 = time.perf_counter(); torch.stack([t, t]); first = time.perf_counter() - t0
t0 = time.perf_counter(); torch.stack([t, t]); second = time.perf_counter() - t0
print(json.dumps(dict(case="torch.stack on meta", first_s=first,
                      second_s=second, sympy="sympy" in sys.modules)))
"""
_FIRST_PREFILL = r"""
import json, sys, time, torch
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.model import init_params
from repro_torch.parallel import sharding as S
cfg = reduced_config(get_config("qwen3-1.7b"))
mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
params = S.shard_tree(init_params(cfg, 0, device="cuda:0"),
                      S.params_shardings(cfg, mesh))
tokens = torch.zeros((8, 32), dtype=torch.int32, device="cuda:0")
_build.load_all("flash_attention")          # nvcc outside the timing
step = make_prefill_step(cfg, 8, 40, mesh)
out = []
for _ in range(2):
    torch.cuda.synchronize(); t0 = time.perf_counter(); step(params, tokens)
    torch.cuda.synchronize(); out.append(time.perf_counter() - t0)
print(json.dumps(dict(case="make_prefill_step on a (2, 2) mesh",
                      first_s=out[0], second_s=out[1],
                      sympy="sympy" in sys.modules)))
"""


def first_meta(name: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for script in (_FIRST_META, _FIRST_PREFILL):
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise SystemExit(out.stderr)
        emit(study="first-meta", **json.loads(out.stdout.splitlines()[-1]),
             card=name)


def k4_bwd_split(name: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(91)
    n = 10
    for label, (b, h, hkv, d, s, kw) in cs.K4_BWD_TIMED.items():
        q, dout = (torch.randn((b, h, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        with torch.no_grad():
            out = flash_attention(q, k, v, **kw)

        def call():
            return flash_attention_bwd(q, k, v, out, dout, **kw)

        ms = cs.event_ms(call)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        events = [(e.key, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        split = {pass_: sum(us for key, us in events if kernel in key) / n
                 for pass_, kernel in (("dq", "attn_bwd_dq"),
                                       ("dk_dv", "attn_bwd_dkdv"))}
        emit(study="k4_bwd_split", case=f"{label} bf16, B={b}, H={h}, "
             f"Hkv={hkv}, D={d}, S={s}, causal, {kw}", ms=ms,
             device_us=split if all(split.values()) else None,
             device_events=len(events),
             kernels_seen=sorted({key for key, _ in events})[:8], card=name)
        del q, k, v, out, dout
        torch.cuda.empty_cache()


def k5_bwd_routes(name: str) -> None:
    from unittest import mock

    import chip_smoke as cs
    import repro_torch.kernels.moe_gemm as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(133)
    rng = np.random.default_rng(134)
    for label in ("dbrx-132b training, gate and up",
                  "dbrx-132b widths, cap 8", "kimi-k2 widths, cap 24"):
        nb, cap, d_in, d_out, n_exp, kind = cs.K5_BWD_CASES[label]
        be = cs.k5_map(kind, nb, n_exp, rng)
        x, w, dy = cs.k5_bwd_inputs(gen, dev, nb, cap, d_in, d_out, n_exp,
                                    torch.bfloat16)
        row = dict(study="k5_bwd_routes", case=f"{label} bf16: {nb} bundles "
                   f"of {cap}, {d_in} -> {d_out}, {n_exp} experts",
                   shipped=K.bwd_route(d_in, d_out))
        for route in ("wgmma", "mma_sync"):
            with mock.patch.object(K, "bwd_route", lambda *a, r=route: r):
                for entry, need in (("dx", (True, False)),
                                    ("dw", (False, True))):
                    row[f"{entry} {route} ms"] = cs.event_ms(
                        lambda: K._k5_bwd(x, w, be, be, dy, *need), 10)
        if kind == "in_graph":               # bundle r * E + e meets e
            rep_ = nb // n_exp
            xg, dyg = (t.reshape(rep_, n_exp, cap, -1).transpose(0, 1)
                       .reshape(n_exp, rep_ * cap, -1).contiguous()
                       for t in (x, dy))
            row["dx torch.bmm ms"] = cs.event_ms(
                lambda: torch.bmm(dyg, w.transpose(1, 2)), 10)
            row["dw torch.bmm ms"] = cs.event_ms(
                lambda: torch.bmm(xg.transpose(1, 2), dyg), 10)
            del xg, dyg
        emit(**row, card=name)
        del x, w, dy
        torch.cuda.empty_cache()


def k6_bwd_routes(name: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels.rwkv6_scan import _k6_bwd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(135)
    n, t, chunk = 10, cs.TRAIN_FULL[cs.RWKV6]["seq"], 64
    for label, (b, h, kk, vv, u_zero) in cs.K6_BWD_HEADS.items():
        r, k, v, w, u, do, _ = cs.k6_bwd_inputs(gen, dev, b, h, t, kk, vv,
                                                torch.bfloat16, u_zero)
        row = dict(study="k6_bwd_routes", case=f"{label} bf16 r/k/v, f32 w: "
                   f"B={b}, H={h}, K={kk}, V={vv}, T={t}, chunk {chunk}")
        for route in ("mma", "fma"):
            def call():
                return _k6_bwd(r, k, v, w, u, do, None, chunk, route=route)

            row[f"{route} ms"] = cs.event_ms(call)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
            events = [(e.key, e.self_device_time_total)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            row[f"{route} device_us"] = {
                kn: us for kn, us in (
                    (kn, sum(us for key, us in events if kn in key) / n)
                    for kn in cs.PORT_KERNEL_NAMES["K6 backward"]) if us}
        emit(**row, card=name)
        del r, k, v, w, u, do
        torch.cuda.empty_cache()


def tp_memory(name: str) -> None:
    """qwen3-1.7b at full width and depth in float32 (params and compute),
    ``chip_smoke.py`` phase 45's prefill (8 x 1024 into a cache of 1040)
    and one decode step, on one device and on the (2, 2) ("data",
    "model") mesh of ``cuda:0`` x 4 (the tensor-parallel route): the
    device memory allocated and its peak so far at the entry and exit of
    each block, the embedding, the head, the stack walk and the cache
    reads and writes, one row a run with the events where the peak rose by
    more than 0.1 GB."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              compute_dtype="float32")
    dev = torch.device("cuda:0")
    params = M.init_params(cfg, 140, device=dev)
    toks = torch.from_numpy(np.random.default_rng(140).integers(
        0, cfg.vocab_size, (8, 1024)).astype(np.int32)).to(dev)
    events = []

    def mark(label):
        torch.cuda.synchronize()
        events.append((label, torch.cuda.memory_allocated() / 1e9,
                       torch.cuda.max_memory_allocated() / 1e9))

    def traced(mod, fname):
        fn = getattr(mod, fname)

        def wrapper(*a, **k):
            mark(fname + " in")
            out = fn(*a, **k)
            mark(fname + " out")
            return out
        setattr(mod, fname, wrapper)
    for mod, fname in ((M, "block_prefill"), (M, "block_prefill_tp"),
                       (M, "block_decode"), (M, "block_decode_tp"),
                       (M, "_embed_in_tp"), (M, "_out_head_tp"),
                       (M, "_out_head"), (M, "_stack_trees"),
                       (ST, "_read_pieces"), (ST, "_write_pieces"),
                       (ST, "write_rows")):
        traced(mod, fname)
    for shape in (None, (2, 2)):
        mesh = shape and make_mesh(shape, ("data", "model"), [dev] * 4)
        events.clear()
        torch.cuda.reset_peak_memory_stats()
        mark("start")
        p = params if mesh is None else S.shard_tree(
            params, S.params_shardings(cfg, mesh))
        mark("params stored")
        logits, cache = ST.make_prefill_step(cfg, 8, 1040, mesh)(p, toks)
        mark("prefill")
        logits, cache = ST.make_decode_step(cfg, mesh)(p, cache,
                                                       toks[:, :1], 1024)
        mark("decode step")
        keep, last = [], -1.0
        for label, alloc, peak in events:
            if peak > last + 0.1 or label in ("prefill", "decode step"):
                keep.append((label, round(alloc, 3), round(peak, 3)))
                last = peak
        emit(study="tp-memory", mesh=shape, events=keep, card=name)
        del p, logits, cache
        torch.cuda.empty_cache()


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("study", choices=("k1-carry", "k3-numerics", "k5-carry",
                                      "k5-bf16", "k5-stream", "k6-time",
                                      "kernel-times", "hymba-repeat",
                                      "situ-repeat", "pipeline-grad",
                                      "first-meta", "k4-bwd-split",
                                      "k5-bwd-routes", "k6-bwd-routes",
                                      "tp-memory"))
    ap.add_argument("--runs", type=int, default=None,
                    help="hymba-repeat: runs per params seed (5); "
                         "situ-repeat: card prefills (200)")
    ap.add_argument("--seeds", type=int, default=10,
                    help="hymba-repeat: params seeds 0 .. seeds - 1")
    args = ap.parse_args()
    name = card()
    if args.study == "k1-carry":
        k1_carry(name)
    elif args.study == "k3-numerics":
        k3_numerics(name)
    elif args.study == "k5-carry":
        k5_carry(name)
    elif args.study == "k5-bf16":
        k5_bf16(name)
    elif args.study == "k5-stream":
        k5_stream(name)
    elif args.study == "k6-time":
        k6_time(name)
    elif args.study == "kernel-times":
        kernel_times(name)
    elif args.study == "situ-repeat":
        situ_repeat(name, args.runs or 200)
    elif args.study == "pipeline-grad":
        pipeline_grad(name)
    elif args.study == "first-meta":
        first_meta(name)
    elif args.study == "k4-bwd-split":
        k4_bwd_split(name)
    elif args.study == "k5-bwd-routes":
        k5_bwd_routes(name)
    elif args.study == "k6-bwd-routes":
        k6_bwd_routes(name)
    elif args.study == "tp-memory":
        tp_memory(name)
    else:
        hymba_repeat(name, args.runs or 5, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The yardstick's counts against hand counts: each kernel's operations and
bytes a launch at small shapes, the ``mfu`` formulas at a reduced
configuration, the trace's busy time, gaps and their labels."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import devtrace  # noqa: E402
from bench.roofline import k4, k5, k6, mfu, peaks  # noqa: E402


def test_k6_forward_and_backward_by_hand():
    rec = dict(kind="fwd", b=1, h=2, t=8, kk=4, vv=4, chunk=4,
               r_dtype="bfloat16", w_dtype="float32")
    flop, nbytes, peak = k6.fwd(rec)
    # state products 2·B·H·T·K·V = 512, chunk pairs 2·B·H·T·C·(K+V) = 1024
    assert flop == 512 + 1024
    # r, k (64 each) and v (64) in bf16, w (64) f32, u (8) f32, o (64) f32,
    # the final state (32) f32
    assert nbytes == 192 * 2 + 64 * 4 + 8 * 4 + 64 * 4 + 32 * 4
    assert peak == peaks.BF16_FLOPS
    flop_b, bytes_b, _ = k6.bwd(dict(rec, kind="bwd"))
    # a chunk: 6 pairs · 6 · 4 + 4 · 5 · 2 · 4 + 10 · 4 · 4 · 4 = 944;
    # B·H·(T/C) = 4 chunks
    assert flop_b == 4 * (6 * 6 * 4 + 4 * 5 * 2 * 4 + 10 * 4 * 4 * 4)
    assert bytes_b == 2 * (192 * 2 + 64 * 4 + 8 * 4) + 64 * 4


def test_k5_counts_the_kept_rows_not_the_padding():
    rec = dict(kind="fwd", nb=4, cap=8, d_in=16, d_out=32, n_experts=2,
               dtype="bfloat16", kept=10)
    flop, nbytes, peak = k5.fwd(rec)
    assert flop == 2 * 10 * 16 * 32
    assert nbytes == (10 * 16 + 2 * 16 * 32 + 10 * 32) * 2 + 4 * 4
    assert peak == peaks.BF16_FLOPS
    flop_b, bytes_b, _ = k5.bwd(dict(rec, kind="bwd"))
    assert flop_b == 2 * flop
    assert bytes_b == 2 * (10 * 16 + 2 * 16 * 32) * 2 + 10 * 32 * 2


def test_k4_by_hand():
    assert k4.causal_pairs(4) == 10
    assert k4.causal_pairs(6, window=2) == 3 + 4 * 2
    rec = dict(b=1, h=4, hkv=2, s=4, d=8, pairs=10, dtype="float32")
    flop, nbytes, peak = k4.fwd(rec)
    assert flop == 4 * 4 * 10 * 8
    assert nbytes == (2 * 4 * 4 * 8 + 2 * 2 * 4 * 8) * 4
    assert peak == peaks.FP32_FLOPS
    flop_b, _, _ = k4.bwd(rec)
    assert flop_b == 10 * 4 * 10 * 8


def test_bound_takes_the_binding_term():
    assert peaks.bound_s(989e12, 0, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, peaks.BF16_FLOPS) == pytest.approx(1.0)


SMALL_RWKV = dict(mixer="rwkv", ffn="rwkv_cm", d_model=4, n_heads=1,
                  d_head=4, d_ff=8, n_layers=2, vocab_size=10)
SMALL_MOE = dict(mixer="attn", ffn="moe", d_model=4, n_heads=2, n_kv_heads=1,
                 d_head=2, n_experts=4, moe_top_k=2, d_ff_expert=3,
                 n_layers=1, vocab_size=10)


def test_mfu_training_by_hand():
    # a layer: r, k, v, g, w and out 6 · 16 = 96; channel mix 16 + 2 · 32
    # = 80; two layers 352; head 40; WKV forward 4 · 1 · 4 · 4 = 64 a token
    per_token = 6 * (352 + 40)
    assert mfu.train_flop(SMALL_RWKV, 3, 5) == 15 * per_token \
        + 3 * 2 * 3 * 64 * 5


def test_mfu_prefill_by_hand():
    # attention: q, o 2 · 4 · 4 = 32, k, v 2 · 4 · 2 = 16; router 16;
    # experts 2 of 3 · 4 · 3 = 72; head 40 (the last position only)
    active = 32 + 16 + 16 + 72
    pairs = 6 * 7 / 2
    assert mfu.prefill_flop(SMALL_MOE, 6) == 2 * active * 6 \
        + 4 * 2 * 2 * pairs + 2 * 40


def test_trace_busy_gaps_and_labels():
    device = [("k1", 10, 20), ("k2", 15, 30), ("memcpy", 50, 60),
              ("Activity Buffer Request", 0, 100)]
    host = [(devtrace.TRACED, 0, 100, True),
            ("bench.train_step", 0, 45, True),
            ("aten::mm", 32, 44, False),
            ("bench.batch", 45, 100, True),
            ("cudaStreamSynchronize", 61, 99, False)]
    t = devtrace.DeviceTrace(device, host, 0, 100)
    assert t.busy == [(10, 30), (50, 60)]
    assert t.busy_s == pytest.approx(30e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.gaps() == [(0, 10), (30, 50), (60, 100)]
    assert t.kernel_seconds(["k"]) == (pytest.approx(25e-9), 2)
    gaps = dict((n, s) for n, s in t.idle_gaps())
    assert gaps == {"bench.train_step": pytest.approx(10e-9),
                    "bench.train_step > aten::mm": pytest.approx(20e-9),
                    "bench.batch > cudaStreamSynchronize":
                        pytest.approx(40e-9)}
    assert t.device_ops()[0] == ["k2", pytest.approx(15e-9)]

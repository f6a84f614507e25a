"""Each cell's control comes out not correct: the reference put in the
program's place and computed in the precision below the configuration's
(fp8 products for its bfloat16 ones), against the float32 reference, under
the cell's limits.  On the host at a toy size; on a card (``gpu``) at the
cell's own size on three seeds:

    PYTHONPATH=src python -m pytest -m gpu bench/tests/test_bench_control.py
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.tools import readings  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
             d_ff=128, vocab_size=256)
MOE = dict(SMALL, n_kv_heads=2, d_ff=64, d_ff_expert=64, n_experts=4,
           moe_top_k=2)
TOY = {"rwkv6-1.6b.train": (SMALL, dict(batch=2, seq=128)),
       "dbrx-132b.prefill": (MOE, dict(max_seq=129, min_len=16, max_len=128,
                                       n_lengths=8, n_compared=4, rows=8))}


def fails(run, reading) -> bool:
    """Whether the control fails one of the numbers the cell compares."""
    return any(v > run.limits[k] for k, v in reading.items()
               if k in run.limits)


def control(run, seed):
    fn = readings.control_train if run.workload["driver"] == "train" \
        else readings.control_prefill
    return fn(run, seed)


@pytest.mark.parametrize("cell", sorted(TOY))
def test_the_control_fails_on_the_host(cell):
    sizes, params = TOY[cell]
    run = harness.Run(cell, 17, 0, False, "cpu",
                      overrides={"config": sizes, "params": params})
    out = control(run, 17)
    assert fails(run, out["control_fp8"]), out


def test_the_half_batch_fault_reads_on_the_reference():
    sizes, params = TOY["rwkv6-1.6b.train"]
    run = harness.Run("rwkv6-1.6b.train", 19, 0, False, "cpu",
                      overrides={"config": sizes, "params": params})
    out = control(run, 19)
    assert fails(run, out["fault_half_batch"]), out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(TOY))
def test_the_control_fails_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = harness.Run(cell, 0, 0, False, "cuda")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = control(run, seed)
        print(cell, seed, out)
        assert fails(run, out["control_fp8"]), out
        torch.cuda.empty_cache()

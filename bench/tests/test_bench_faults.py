"""A whole run of each cell on the host at a toy size, past the look for a
card, with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, under the cell's own limits, and true for the
sound run.  Training: a step that returns its state unchanged; a step that
leaves half of its batch out (the mean over the rest).  Prefill: a token
altered where it is produced.  (One card: no exchange between chips.)"""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
             d_ff=128, vocab_size=256, compute_dtype="float32")
MOE = dict(SMALL, n_kv_heads=2, d_ff=64, d_ff_expert=64, n_experts=4,
           moe_top_k=2, param_dtype="float32")


def overrides(cell):
    train = cell.endswith(".train")
    sizes = SMALL if train else MOE
    config = harness.cell_files(cell)[2]
    cfg = dict(sizes, program={"arch": config["program"]["arch"],
                               "overrides": sizes})
    params = dict(batch=2, seq=128, trace_after_s=0.0, trace_span_s=0.5) \
        if train else dict(max_seq=129, min_len=16, max_len=128,
                           n_lengths=8, n_compared=4, rows=8,
                           keep_share=0.5)
    return {"config": cfg, "params": params}


def run(cell, trace=False):
    return harness.run_cell(cell, 2 ** 31 + 3, 1.0, trace, "cpu",
                            overrides=overrides(cell))


@pytest.fixture
def train_step(monkeypatch):
    """Replace the program's step by ``wrap(step)``."""
    from repro_torch.launch import steps
    real = steps.make_train_step

    def install(wrap):
        monkeypatch.setattr(steps, "make_train_step",
                            lambda *a, **k: wrap(real(*a, **k)))
    return install


def test_sound_runs_are_correct():
    line = run("rwkv6-1.6b.train", trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["correct"] is run("dbrx-132b.prefill")["correct"] is True


def test_a_step_that_returns_its_state_unchanged(train_step):
    def wrap(step):
        def unchanged(params, opt_state, batch):
            _, _, metrics = step(copy.deepcopy(params),
                                 copy.deepcopy(opt_state), batch)
            return params, opt_state, metrics
        return unchanged
    train_step(wrap)
    line = run("rwkv6-1.6b.train")
    assert line["correct"] is False
    assert line["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_a_step_that_leaves_half_its_batch_out(train_step):
    def wrap(step):
        def half(params, opt_state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(params, opt_state, {k: v[:n] for k, v in
                                            batch.items()})
        return half
    train_step(wrap)
    assert run("rwkv6-1.6b.train")["correct"] is False


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.models import model as M
    real = M.prefill

    def altered(*args, **kw):
        logits, cache = real(*args, **kw)
        return torch.roll(logits, 1, dims=-1), cache
    monkeypatch.setattr(M, "prefill", altered)
    line = run("dbrx-132b.prefill")
    assert line["correct"] is False
    assert line["checks"]["logit_err_worst_request"]["value"] > 0.5

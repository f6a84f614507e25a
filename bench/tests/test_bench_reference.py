"""The plain references held against the port on the host, at reduced
configurations, through the port's plain paths, in float32 compute:
rwkv6's loss, gradients and AdamW steps through ``make_train_step``, and
dbrx's logits at chosen positions (the last among them) through
``model.prefill`` with capacity drops.
(The test imports the port; the references do not.)"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench import weights as W  # noqa: E402
from bench.reference import dbrx, rwkv6  # noqa: E402
from bench.traffic import train  # noqa: E402
from bench.traffic.synthetic import SyntheticLM  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
             d_ff=128, vocab_size=256, compute_dtype="float32")


def small_config(name, **extra):
    c = harness.load_json(ROOT / "bench" / "configs" / f"{name}.json")
    sizes = dict(SMALL, **extra)
    c.update(sizes)
    c["program"] = {"arch": c["program"]["arch"], "overrides": sizes}
    return c


def program_config(c):
    from repro_torch.configs import get_config
    return get_config(c["program"]["arch"], **c["program"]["overrides"])


def test_rwkv6_loss_gradients_and_adamw_steps():
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    c = small_config("rwkv6-1.6b")
    cfg = program_config(c)
    dev = torch.device("cpu")
    spec = rwkv6.param_spec(c)
    train.check_tree(spec, M.abstract_params(cfg))
    params = W.make_tree(spec, 7, dev)
    start = {p: t.clone() for p, t in W.leaves(params)}
    opt = dict(lr=3e-3, warmup_steps=10, total_steps=100)
    opt_cfg = adamw.AdamWConfig(**opt)
    state = adamw.init(opt_cfg, params)
    step = steps.make_train_step(cfg, opt_cfg)
    feed = SyntheticLM(c["vocab_size"], 128, 2, 7)
    batches = [feed.batch_at(i) for i in range(2)]
    losses = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state,
                                {k: torch.from_numpy(v) for k, v in
                                 b.items()})
        losses.append(float(m["loss"]))
        if i == 0:
            first = {"/".join(p): t / (1 - opt_cfg.b1)
                     for p, t in W.leaves(state["m"])}
    change = {"/".join(p): float((t.detach() - start[p]).norm())
              for p, t in W.leaves(params)}
    ref = rwkv6.train_readings(c, 7, batches, opt, dev, against=first)
    got = train.gaps({"losses": losses, "change_norms": change,
                      "grad_norms": {k: float(v.norm())
                                     for k, v in first.items()}}, ref)
    assert max(train.loss_gaps({"losses": losses}, ref)) < 1e-5
    assert got["grad_rel_err"] < 1e-4
    assert got["grad_norm_gap"] < 1e-4
    # Adam's first update is lr · sign(g) an element: an element whose
    # gradient is nought to rounding (a decay clamped at its bound) moves
    # either way in either float32 run, so the norms of the change agree
    # to a few 1e-4 (w_bias: 3.9e-4 at this seed), not to float32's 1e-7
    assert got["update_norm_gap"] < 2e-3


def test_dbrx_last_logits_with_capacity_drops():
    from repro_torch.models import model as M
    c = small_config("dbrx-132b", n_kv_heads=2, d_ff=64, d_ff_expert=64,
                     n_experts=4, moe_top_k=2, param_dtype="float32",
                     capacity_factor=0.5)
    cfg = program_config(c)
    dev = torch.device("cpu")
    spec = dbrx.param_spec(c)
    train.check_tree(spec, M.abstract_params(cfg))
    params = W.make_tree(spec, 9, dev)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (40, 64, 17)]
    # a few positions of each prompt, its last among them
    pos = [np.array([0, 5, 39]), np.array([3, 31, 32, 63]), np.array([16])]
    want = []
    for pr, at in zip(prompts, pos):
        cache = M.init_cache(cfg, 1, len(pr) + 1, device="cpu")
        logits, _ = M.prefill(cfg, params, torch.from_numpy(pr)[None],
                              cache)
        want.append(logits[0, torch.from_numpy(at)])
    got = dbrx.logits_at(c, 9, prompts, pos, dev)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-4)
    last = torch.stack([w[-1] for w in want])
    assert dbrx.served_gaps(torch.stack([g[-1] for g in got]),
                            [int(row.argmax()) for row in last]) == \
        pytest.approx([0.0, 0.0, 0.0])
    # at these sizes more assignments are routed than the experts hold:
    # every prompt drops some (64 · 2 > 4 · 16)
    assert 64 * 2 > 4 * dbrx.capacity(c, 64)


def test_a_stacked_leaf_is_made_again_layer_by_layer():
    leaf = W.Leaf(("layers", "w"), (3, 4, 5), "normal", 0.5, True,
                  "bfloat16")
    whole = W.make_leaf(leaf, 2 ** 31 + 5, "cpu")
    for i in range(3):
        assert torch.equal(whole[i], W.make_leaf(leaf, 2 ** 31 + 5, "cpu",
                                                 layer=i))
    assert not torch.equal(whole[0], whole[1])

"""Training traffic: steps of ``make_train_step`` on fresh seeded batches.

Set-up builds one training state (the weights from the seed, AdamW's state,
the step) and drives it through its first ``compared_steps`` steps through
the same call and feed as the window, on batches whose rows all differ;
those steps warm every shape and are what the reference follows.  Their
readings (each step's loss, each leaf's first gradient as the optimizer
takes it, read from m after one step, and each leaf's change after the
last) are taken before the window.  The window then runs steps back to back
for ``--seconds``, each on the next batch of the feed, made on the host and
copied as a trainer's loop does, and closes after ``torch.cuda.
synchronize()``.

``train_tokens_per_s``: the tokens of every step the window ran over its
seconds.  After the window, with the peak memory read and the program's
state freed, the reference (``bench/reference/<config>.py``) repeats the
first steps in float32 and the gaps are compared:

* ``grad_rel_err``: over the leaves, the largest ||gradient - reference
  gradient|| of the first step, over the larger of the leaf's reference
  norm and the median leaf's;
* ``grad_norm_gap``: the same of |norm - reference norm| of the first
  gradient;
* ``update_norm_gap``: the same of each leaf's change after the compared
  steps, over the norms of the change, leaving out the leaves whose
  reference gradient is nought to rounding (its RMS under a thousandth of
  the median leaf's).

The control, which rounds every product to fp8, fails on ``grad_rel_err``;
a gap of norms moves with rounding only to second order (noise at right
angles to a gradient hardly alters its norm), so the norm gaps read the
control about as sound runs do.  They are held against the faults of a
step (half of its batch left out, its state left unchanged) and against a
leaf's gradient off in scale, which ``grad_rel_err``, wide with the
rounding of 24 bfloat16 layers, would let by.  The program's first
gradient is read from m after the first step (m / (1 - b1)), its norms
taken on the card, and kept on the host for the reference to judge.

Each step's loss gap is printed beside them (the first step's is a mean
over 16,384 tokens, whose rounding errors cancel; the later steps' swing
with the loss, which at this rate goes from about 11.6 to 20 and back
within three steps).
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict

from bench import harness
from bench import weights as W
from bench.traffic.synthetic import SyntheticLM


def check_tree(spec, abstract) -> None:
    """The reference's parameter spec against the program's tree: the same
    paths, shapes and dtypes."""
    want = {leaf.path: (tuple(leaf.shape), leaf.dtype) for leaf in spec}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in W.leaves(abstract)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the program's parameter tree differs from the "
                         f"reference's: {diff[:6]}")


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three compared numbers (see the module's docstring); ``ref``'s
    ``grad_diffs`` hold ||program - reference|| of each leaf's first
    gradient."""
    keys = sorted(ref["grad_norms"])
    norms = ref["grad_norms"]

    def worst(gap: Dict, want: Dict, among) -> float:
        med = statistics.median(want[k] for k in among)
        return max(gap[k] / max(want[k], med, 1e-30) for k in among)

    med_rms = statistics.median(ref["grad_rms"].values())
    moved = [k for k in keys if ref["grad_rms"][k] >= 1e-3 * med_rms]
    change = ref["change_norms"]
    return {"grad_rel_err": worst(ref["grad_diffs"], norms, keys),
            "grad_norm_gap": worst({k: abs(prog["grad_norms"][k] - norms[k])
                                    for k in keys}, norms, keys),
            "update_norm_gap": worst({k: abs(prog["change_norms"][k]
                                             - change[k]) for k in moved},
                                     change, moved)}


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> Dict[str, list]:
    """The ``n`` leaves that read worst in each compared number."""
    norms, med = ref["grad_norms"], statistics.median(ref["grad_norms"]
                                                      .values())

    def top(gap: Dict) -> list:
        rel = {k: g / max(norms[k], med, 1e-30) for k, g in gap.items()}
        return [[k, float(f"{rel[k]:.4g}")] for k in
                sorted(rel, key=rel.get, reverse=True)[:n]]
    return {"grad_rel_err": top(ref["grad_diffs"]),
            "grad_norm_gap": top({k: abs(prog["grad_norms"][k] - norms[k])
                                  for k in norms})}


def loss_gaps(prog: Dict, ref: Dict) -> list:
    """Every step's relative loss gap (a reading beside the first's)."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]


def run(R: harness.Run) -> harness.Outcome:
    with R.phase("imports"):
        import torch
        from repro_torch.launch import steps
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
    P, c, dev = R.params, R.config, R.device
    ref = R.reference()
    cfg = R.program_config()
    with R.phase("libraries"):
        R.load_libraries()
    opt = dict(lr=P["lr"], warmup_steps=P["warmup_steps"],
               total_steps=P["total_steps"])
    with R.phase("weights"):
        spec = ref.param_spec(c)
        check_tree(spec, M.abstract_params(cfg))
        params = W.make_tree(spec, R.seed, dev)
        start = {p: t.detach().clone() for p, t in W.leaves(params)}
        opt_cfg = adamw.AdamWConfig(**opt)
        opt_state = adamw.init(opt_cfg, params)
        step_fn = steps.make_train_step(cfg, opt_cfg)
        feed = SyntheticLM(c["vocab_size"], P["seq"], P["batch"], R.seed)

    def batch_on_device(i):
        host = feed.batch_at(i)
        return host, {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    host_batches, losses = [], []
    with R.phase("warm-up"):
        for i in range(P["compared_steps"]):
            t_step = time.perf_counter()
            host, batch = batch_on_device(i)
            host_batches.append(host)
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(m["loss"])
            if i == 0:      # the first gradient as AdamW took it: m / (1 - b1)
                clip_scale = min(opt_cfg.clip_norm
                                 / (float(m["grad_norm"]) + 1e-9), 1.0)
                with torch.no_grad():
                    first = {"/".join(p): t.float() / (1.0 - opt_cfg.b1)
                             for p, t in W.leaves(opt_state["m"])}
                    # norms on the card: a float32 norm on the host loses
                    # 1-8 % over a leaf of 10^8 elements
                    first_norms = {k: float(torch.linalg.vector_norm(v))
                                   for k, v in first.items()}
                    first = {k: v.cpu() for k, v in first.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            harness.log(f"warm-up step {i + 1}: "
                        f"{time.perf_counter() - t_step:.3f} s")
        with torch.no_grad():
            change = {"/".join(p): torch.linalg.vector_norm(
                t.float() - start[p].float()) for p, t in W.leaves(params)}
        del start
        prog = {"losses": [float(x) for x in losses],
                "grad_norms": first_norms,
                "change_norms": {k: float(v) for k, v in change.items()}}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    R.start_window()
    n = traced = 0
    step = P["compared_steps"]
    window_losses = []
    while True:
        traced += R.tracing
        with torch.profiler.record_function("bench.batch"):
            _, batch = batch_on_device(step)
        with torch.profiler.record_function("bench.train_step"):
            params, opt_state, m = step_fn(params, opt_state, batch)
        window_losses.append(m["loss"])
        n += 1
        step += 1
        if R.boundary():
            break
    seconds = R.close_window()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    del params, opt_state, step_fn, m, batch, window_losses, change
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = ref.train_readings(c, R.seed, host_batches, opt, dev,
                                  against=first)
    ref_s = time.perf_counter() - t_ref
    checks = gaps(prog, readings)
    tokens = n * P["batch"] * P["seq"]
    return harness.Outcome(
        metrics={"train_tokens_per_s": tokens / seconds},
        checks=checks, attempted=n, failed=failed, memory_peak_bytes=peak,
        work={"steps": traced, "batch": P["batch"], "seq": P["seq"]},
        notes={"window": f"{n} steps in {seconds:.3f} s",
               "loss gaps by step": loss_gaps(prog, readings),
               "worst leaves": worst_leaves(prog, readings),
               "first clip scale": f"program {clip_scale!r}, reference "
                                   f"{readings['clip_scale']!r}",
               "losses": f"program {prog['losses']}, reference "
                         f"{readings['losses']}",
               "finite": all(math.isfinite(x) for x in prog["losses"]),
               "reference": f"{ref_s:.3f} s"})

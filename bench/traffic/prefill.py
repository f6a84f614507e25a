"""Long-prompt traffic: requests that need one token, in a closed loop of
``clients`` clients through ``ServeScheduler`` (``submit`` and ``step``).

Each client sends its next request when its last one has its first token,
as users who wait for an answer do.  The prompt lengths are a fixed set of
``n_lengths`` lengths, log-uniform over ``[min_len, max_len]`` (each the
set's quantile), sent in one fixed shuffled cycle; the seed turns the cycle
by a whole number of steps (``clients`` requests a step) and draws every
prompt's token ids, uniform over the vocabulary.  Every seed so sends the
same lengths, grouped into the same steps, in another order: which long
prompts share a step sets the tail of the time to first token, which a
shuffle drawn from the seed would move from seed to seed.  Lengths above
``round_above`` are rounded to a multiple of it: the program's exact-length
prefill of a mixture-of-experts model refuses any other length there (its
attention takes a length that is a multiple of ``min(1024, S)``).

Set-up makes the weights, builds the scheduler, warms the prefill of every
length of the mix (``prewarm``) and runs ``warm_steps`` steps of the loop.
The window then steps the loop for ``--seconds`` and closes after
``torch.cuda.synchronize()``; each request's times are the harness's own
clock at its ``submit`` and at its first token (``on_token``).

* ``prefill_tokens_per_s``: the prompt tokens of every request whose first
  token came in the window, over the window's seconds;
* ``ttft_s.p95``: the 95th percentile (nearest rank) of those requests'
  submit-to-first-token times, the wait in the queue included.

The prefill's output is kept as the scheduler takes it: a wrapper around
``model.prefill`` (the call the scheduler makes) hands ``on_token`` the
prefill's float32 logits over every position, and it keeps, of each request
in a subset drawn from the seed (a share ``keep_share``, and every prompt of
the mix's longest length), ``rows`` of them: the last position's, whose
argmax is the request's first token, and ``rows - 1`` positions drawn from
the seed.  After the window, with the peak memory read and the scheduler
freed, a sample of ``n_compared`` of those requests that the window
finished, drawn from the seed, the longest among them, goes through the
reference in float32 at the same positions.  Each request is held on its
own: the compared number ``logit_err_worst_request`` is the largest, over
the sampled requests, of the median over a request's rows of
||logits - reference|| / ||reference||.  The median within a request stands
against a routing decision that bfloat16 rounding turns (a token's 4th and
5th experts all but tied), which moves that one position's logits by
tenths in program and control alike; a fault in any request, the longest
included, moves all of its rows.  Beside it, as readings: each request's
last-position error and the widest gap by which a served token's reference
logit lies below the reference's best (PERF.md gives the readings).
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np

from bench import harness
from bench import weights as W
from bench.traffic.train import check_tree


def lengths(P: Dict) -> List[int]:
    """The mix's fixed set of prompt lengths."""
    lo, hi, n, block = (P[k] for k in ("min_len", "max_len", "n_lengths",
                                       "round_above"))
    out = []
    for i in range(n):
        length = lo * (hi / lo) ** ((i + 0.5) / n)
        if length > block:
            length = block * max(1, round(length / block))
        out.append(int(min(round(length), hi)))
    return out


def length_of(P: Dict, seed: int, k: int) -> int:
    """Request ``k``'s prompt length under ``seed``."""
    mix = lengths(P)
    cycle = np.random.default_rng(0).permutation(len(mix))
    turn = P["clients"] * (seed % max(1, len(mix) // P["clients"]))
    return mix[cycle[(k + turn) % len(mix)]]


def prompt(seed: int, k: int, length: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 2, k])
    return rng.integers(0, vocab, size=length, dtype=np.int64).astype(
        np.int32)


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def kept(P: Dict, seed: int, k: int, length: int) -> bool:
    """Whether request ``k``'s rows are kept for the comparison."""
    return length == max(lengths(P)) or \
        np.random.default_rng([seed, 5, k]).random() < P["keep_share"]


def positions(P: Dict, seed: int, k: int, length: int) -> np.ndarray:
    """The positions of request ``k``'s compared rows: ``rows - 1`` drawn
    from the seed, then its last."""
    n = min(P["rows"], length)
    rng = np.random.default_rng([seed, 4, k])
    drawn = np.sort(rng.choice(length - 1, size=n - 1, replace=False))
    return np.append(drawn, length - 1)


def worst_request(errors: List[List[float]]) -> float:
    """The compared number: the largest per-request median of its rows'
    relative errors."""
    return max(statistics.median(e) for e in errors)


def _drive(R, sched, sent: Dict) -> List[int]:
    """Warm-up and the window of the closed loop; the prompt lengths of the
    requests whose prefill ran in the traced span."""
    import torch
    from repro_torch.launch.scheduler import Request
    P, dev, vocab = R.params, R.device, R.config["vocab_size"]
    owner: Dict[int, int] = {}

    def submit(client: int) -> None:
        k = len(sent)
        length = length_of(P, R.seed, k)
        req = Request(rid=k, prompt=prompt(R.seed, k, length, vocab), gen=1)
        owner[k] = client
        sent[k] = {"len": length, "prompt": req.prompt,
                   "kept": kept(P, R.seed, k, length),
                   "pos": positions(P, R.seed, k, length),
                   "t_submit": time.perf_counter()}
        sched.submit(req)

    def loop_step() -> List[int]:
        done = len(sched.completions)
        with torch.profiler.record_function("bench.scheduler_step"):
            sched.step()
        rids = [comp.rid for comp in sched.completions[done:]]
        with torch.profiler.record_function("bench.submit"):
            for rid in rids:
                submit(owner[rid])
        return rids

    with R.phase("warm-up"):
        sched.prewarm(sorted(set(lengths(P))))
        for client in range(P["clients"]):
            submit(client)
        for _ in range(P["warm_steps"]):
            loop_step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    R.start_window()
    traced: List[int] = []
    while True:
        tracing = R.tracing
        rids = loop_step()
        if tracing:
            traced += [sent[r]["len"] for r in rids]
        if R.boundary():
            break
    R.close_window()
    return traced


def run(R: harness.Run) -> harness.Outcome:
    with R.phase("imports"):
        import torch
        from repro_torch.launch.scheduler import ServeScheduler
        from repro_torch.models import model as M
    P, c, dev = R.params, R.config, R.device
    ref = R.reference()
    cfg = R.program_config()
    vocab = c["vocab_size"]
    with R.phase("libraries"):
        R.load_libraries()
    with R.phase("weights"):
        spec = ref.param_spec(c)
        check_tree(spec, M.abstract_params(cfg))
        params = W.make_tree(spec, R.seed, dev)

    sent: Dict[int, Dict] = {}
    pending: List = []
    real_prefill = M.prefill

    def prefill_kept(*args, **kw):
        logits, cache = real_prefill(*args, **kw)
        pending[:] = [logits]
        return logits, cache

    def on_token(rid, token, step):
        s = sent[rid]
        s["t_first"] = time.perf_counter()
        s["token"] = int(token)
        logits = pending.pop()
        if s["kept"]:
            at = torch.as_tensor(s["pos"], device=logits.device)
            s["rows"] = logits[0].index_select(0, at)

    M.prefill = prefill_kept
    try:
        with R.phase("scheduler"):
            sched = ServeScheduler(cfg, params, max_batch=P["clients"],
                                   max_seq=P["max_seq"], on_token=on_token,
                                   device=dev)
            del params
        traced = _drive(R, sched, sent)
    finally:
        M.prefill = real_prefill
    t0, t1 = R.window_start, R.window_end
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del sched
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    done = sorted(k for k, s in sent.items()
                  if "t_first" in s and t0 <= s["t_first"] <= t1)
    failed = sum(not 0 <= sent[k]["token"] < vocab for k in done)
    ttft = [sent[k]["t_first"] - sent[k]["t_submit"] for k in done]
    tokens = sum(sent[k]["len"] for k in done)

    pool = [k for k in done if sent[k]["kept"]]
    rng = np.random.default_rng([R.seed, 3])
    longest = max(pool, key=lambda k: (sent[k]["len"], -k))
    rest = [k for k in pool if k != longest]
    picked = [longest] + [rest[i] for i in rng.choice(
        len(rest), size=min(P["n_compared"] - 1, len(rest)), replace=False)]
    t_ref = time.perf_counter()
    want = ref.logits_at(c, R.seed, [sent[k]["prompt"] for k in picked],
                         [sent[k]["pos"] for k in picked], dev)
    errors = [ref.rel_errors(sent[k]["rows"], w) for k, w in
              zip(picked, want)]
    gap = ref.served_gaps(torch.stack([w[-1] for w in want]),
                          [sent[k]["token"] for k in picked])
    rows = [e for errs in errors for e in errs]
    return harness.Outcome(
        metrics={"prefill_tokens_per_s": tokens / (t1 - t0),
                 "ttft_s.p95": p95(ttft)},
        checks={"logit_err_worst_request": worst_request(errors)},
        attempted=len(done), failed=failed, memory_peak_bytes=peak,
        work={"prompt_lens": traced},
        notes={"window": f"{len(done)} requests, {tokens} prompt tokens in "
                         f"{t1 - t0:.3f} s",
               "compared": f"{len(picked)} requests of {len(pool)} kept "
                           f"(longest {sent[longest]['len']}), "
                           f"{len(rows)} rows",
               "request medians": [float(f"{statistics.median(e):.4g}")
                                   for e in errors],
               "request lengths": [sent[k]["len"] for k in picked],
               "last rows": [float(f"{e[-1]:.4g}") for e in errors],
               "rows above 0.04": sum(e > 0.04 for e in rows) / len(rows),
               "served_logit_gap": f"{max(gap)!r}, by request "
                                   f"{[round(g, 5) for g in gap]}",
               "traced": f"{len(traced)} requests",
               "reference": f"{time.perf_counter() - t_ref:.3f} s"})

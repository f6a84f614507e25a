"""Readings that a cell's limits are set from, on the chip at the cell's own
size, in one process (set-up is long):

* ``--program``: full runs of the cell (``harness.run_cell``, a short
  window) on each seed; each prints the numbers it compares;
* ``--control``: the reference put in the program's place, computed in the
  precision below the configuration's (fp8 for its bfloat16 products),
  against the float32 reference, on each seed; for a training cell also the
  fault of a step that leaves half of its batch out, read on the reference.

    python3 bench/tools/readings.py --cell rwkv6-1.6b.train --program \\
        --seeds 11 12 13 --seconds 3

One JSON line a reading.  Needs a card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).parent:
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def judged(other: dict, f32: dict) -> dict:
    """The float32 reference's readings with ``other``'s first gradients
    judged against its own (each leaf's difference norm, summed in float64:
    a float32 norm on the host loses 1-8 % over 10^8 elements)."""
    import torch
    diffs = {k: float(torch.linalg.vector_norm(
                 other["first"][k].double() - f32["first"][k].double()))
             for k in f32["first"]}
    return {**f32, "grad_diffs": diffs}


def control_train(run, seed: int) -> dict:
    """The training control and the half-batch fault on one seed."""
    from bench.traffic import train
    from bench.traffic.synthetic import SyntheticLM
    ref, c, P = run.reference(), run.config, run.params
    feed = SyntheticLM(c["vocab_size"], P["seq"], P["batch"], seed)
    batches = [feed.batch_at(i) for i in range(P["compared_steps"])]
    opt = dict(lr=P["lr"], warmup_steps=P["warmup_steps"],
               total_steps=P["total_steps"])
    f32 = ref.train_readings(c, seed, batches, opt, run.device,
                             keep_first=True)
    out = {}
    low = ref.train_readings(c, seed, batches, opt, run.device, "fp8",
                             keep_first=True)
    out["control_fp8"] = train.gaps(low, judged(low, f32))
    half = ref.train_readings(c, seed, batches, opt, run.device,
                              rows=range(P["batch"] // 2), keep_first=True)
    out["fault_half_batch"] = train.gaps(half, judged(half, f32))
    out["loss_gaps_by_step"] = {"control_fp8": train.loss_gaps(low, f32),
                                "fault_half_batch": train.loss_gaps(half,
                                                                    f32)}
    out["f32_losses"] = f32["losses"]
    return out


def control_prefill(run, seed: int) -> dict:
    """The prefill control on one seed: a prompt of the mix's longest length
    and ``n_compared - 1`` more, at the rows a run compares."""
    import torch
    from bench.traffic import prefill
    ref, c, P = run.reference(), run.config, run.params
    lens = [P["max_len"]] + [prefill.length_of(P, seed, k)
                             for k in range(1, P["n_compared"])]
    prompts = [prefill.prompt(seed, k, n, c["vocab_size"])
               for k, n in enumerate(lens)]
    pos = [prefill.positions(P, seed, k, n) for k, n in enumerate(lens)]
    f32 = ref.logits_at(c, seed, prompts, pos, run.device)
    low = ref.logits_at(c, seed, prompts, pos, run.device, "fp8")
    errors = [ref.rel_errors(lo, hi) for lo, hi in zip(low, f32)]
    gaps = ref.served_gaps(torch.stack([w[-1] for w in f32]),
                           [int(w[-1].argmax()) for w in low])
    return {"control_fp8": {"logit_err_worst_request":
                            prefill.worst_request(errors)},
            "request_medians": [statistics.median(e) for e in errors],
            "least_request_median": min(statistics.median(e)
                                        for e in errors),
            "last_rows": [e[-1] for e in errors],
            "served_logit_gap": max(gaps), "lengths": lens}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    for seed in args.seeds:
        if args.program:
            t = time.perf_counter()
            line = harness.run_cell(args.cell, seed, args.seconds, False)
            print(json.dumps({"cell": args.cell, "seed": seed,
                              "kind": "program", "checks": line["checks"],
                              "notes": line.get("notes", {}),
                              "metrics": line["metrics"],
                              "s": time.perf_counter() - t}), flush=True)
        if args.control:
            t = time.perf_counter()
            run = harness.Run(args.cell, seed, 0, False)
            fn = control_train if run.workload["driver"] == "train" \
                else control_prefill
            out = fn(run, seed)
            print(json.dumps({"cell": args.cell, "seed": seed,
                              "kind": "control", **out,
                              "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

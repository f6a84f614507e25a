"""Serving driver: one-shot batch generation or a continuous-batching loop.

Port of ``repro.launch.serve`` for the decoder-only models the port runs
(the ``attn`` and ``hymba`` mixers with the SwiGLU FFN).  One-shot (fixed
batch, every row the same prompt length and gen):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --batch 2 --prompt-len 32 --gen 8 --device cpu

Continuous batching (trace-driven scheduler, per-request lengths, KV-cache
request slots — see ``launch/scheduler.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --continuous --requests 8 --max-batch 3 --max-seq 32 \\
        --expect-completions 8 --device cpu

``--reduced`` is on and cannot be turned off, as in the reference (a
``store_true`` flag whose default is True).  The reference's exec-store,
routing, host-MoE, plan-store and mesh flags are not offered.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, reduced_config
from ..device import resolve_device
from ..kernels import ops as kops
from ..models import model as M


def print_kernel_launches() -> None:
    """The hand-written kernels this process launched (0 on the CPU, where
    their plain versions run)."""
    print(f"[serve] kernel launches: flash_attention="
          f"{kops.flash_attention.launches} rwkv6={kops.rwkv6.launches}")


def generate(cfg, params, tokens, *, gen: int, max_seq: int,
             temperature: float = 0.0, seed: int = 0, device="cuda"):
    """Greedy / temperature sampling. tokens: (B, prompt_len) int.

    Prefills the prompt, then decodes ``gen - 1`` steps (the first token
    comes from the prefill logits).  Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed`` (other numbers than JAX's).
    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; raises
    without a card.  Returns ``(tokens (B, prompt_len + gen), per-step
    decode latencies in seconds)``.
    """
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder serving is not ported yet "
                                  "(ROADMAP queue 1 item 10)")
    dev = resolve_device(device)
    params = M.compute_params(cfg, params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    b, prompt_len = tokens.shape
    cache = M.init_cache(cfg, b, max_seq, device=dev)
    logits, cache = M.prefill(cfg, params, tokens, cache)
    step_logits = logits[:, -1]
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(seed)
    out, lat = [tokens], []
    for i in range(gen):
        if i:
            t0 = time.perf_counter()
            step_logits, cache = M.decode_step(
                cfg, params, cache, cur, prompt_len + i - 1)
            step_logits = step_logits[:, -1]
            if dev.type == "cuda":
                # deliberate timed drain: the latency of one decode step
                torch.cuda.synchronize(dev)
            lat.append(time.perf_counter() - t0)
        if temperature > 0:
            probs = torch.softmax(step_logits / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=gen_rng)
        else:
            cur = torch.argmax(step_logits, dim=-1)[:, None]
        cur = cur.to(torch.int32)
        out.append(cur)
    return torch.cat(out, dim=1), lat


def serve_continuous(cfg, args):
    """Trace-driven continuous-batching serve (the scheduler front end)."""
    from .scheduler import ServeScheduler, synthetic_trace
    params = M.init_params(cfg, args.seed, device=args.device)
    trace = synthetic_trace(args.requests, seed=args.seed,
                            vocab=cfg.vocab_size)
    streamed = [0]

    def on_token(rid, token, step):
        streamed[0] += 1

    sch = ServeScheduler(cfg, params, max_batch=args.max_batch,
                         max_seq=args.max_seq,
                         token_budget=args.token_budget, on_token=on_token,
                         device=args.device)
    t0 = time.time()
    completions = sch.run(trace)
    total = time.time() - t0
    new_tokens = sum(len(c.tokens) for c in completions)
    print(f"[serve] continuous: {len(completions)}/{args.requests} requests"
          f" in {sch.stats['steps']} steps ({sch.stats['decode_steps']} "
          f"decode), {new_tokens} tokens in {total:.2f}s "
          f"({new_tokens / total:.1f} tok/s), {streamed[0]} streamed")
    lat = sch.latency_summary()
    print(f"[serve] latency: ttft p50={lat['ttft']['p50_s'] * 1e3:.1f}ms "
          f"p99={lat['ttft']['p99_s'] * 1e3:.1f}ms "
          f"(n={lat['ttft']['n']}); decode step "
          f"p50={lat['decode_step']['p50_s'] * 1e3:.1f}ms "
          f"p99={lat['decode_step']['p99_s'] * 1e3:.1f}ms "
          f"(n={lat['decode_step']['n']})")
    occupancy = M.cache_slot_occupancy(sch.cache)
    if occupancy.any():
        raise SystemExit(f"[serve] ERROR: drained scheduler left orphaned "
                         f"KV slots: {occupancy.tolist()}")
    if args.expect_completions is not None:
        if len(completions) != args.expect_completions or streamed[0] == 0:
            raise SystemExit(
                f"[serve] ERROR: expected {args.expect_completions} "
                f"completions with streamed tokens, got "
                f"{len(completions)} / {streamed[0]} streamed")
        print(f"[serve] smoke OK: {args.expect_completions} completions, "
              f"{streamed[0]} streamed tokens, no orphaned slots")
    print_kernel_launches()
    return completions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="tiny same-family config (always on, as in the "
                         "reference)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="serve a synthetic request trace through the "
                         "continuous-batching scheduler instead of one "
                         "fixed batch (per-request prompt/gen lengths, "
                         "KV-cache slot reuse, per-step streaming)")
    ap.add_argument("--requests", type=int, default=16,
                    help="[--continuous] trace length")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="[--continuous] decode slots (KV-cache rows)")
    ap.add_argument("--max-seq", type=int, default=64,
                    help="[--continuous] per-slot cache length")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="[--continuous] admission budget in resident "
                         "tokens (prompt+gen per in-flight request)")
    ap.add_argument("--expect-completions", type=int, default=None,
                    help="[--continuous] exit nonzero unless exactly this "
                         "many requests complete with streamed output "
                         "(CI smoke gate)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.continuous:
        return serve_continuous(cfg, args)
    params = M.init_params(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    max_seq = args.prompt_len + args.gen + 1
    t0 = time.time()
    seqs, lat = generate(cfg, params, tokens, gen=args.gen, max_seq=max_seq,
                         temperature=args.temperature, seed=args.seed,
                         device=args.device)
    total = time.time() - t0
    print(f"[serve] {args.batch} seqs × {args.gen} new tokens in "
          f"{total:.2f}s ({args.batch * args.gen / total:.1f} tok/s)")
    if lat:
        print(f"[serve] decode latency p50={np.median(lat) * 1e3:.1f}ms "
              f"p99={np.percentile(lat, 99) * 1e3:.1f}ms")
    print("[serve] first sequence:", seqs[0].cpu().numpy()[:16], "...")
    print_kernel_launches()
    return seqs


if __name__ == "__main__":
    main()

"""Serving driver: one-shot batch generation or a continuous-batching loop.

Port of ``repro.launch.serve`` for every architecture of ``configs``
(the ``attn``, ``rwkv`` and ``hymba`` mixers; the ``swiglu``, ``moe`` and
``rwkv_cm`` FFNs; image-prefix models served on text; the
encoder-decoder, one-shot only, on frames made from the seed).  One-shot
(fixed batch, every row the same prompt length and gen):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --batch 2 --prompt-len 32 --gen 8 --device cpu

Continuous batching (trace-driven scheduler, per-request lengths, KV-cache
request slots — see ``launch/scheduler.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        --continuous --requests 8 --max-batch 3 --max-seq 32 \\
        --expect-completions 8 --device cpu

MoE architectures can route decode-step expert dispatch through the
process's ReapRuntime (``--routing host``, or its legacy alias
``--host-moe``): each decode step hands its routing pattern to the
registered ``moe_dispatch`` op, so repeated per-token routings hit warm
bundling plans and — with ``--plan-store DIR`` — a restarted server reuses
the plans a previous process inspected.  ``--routing auto`` follows each
op's declared routing (``moe_dispatch`` declares ``in_graph``).

``--reduced`` is on and cannot be turned off, as in the reference (a
``store_true`` flag whose default is True).  The runtime flags come from
``repro_torch.runtime.add_runtime_args``; ``--exec-store`` and
``--mesh-shape`` raise until their slices are ported, and the reference's
``--prewarm`` and ``--expect-zero-compiles`` (executable store) are not
offered.
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
          f"{kops.flash_attention.launches} rwkv6={kops.rwkv6.launches} "
          f"moe_gemm={kops.moe_gemm.launches}")


def _store_op_report(rt) -> str:
    """Warm-plan counts per registered op tag (registry-enumerated)."""
    from ..runtime.ops import op_tag_for_fingerprint
    counts: dict = {}
    for fp in rt.store.fingerprints():
        tag = op_tag_for_fingerprint(fp.op) or "other"
        counts[tag] = counts.get(tag, 0) + 1
    parts = [f"{tag}={n}" for tag, n in sorted(counts.items())]
    return " ".join(parts) if parts else "none"


def _resolve_routing(mode: str) -> dict:
    """Per-op serving route, decided from declared ``OpCapabilities``.

    ``auto`` takes each concrete op's own ``routing`` declaration;
    ``host``/``in_graph`` force every concrete op one way.  Routers are
    skipped — they own no execution path.
    """
    from ..runtime.ops import capability_summary, get_op, list_ops
    routes = {}
    for tag in list_ops():
        spec = get_op(tag)
        if spec.route is not None:
            continue
        declared = capability_summary(spec)["routing"]
        routes[tag] = declared if mode == "auto" else mode
    return routes


def _runtime_report(rt) -> None:
    """The plan cache's hits, store hits and misses, overall and per op."""
    cs = rt.cache_stats()
    line = (f"[serve] plan cache: {cs['hits']} hits, "
            f"{cs['store_hits']} store hits, {cs['misses']} misses")
    if rt.store is not None:
        line += (f"; store holds {cs['store']['entries']} plans "
                 f"({cs['store']['saves']} saved this run)")
    print(line)
    active = {tag: rec for tag, rec in cs["per_op"].items()
              if any(rec.values())}
    if active:
        print("[serve] per-op:", " ".join(
            f"{tag}[h={rec['hits']},s={rec['store_hits']},"
            f"m={rec['misses']},warm={rec['warm_rate']:.2f}]"
            for tag, rec in sorted(active.items())))
    elif rt.store is not None:
        print("[serve] note: no sparse op consulted the runtime this run — "
              "decode routes on the device; pass --routing host on an MoE "
              "arch to route dispatch through it")


def generate(cfg, params, tokens, *, gen: int, max_seq: int,
             temperature: float = 0.0, seed: int = 0, frames=None,
             device="cuda"):
    """Greedy / temperature sampling. tokens: (B, prompt_len) int.

    Prefills the prompt, then decodes ``gen - 1`` steps (the first token
    comes from the prefill logits).  An encoder-decoder runs
    ``encdec_prefill`` on ``frames`` (B, S_enc, d_frame) and consumes the
    prompt token by token through ``decode_step`` instead, as the reference
    does.  Temperature sampling draws from a ``torch.Generator`` seeded
    with ``seed`` (other numbers than JAX's).  ``device`` is ``"cuda"``
    unless the caller asks for ``"cpu"``; raises without a card.  Returns
    ``(tokens (B, prompt_len + gen), per-step decode latencies in
    seconds)``.
    """
    dev = resolve_device(device)
    params = M.compute_params(cfg, params, dev)
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    b, prompt_len = tokens.shape
    if cfg.enc_dec:
        frames = torch.as_tensor(frames).to(dev)
        cache = M.init_cache(cfg, b, max_seq, s_enc=frames.shape[1],
                             device=dev)
        _, cache = M.encdec_prefill(cfg, params, frames, cache)
        for i in range(prompt_len):
            logits, cache = M.decode_step(cfg, params, cache,
                                          tokens[:, i:i + 1], i)
    else:
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
    return completions


def main(argv=None):
    from ..runtime import (ReapRuntime, RuntimeConfig, add_runtime_args,
                           set_default_runtime)
    from ..models.moe import set_host_dispatch_runtime
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
    ap.add_argument("--host-moe", action="store_true",
                    help="route decode-step MoE dispatch through the "
                         "runtime's registered moe_dispatch op: only the "
                         "routing pattern leaves the device, and repeated "
                         "per-token routings hit warm bundling plans (with "
                         "--plan-store they survive restarts). Legacy alias "
                         "for --routing=host")
    ap.add_argument("--routing", choices=("auto", "host", "in_graph"),
                    default="auto",
                    help="per-op dispatch route: 'auto' follows each "
                         "registered op's declared OpCapabilities.routing, "
                         "'host'/'in_graph' force every op one way")
    add_runtime_args(ap)       # --plan-store, --device (default cuda), ...
    args = ap.parse_args(argv)
    args.device = args.device or "cuda"
    if args.host_moe and args.routing == "auto":
        args.routing = "host"            # legacy alias keeps its meaning
    resolve_device(args.device)

    rt = None
    if args.plan_store or args.exec_store or args.routing == "host":
        rt = set_default_runtime(ReapRuntime(RuntimeConfig.from_args(args)))
        if rt.store is not None:
            s = rt.store.summary()
            print(f"[serve] plan store {args.plan_store}: {s['entries']} "
                  f"warm plans ({_store_op_report(rt)}), "
                  f"{s['bytes'] / 1e6:.2f} MB on disk")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    # the route ACTS on declared capabilities: moe_dispatch is the op a
    # decode step can route on the host, so its resolved route decides
    # whether the host dispatch runtime is installed
    routes = _resolve_routing(args.routing)
    host_moe = routes.get("moe_dispatch") == "host"
    if host_moe and cfg.ffn != "moe":
        print(f"[serve] note: host routing has no effect on {args.arch} "
              "(no MoE layers)")
        host_moe = False
    if rt is not None:
        print(f"[serve] routing ({args.routing}): " + " ".join(
            f"{tag}={route}" for tag, route in sorted(routes.items())))
    if host_moe:
        set_host_dispatch_runtime(rt)
    try:
        if args.continuous:
            seqs = serve_continuous(cfg, args)
        else:
            seqs = serve_one_shot(cfg, args)
    finally:
        if host_moe:
            set_host_dispatch_runtime(None)
    if rt is not None:
        _runtime_report(rt)
    print_kernel_launches()
    return seqs


def serve_one_shot(cfg, args):
    """One fixed batch through ``generate``; an encoder-decoder's frames
    (batch, prompt_len, d_frame) come from the seed, as in the reference."""
    params = M.init_params(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.enc_dec:
        frames = torch.from_numpy(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_frame)).astype(np.float32))
    max_seq = args.prompt_len + args.gen + 1
    t0 = time.time()
    seqs, lat = generate(cfg, params, tokens, gen=args.gen, max_seq=max_seq,
                         temperature=args.temperature, seed=args.seed,
                         frames=frames, device=args.device)
    total = time.time() - t0
    print(f"[serve] {args.batch} seqs × {args.gen} new tokens in "
          f"{total:.2f}s ({args.batch * args.gen / total:.1f} tok/s)")
    if lat:
        print(f"[serve] decode latency p50={np.median(lat) * 1e3:.1f}ms "
              f"p99={np.percentile(lat, 99) * 1e3:.1f}ms")
    print("[serve] first sequence:", seqs[0].cpu().numpy()[:16], "...")
    return seqs


if __name__ == "__main__":
    main()

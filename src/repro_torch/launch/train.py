"""End-to-end training CLI.

Port of ``repro.launch.train``: deterministic resumable data, atomic
checkpoints with auto-resume from ``latest``, the straggler watchdog and
per-step metrics.  ``--device`` is ``cuda`` unless the caller asks for
``cpu``: with several cards visible, ``cuda`` trains sharded over a
``(data, model)`` mesh of all of them (``build_mesh``), as the reference
shards over every device it sees; ``cuda:<i>`` and ``cpu`` train on one
device.  ``train(cfg, args, mesh=...)`` trains on a given mesh (a device
may repeat in it: ``launch.mesh.make_mesh``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 200 --batch 8 --seq 256 --reduced --ckpt-dir runs/ckpt \\
        --device cpu

On the card, attention's forward and backward run through kernel K4
(``kernels/flash_attention.py``), the WKV scan's (rwkv6, hymba's SSM
heads) through kernel K6 (``kernels/rwkv6_scan.py``) and the MoE experts'
products (dbrx-132b, kimi-k2) through kernel K5 (``kernels/moe_gemm.py``),
each with its backward kernels; the last line counts their launches.  On
the CPU every family trains through the plain versions.  ``main`` parses
the arguments and builds the config; ``train`` runs the loop on a given
``ModelConfig``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..checkpoint import manager as ckpt
from ..configs import ARCHS, ModelConfig, get_config, reduced_config
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device
from ..kernels import flash_attention as fa
from ..kernels import moe_gemm as k5
from ..kernels import rwkv6_scan as wkv
from ..models import model as M
from ..optim import adamw
from ..parallel.sharding import shard_tree
from ..runtime.elastic import StepWatchdog
from .mesh import make_mesh
from .steps import make_train_step, train_shardings


def build_mesh(device: torch.device, model_parallel: int = 16):
    """No mesh on one device (``cpu``, ``cuda:<i>``, or ``cuda`` with one
    card).  ``cuda`` with ``n > 1`` cards visible is the reference's
    ``(n // mp, mp)`` ``("data", "model")`` mesh over them, ``mp =
    min(model_parallel, n)``."""
    n = torch.cuda.device_count() if device.type == "cuda" \
        and device.index is None else 1
    if n <= 1:
        return None
    mp = min(model_parallel, n)
    return make_mesh((n // mp, mp), ("data", "model"))


def print_kernel_launches() -> None:
    """K4's, K6's and K5's forward and backward launches in this process (0
    on the CPU, where the plain versions run)."""
    print(f"[train] kernel launches: flash_attention="
          f"{fa.flash_attention.launches} flash_attention_bwd="
          f"{fa.flash_attention_bwd.launches} rwkv6={wkv.rwkv6.launches} "
          f"rwkv6_bwd={wkv.rwkv6_bwd.launches} moe_gemm="
          f"{k5.moe_gemm.launches} moe_gemm_bwd={k5.moe_gemm_bwd.launches}",
          flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=16,
                    help="the model axis of the mesh over several cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    return train(cfg, args)


def train(cfg: ModelConfig, args: argparse.Namespace, mesh=None):
    """The training loop of ``main`` on ``cfg`` (the config ``args.arch``
    names, or any other, e.g. one with its depth cut) with the parsed
    ``args``; returns the per-step metrics.  With a ``mesh`` (given, or
    ``build_mesh``'s) the params and AdamW state are sharded on it
    (``train_shardings``), each step is the sharded step, checkpoints are
    written from the shards and a resume restores onto the mesh."""
    dev = resolve_device(args.device)
    if mesh is None:
        mesh = build_mesh(dev, args.model_parallel)
    if mesh is not None:
        dev = mesh.devices.flat[0]

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(
        10, args.steps // 20), total_steps=args.steps)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        n_image_tokens=cfg.n_image_tokens, d_image=cfg.d_image,
        d_frame=cfg.d_frame if cfg.enc_dec else 0))

    params = M.init_params(cfg, args.seed, device=dev)
    shardings = None
    if mesh is not None:
        pshard, oshard, _ = train_shardings(cfg, mesh, opt_cfg)
        shardings = {"params": pshard, "opt": oshard}
        params = shard_tree(params, pshard)
    opt_state = adamw.init(opt_cfg, params)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, manifest = ckpt.restore(args.ckpt_dir,
                                       {"params": params, "opt": opt_state},
                                       shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        start_step = manifest["step"]
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, mesh)
    watchdog = StepWatchdog()
    history = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.get_batch(step).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        ev = watchdog.observe(step, dt)
        if ev is not None:
            print(f"[watchdog] straggler step {step}: {dt:.2f}s "
                  f"(median {ev.median:.2f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss={metrics['loss']:.4f} "
                  f"ce={metrics['ce']:.4f} gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} dt={dt:.2f}s", flush=True)
        history.append({"step": step, **metrics, "dt": dt})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state},
                      extras={"arch": args.arch, "reduced": args.reduced})
    total = time.time() - t_start
    if history:
        print(f"[train] done: {args.steps - start_step} steps in "
              f"{total:.1f}s; loss {history[0]['loss']:.4f} → "
              f"{history[-1]['loss']:.4f}")
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state},
                  extras={"arch": args.arch, "reduced": args.reduced})
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    print_kernel_launches()
    return history


if __name__ == "__main__":
    main()

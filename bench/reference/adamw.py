"""Plain AdamW with clipping by the global norm and a cosine schedule, in
float32: the optimizer the port's training step runs (linear warm-up, then
cosine decay to a tenth of the rate; m and v in float32; decoupled weight
decay on every leaf).  Imports nothing of the program."""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    lr: float
    warmup_steps: int
    total_steps: int
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def rate(cfg: Config, step: int) -> float:
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = min(max(prog, 0.0), 1.0)
    return cfg.lr * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi
                                                               * prog)))


def init(params: List[torch.Tensor]) -> dict:
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params]}


def update(cfg: Config, step: int, params: List[torch.Tensor],
           grads: List[torch.Tensor], state: dict) -> float:
    """One step (``step`` from 1) in place; returns the clipping scale."""
    with torch.no_grad():
        gnorm = math.sqrt(sum(float(torch.sum(g.float() * g.float()))
                              for g in grads))
        scale = min(cfg.clip_norm / (gnorm + 1e-9), 1.0)
        lr = rate(cfg, step)
        b1c, b2c = 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * p
            p.sub_(lr * delta)
    return scale

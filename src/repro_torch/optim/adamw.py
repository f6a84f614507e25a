"""AdamW + global-norm clipping + cosine schedule (self-contained).

Port of ``repro.optim.adamw``.  The optimizer state's dtype is configurable
(``state_dtype``, a torch dtype; bfloat16 m/v for the largest configs), and
the state lives on the params' device.  ``update`` changes the params and
the m/v tensors in place under ``torch.no_grad()``, the counterpart of the
reference's ``donate_argnums``: one step needs no second copy of the
training state.  Its arithmetic is the reference's, op for op in float32:
the learning rate and the bias corrections from the int32 step counter,
clipping by the global norm, then each leaf's moments and decoupled weight
decay.  A leaf of more than ``SLICE_ELEMENTS`` elements is updated in
slices of its flattened storage (its leading dimensions first), so the
update's float32 temporaries stay a few slices' size whatever the leaf's
(one dbrx-132b expert stack is 1.06 B elements, 4.2 GB a float32 copy);
the arithmetic is elementwise, so the result is bit-equal to the whole-leaf
update.  A leaf held as shards on a mesh (``parallel.sharding.
ShardedTensor``) has its state sharded alike, and each shard is updated
on its own device.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, Dict

import numpy as np
import torch

from ..models.params import _walk, tree_map
from ..parallel.sharding import ShardedTensor, pieces


#: leaves above this many elements are updated slice by slice (256 MB of
#: float32 a temporary)
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: Any = torch.float32


@functools.lru_cache(maxsize=None)
def _cosf():
    """The C library's float32 cosine, which XLA's CPU backend calls for a
    float32 ``cos``: the schedule's cosine then equals the reference's bit
    for bit (torch's and numpy's float32 cosines can be an ulp away, and
    near the schedule's end ``0.1 + 0.9 cos`` magnifies that)."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to a tenth of ``lr``: a float32
    host scalar from the int32 ``step``, each operation the reference's in
    float32."""
    step = np.int32(int(step))
    f32 = np.float32
    warm = min(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = f32(np.int32(step - cfg.warmup_steps)) \
        / f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = min(max(prog, f32(0.0)), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + f32(_cosf()(f32(np.pi) * prog)))
    return torch.tensor(f32(cfg.lr) * warm * (f32(0.1) + f32(0.9) * cos))


def init(cfg: AdamWConfig, params) -> Dict:
    """Zero m and v in ``state_dtype`` beside each leaf, and the int32 step
    counter, which stays on the host: the schedule and the bias
    corrections are host scalars, so a step reads nothing back from the
    card."""
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.map(zeros)
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves taken in
    sorted key order as ``jax.tree.leaves`` takes them (a sharded leaf's
    shards in index order), summed on the first leaf's device."""
    sq = [torch.sum(torch.square(s.float()))
          for _, g in _walk(tree) for s in pieces(g)]
    return torch.sqrt(sum(s.to(sq[0].device) for s in sq))


def _update_leaf(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c: float,
                 b2c: float) -> None:
    """One leaf's (or slice's) moments, then its param, in place."""
    g32 = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
    del g32
    mhat = m32 / b1c
    vhat = v32 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
        + cfg.weight_decay * p.float()
    del mhat, vhat
    p.copy_(p.float() - float(lr) * delta)
    m.copy_(m32)
    v.copy_(v32)


def _slices(p, g, m, v):
    """``(g, m, v, p)`` as they are, or, for a leaf above
    ``SLICE_ELEMENTS`` elements whose param and moments are contiguous,
    views of slices of that many elements of each one's flattened
    storage."""
    n, size = p.numel(), SLICE_ELEMENTS
    if n <= size or not all(t.is_contiguous() for t in (p, m, v)):
        yield g, m, v, p
        return
    flat = [g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)]
    for i in range(0, n, size):
        yield tuple(t[i:i + size] for t in flat)


def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step.  Returns ``(params, state, metrics)``: the same
    param and m/v tensors, changed in place, a new step counter, and
    ``{"grad_norm", "lr"}`` as float32 tensors (the norm before clipping,
    on the first grad's device; the rate on the host)."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = schedule(cfg, step)
        f32 = np.float32
        b1c = float(f32(1.0) - f32(cfg.b1) ** f32(step))
        b2c = float(f32(1.0) - f32(cfg.b2) ** f32(step))
        grad_of = dict(_walk(grads))
        m_of, v_of = dict(_walk(state["m"])), dict(_walk(state["v"]))
        for path, leaf in _walk(params):
            for p, g, m, v in zip(*map(pieces, (leaf, grad_of[path],
                                                m_of[path], v_of[path]))):
                for piece in _slices(p, g, m, v):
                    _update_leaf(cfg, *piece, scale.to(p.device), lr, b1c,
                                 b2c)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics

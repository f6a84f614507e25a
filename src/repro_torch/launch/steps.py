"""Training step functions and the abstract training state.

Port of the training half of ``repro.launch.steps``.  The reference jits
its step with ``donate_argnums``; here the step runs eagerly and AdamW
updates the params and its state in place (``optim.adamw.update``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs import ModelConfig
from ..models import model as M
from ..models.params import _set, _walk
from ..optim import adamw


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: the loss and the gradient of every param leaf by autograd,
    then one AdamW update.  ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as float32 scalar tensors.  A leaf the loss
    does not reach gets a zero gradient, as ``jax.grad`` gives it.

    Sharded training (a ``mesh``) waits for a later slice and raises.
    """
    if mesh is not None:
        raise NotImplementedError("sharded training over a mesh is not "
                                  "ported yet; train on one device")

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = list(_walk(params))
        for _, p in leaves:
            p.requires_grad_(True)
        loss, parts = M.loss_fn(cfg, params, batch)
        grads_flat = torch.autograd.grad(
            loss, [p for _, p in leaves], allow_unused=True,
            materialize_grads=True)
        grads: Dict = {}
        for (path, _), g in zip(leaves, grads_flat):
            _set(grads, path, g)
        del grads_flat
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), **om}
        return params, opt_state, metrics
    return train_step


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``(params, opt_state)`` of ``cfg`` with no storage: the param tree
    and AdamW's m and v as ``meta`` tensors (the step counter is a host
    scalar)."""
    params = M.abstract_params(cfg)
    return params, adamw.init(opt_cfg, params)

"""Training step functions, their shardings and the abstract training state.

Port of the training half of ``repro.launch.steps``.  The reference jits
its step with ``donate_argnums``; here the step runs eagerly and AdamW
updates the params and its state in place (``optim.adamw.update``).

With a mesh the reference's one program is sharded by XLA.  Here one
process drives every device of the ``DeviceMesh`` (single-controller, as
the reference's): the params and AdamW's m and v are sharded storage
(``parallel.sharding``), the batch splits over its data-parallel axes, and
each data shard gathers the params onto its device, takes its loss and
gradients there, and the gradients are reduced into the storage shards.
The model axis shards storage, not computation: the port has no
tensor-parallel layers.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..configs import ModelConfig
from ..models import model as M
from ..models.params import _set, _walk
from ..optim import adamw
from ..parallel import sharding as S
from ..parallel.api import use_mesh


def _loss_and_grads(cfg: ModelConfig, leaves: List, batch):
    """``(loss, parts, grads)``: ``M.loss_fn`` on the tree of ``leaves``
    (``(path, tensor)`` pairs, each made to require its gradient) and the
    gradient of every leaf by autograd.  A leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    tree: Dict = {}
    for path, p in leaves:
        _set(tree, path, p.requires_grad_(True))
    loss, parts = M.loss_fn(cfg, tree, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def batch_shards(mesh, batch: Dict[str, torch.Tensor]) -> list:
    """``[(device, batch slice)]``: the batch split along its leading dim
    over the axes ``batch_spec`` gives it, into equal slices, each on the
    device of its shard (one slice on the mesh's first device where the
    batch does not divide)."""
    n_rows = next(iter(batch.values())).shape[0]
    sharding = S.Sharding(mesh, S.batch_spec(mesh, n_rows, 0))
    devices = list(sharding.placement(1).values())
    size = n_rows // len(devices)
    return [(dev, {k: v[i * size:(i + 1) * size].to(dev)
                   for k, v in batch.items()})
            for i, dev in enumerate(devices)]


def _accumulate(acc, g: torch.Tensor, p):
    """``acc`` (None for the first data shard) plus the gradient ``g`` of
    the whole leaf ``p``, each storage shard's slice added on its device."""
    if isinstance(p, S.ShardedTensor):
        if acc is None:
            return S.ShardedTensor(p.sharding, p.shape, {
                idx: g[p.slices(idx)].to(s.device, copy=True)
                for idx, s in p.shards.items()})
        for idx, a in acc.shards.items():
            a.add_(g[p.slices(idx)].to(a.device))
        return acc
    if acc is None:
        return g.to(p.device)
    return acc.add_(g.to(acc.device))


def _sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh):
    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = list(_walk(params))
        shards = batch_shards(mesh, batch)
        acc: list = [None] * len(leaves)
        metrics: Dict[str, list] = {"loss": [], "ce": [], "aux": []}
        with use_mesh(mesh):
            for dev, part in shards:
                whole = [(path, S.gather(p, dev).detach())
                         for path, p in leaves]
                loss, parts, grads = _loss_and_grads(cfg, whole, part)
                del whole
                for i, ((_, p), g) in enumerate(zip(leaves, grads)):
                    acc[i] = _accumulate(acc[i], g, p)
                del grads
                for k, v in (("loss", loss), *parts.items()):
                    metrics[k].append(v)
        n = len(shards)
        grads_tree: Dict = {}
        for (path, _), a in zip(leaves, acc):
            for piece in S.pieces(a):
                piece.div_(n)
            _set(grads_tree, path, a)
        del acc
        params, opt_state, om = adamw.update(opt_cfg, grads_tree, opt_state,
                                             params)
        first = shards[0][0]
        metrics = {k: sum(x.to(first) for x in v) / n
                   for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om}
    return train_step


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: the loss and the gradient of every param leaf by autograd,
    then one AdamW update.  ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as float32 scalar tensors.

    With a ``mesh`` the params and m/v arrive as sharded storage
    (``train_shardings``, ``parallel.sharding.shard_tree``) and the batch is
    split over the data-parallel axes (``batch_shards``).  Data shard ``k``,
    in order, gathers every leaf onto its device, runs ``loss_fn`` on its
    slice and takes the gradients; each storage shard gets its slice of
    them summed in shard order on its own device, and, after the last
    shard, divided by the number of shards.  A shard's gathered params and
    gradients are freed before the next starts.  The loss, ``ce`` and
    ``aux`` are the means of the shards' (exact for equal shards: both are
    means over rows).  Nothing reads a device value on the host, so shards
    on distinct cards overlap.
    """
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, mesh)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = list(_walk(params))
        loss, parts, grads_flat = _loss_and_grads(cfg, leaves, batch)
        grads: Dict = {}
        for (path, _), g in zip(leaves, grads_flat):
            _set(grads, path, g)
        del grads_flat
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, {"loss": loss, "ce": parts["ce"],
                                   "aux": parts["aux"], **om}
    return train_step


def train_shardings(cfg: ModelConfig, mesh, opt_cfg: adamw.AdamWConfig):
    """``(param shardings, opt-state shardings, batch_shardings)``, as the
    reference's.  AdamW's step counter stays on the host (``None``: it is
    not placed)."""
    pshard = S.params_shardings(cfg, mesh)
    opt_shard = {"m": pshard, "v": pshard, "step": None}

    def batch_shardings(specs):
        return {k: S.Sharding(mesh, S.batch_spec(mesh, v.shape[0],
                                                 v.ndim - 1))
                for k, v in specs.items()}
    return pshard, opt_shard, batch_shardings


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``(params, opt_state)`` of ``cfg`` with no storage: the param tree
    and AdamW's m and v as ``meta`` tensors (the step counter is a host
    scalar)."""
    params = M.abstract_params(cfg)
    return params, adamw.init(opt_cfg, params)

"""Pipeline parallelism: GPipe-style microbatched stage execution.

Port of ``repro.parallel.pipeline``.  Stages lie along the ``pipe`` mesh
axis: stage ``s``'s params go to the device of pipe index ``s`` (the first
mesh position holding it), and microbatches flow stage → stage over
``n_micro + n_stage − 1`` ticks (fill, steady state, drain).  At tick ``t``
stage 0 injects microbatch ``t``, stage ``s`` runs what stage ``s − 1``
handed it at tick ``t − 1`` (the reference's ``ppermute`` becomes a copy to
the next stage's device), and the last stage records its output as
microbatch ``t − n_stage + 1``.  The reference also runs every stage in
the fill and drain ticks on values that reach no recorded output; those
runs are skipped here.  Autograd flows through the copies, so the same
wrapper trains.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.params import tree_map


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, *, mesh,
                   axis: str = "pipe"):
    """Run ``n_micro`` microbatches through ``n_stage`` pipeline stages.

    stage_fn(params_slice, x) → x          (one stage's computation)
    stage_params: dict tree with leading dim n_stage
    x_micro:      (n_micro, micro_batch, ...) inputs
    Returns (n_micro, micro_batch, ...) outputs (from the last stage, on
    its device).
    """
    from .sharding import Sharding

    n_stage = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    n_micro = x_micro.shape[0]
    devices = list(Sharding(mesh, (axis,)).placement(1).values())
    params = [tree_map(lambda p: p[s].to(devices[s]), stage_params)
              for s in range(n_stage)]
    held = [None] * n_stage            # what each stage runs next tick
    outs = [None] * n_micro
    for t in range(n_micro + n_stage - 1):
        nxt = [None] * n_stage
        for s in range(n_stage):
            mb = t - s                 # the microbatch at stage s
            if not 0 <= mb < n_micro:
                continue
            cur = x_micro[mb].to(devices[0]) if s == 0 else held[s]
            y = stage_fn(params[s], cur)
            if s == n_stage - 1:
                outs[mb] = y
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        held = nxt
    return torch.stack(outs)

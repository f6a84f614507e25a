"""Device meshes for sharded execution.

Port of ``repro.launch.mesh.make_mesh``.  The reference is single-controller:
one process runs ``shard_map`` over a ``jax`` mesh.  The port keeps that
shape: a ``DeviceMesh`` is a grid of ``torch.device`` with named axes, and
the sharded executors (``runtime/shard.py``) put each shard's operands on
its device from the one process — no process group is involved.

A device may repeat.  That is how one host gets several shards (the CPU
tests' ``["cpu"] * 8``, as the reference's tests force 8 host devices) and
how one card runs a 4-shard mesh (``["cuda:0"] * 4``).  The reference's
256-chip ``make_production_mesh`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A grid of devices with one name per axis.

    ``devices`` is an object array of ``torch.device`` whose shape is the
    mesh's; ``axis_names`` and ``devices.shape`` are read as a jax mesh's
    are (``parallel.sharding.axis_size``).
    """

    devices: np.ndarray
    axis_names: Tuple[str, ...]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes``.

    With no ``devices`` it takes the first ``prod(shape)`` CUDA cards and
    raises if there are fewer.  An explicit list (names or
    ``torch.device``) must hold exactly ``prod(shape)`` entries and may
    repeat a device; a ``cuda`` entry on a machine without a card raises.
    """
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"mesh {shape} needs {n} CUDA devices, {have} available; "
                "pass devices= (a device may repeat) to place several "
                "shards on one device")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"mesh {shape} needs {n} devices, got {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(shape), axes)

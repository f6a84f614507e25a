"""Mesh-axis helpers: which axes are data-parallel and how large they are.

Port of the axis helpers of ``repro.parallel.sharding`` (``dp_axes``,
``axis_size``, ``guarded``).  They read any object with ``axis_names`` and
``devices.shape``: a ``launch.mesh.DeviceMesh``.  The reference's logical-axis
rules for parameters and caches belong to training and sharded serving,
which the port does not have.
"""
from __future__ import annotations

from typing import Optional


def dp_axes(mesh):
    """The data-parallel axes tuple for this mesh (includes pod if present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, names) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    total = 1
    for n in names:
        total *= sizes.get(n, 1)
    return total


def guarded(mesh, dim: int, names) -> Optional[object]:
    """Return ``names`` if ``dim`` divides their product, else None."""
    if names is None:
        return None
    if dim % axis_size(mesh, names) != 0:
        return None
    return names

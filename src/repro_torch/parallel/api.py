"""Sharding-constraint API usable from model code.

Port of ``repro.parallel.api``.  Model code calls ``constrain(x, "dp",
None, "model")`` with *logical* axis names.  With a mesh active (set by the
step builders with ``use_mesh``) the reference turns that into a guarded
``with_sharding_constraint``; with none it is a no-op.  Here nothing lays
activations out: the step builders place them.  Each data shard computes
on its own device, and in the serving steps of the tensor-parallel
families (``tensor_parallel.tp_route``: attention with a SwiGLU or an MoE
FFN, RWKV6) each model position on its slice (an MoE FFN on its experts,
as the reference's ``("dp", "experts", None, None)`` constraints lay the
bundles out), the logits returned over ``resolve_spec(shape, ("dp", None,
"vocab"), mesh)``; hymba, whisper and training compute over the data axes
only.  So ``constrain``
resolves and guards the spec exactly as the reference does
(``resolve_spec``) and returns ``x`` as it is.  Guards drop any axis whose
dim does not divide the mesh axes, and axes under manual control (the
compressed step's ``pod``, the reference's ``shard_map`` axis) are dropped
too.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

_MESH: contextvars.ContextVar[Optional[object]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_MANUAL: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "repro_torch_manual_axes", default=frozenset())


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)


@contextlib.contextmanager
def manual_axes(*names: str):
    """Mark ``names`` as under manual control, as the reference's
    ``shard_map`` over them does: constraints leave them out."""
    tok = _MANUAL.set(frozenset(names))
    try:
        yield
    finally:
        _MANUAL.reset(tok)


def current_mesh():
    return _MESH.get()


def _resolve(mesh, name):
    """logical name → physical axis/axes."""
    if name is None:
        return None
    if name == "dp":
        return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    from .sharding import LOGICAL_RULES
    if name in LOGICAL_RULES:
        return LOGICAL_RULES[name]
    if name in mesh.axis_names:
        return name
    return None


def resolve_spec(shape, names, mesh) -> Tuple:
    """The spec ``constrain`` resolves for an array of ``shape`` under
    ``mesh``: each logical name resolved, manual axes dropped, a one-axis
    tuple reduced to its name, and an axis whose dim it does not divide
    dropped."""
    from .sharding import axis_size
    manual = _MANUAL.get()
    axes = []
    for dim, name in zip(shape, names):
        phys = _resolve(mesh, name)
        if phys is not None:
            tup = phys if isinstance(phys, tuple) else (phys,)
            tup = tuple(a for a in tup if a not in manual)
            phys = tup if len(tup) > 1 else (tup[0] if tup else None)
        if phys is not None and dim % axis_size(mesh, phys) != 0:
            phys = None
        axes.append(phys)
    return tuple(axes)


def constrain(x, *names):
    """``x`` as it is; under a mesh its guarded spec is resolved (and a
    name list of the wrong rank is ignored, as the reference ignores it).
    The step that owns ``x`` places it: the tensor-parallel serving steps
    return the logits over the spec this resolves for the reference's
    ``constrain(logits, "dp", None, "vocab")``; elsewhere ``x`` stays on
    the device that computed it."""
    mesh = _MESH.get()
    if mesh is None or x.ndim != len(names):
        return x
    resolve_spec(x.shape, names, mesh)
    return x

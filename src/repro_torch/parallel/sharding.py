"""Sharding: logical-axis rules → shardings over (pod, data, model), and the
sharded storage that holds a tree on a mesh.

Port of ``repro.parallel.sharding``.  The helpers read any object with
``axis_names`` and ``devices.shape``: a ``launch.mesh.DeviceMesh``.

Posture (the reference's):
  * batch  → (pod, data)  pure DP across pods, DP within a pod
  * params → FSDP over ``data`` on the "embed" rows, TP over ``model``
             ("heads"/"mlp"/"vocab"/"experts")
Every rule is divisibility-guarded: a dim that does not divide its mesh
axes is replicated.

A spec is a tuple with one entry a dim: ``None``, an axis name or a tuple
of names (the entries of the reference's ``PartitionSpec``), and
``Sharding(mesh, spec)`` stands for its ``NamedSharding``.  There is no
compiler to lay arrays out, so a sharded leaf is stored as its shards
(``ShardedTensor``): one tensor for each distinct shard index, on the first
device (in the mesh's row-major order) of the positions that share it, as
``runtime.shard.shard_devices`` places replicas.  A leaf whose spec is all
``None`` stays one tensor, on the mesh's first device.  ``shard_tree``,
``gather`` and ``unshard_tree`` move between the two; ``model_slice``
assembles one tensor-parallel shard of a leaf (the sharded serving and
training steps of ``launch.steps``) and ``add_model_slice`` adds its
gradient into a storage-shaped accumulator (its transpose; ``CopyGrads``
sums a model-replicated leaf's copies first); ``GatherCount`` the bytes
each position assembled.
A leaf replicated
over an axis whose copies differ (the compressed step's error buffers) is
held as its copies (``Replicas``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# logical → physical mesh axis (None = replicate)
LOGICAL_RULES = {
    "vocab": "model",
    "heads": "model",
    "mlp": "model",
    "experts": "model",
    "embed": "data",        # FSDP (ZeRO-3 style)
    "embed2": None,
    "layers": None,         # stacked dim — never sharded
}


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


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Tuple:
    """(B, ...) activations: batch over DP axes if divisible.  A one-axis
    tuple is given as its name, as the reference's ``PartitionSpec``
    stores it."""
    axes = dp_axes(mesh)
    if batch % axis_size(mesh, axes) != 0:
        # try within-pod data only, then give up
        axes = ("data",)
        if batch % axis_size(mesh, axes) != 0:
            axes = None
    return (_named(axes), *([None] * extra_dims))


def _named(axes):
    """A one-axis tuple as its name, as the reference's ``PartitionSpec``
    stores it; anything else as it is."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def shard_act(mesh, x, *names):
    """The reference's guarded sharding constraint: the spec is checked
    against ``x`` and ``x`` is returned as it is (each data shard computes
    on its own device; nothing lays activations out)."""
    _check_spec(x.shape, tuple(guarded(mesh, d, n)
                               for d, n in zip(x.shape, names)), mesh)
    return x


def params_pspecs(cfg, mesh):
    from ..models.model import lm_metas
    from ..models.params import param_pspecs
    return param_pspecs(lm_metas(cfg), LOGICAL_RULES, mesh)


def params_shardings(cfg, mesh):
    from ..models.params import tree_map
    return tree_map(lambda s: Sharding(mesh, s), params_pspecs(cfg, mesh))


# ---------------------------------------------------------------------------
# Cache sharding (serving): SP over the cache sequence dim for batch-1 cells
# ---------------------------------------------------------------------------

def cache_pspec_fn(cfg, mesh, batch: int):
    """Returns a fn mapping each cache leaf (its path, the leaf) to a spec.

    Leaf kinds, as the reference's:
      k/v:       (L?, B, Hkv, S, D) → batch over DP if divisible, else
                 S over data (sequence parallelism for global_batch=1)
      slot_pos:  (B, S) batch over DP if divisible, else replicated
      wkv/ssm:   (L?, B, H, K, V)   → batch over DP else heads over model
      shift*:    (L?, B, d)         → batch over DP

    The reference's suffix test for K/V (``"k"``, ``"v"``, ``"xk"``,
    ``"xv"``) also matches rwkv's ``wkv``, so an rwkv state takes the K/V
    rule (at batch 1 its K dim over ``data``); kept bit for bit.
    """
    dp = _named(dp_axes(mesh))
    batch_ok = batch % axis_size(mesh, dp) == 0

    def spec_for(path: str, leaf) -> Tuple:
        ndim = leaf.ndim
        stacked = ndim >= 1 and "layers" in path
        lead = (None,) if stacked else ()
        n = ndim - len(lead)
        if path.endswith("slot_pos"):
            if batch_ok and n == 2 and leaf.shape[len(lead)] == batch:
                return (*lead, dp, None)
            return (*lead, *([None] * n))
        if path.endswith(("k", "v", "xk", "xv")) and n == 4:
            b, hkv, s, d = leaf.shape[-4:]
            if batch_ok:
                return (*lead, dp, guarded(mesh, hkv, "model"), None, None)
            return (*lead, None, guarded(mesh, hkv, "model"),
                    guarded(mesh, s, "data"), None)
        if path.endswith(("wkv", "ssm_state")) and n == 4:
            b, h, k, v = leaf.shape[-4:]
            if batch_ok:
                return (*lead, dp, guarded(mesh, h, "model"), None, None)
            return (*lead, None, guarded(mesh, h, "model"), None, None)
        if n >= 1:
            b = leaf.shape[len(lead)]
            if batch_ok and b == batch:
                return (*lead, dp, *([None] * (n - 1)))
        return tuple([None] * ndim)
    return spec_for


def cache_shardings(cfg, mesh, cache_tree, batch: int):
    """The cache tree's shardings: each leaf's ``cache_pspec_fn`` spec by
    its path (its dict keys joined by ``/``, as the reference builds it)."""
    spec_for = cache_pspec_fn(cfg, mesh, batch)

    def walk(tree, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else Sharding(mesh, spec_for("/".join(prefix + (k,)), v))
                for k, v in tree.items()}
    return walk(cache_tree, ())


# ---------------------------------------------------------------------------
# Sharded storage
# ---------------------------------------------------------------------------

def _check_spec(shape, spec, mesh) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    for dim, names in zip(shape, spec):
        if dim % axis_size(mesh, names) != 0:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over mesh axes {names}")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec (a tuple): the reference's ``NamedSharding(mesh,
    P(*spec))``.  Two shardings are equal when their mesh is the same
    object and their specs are equal."""

    mesh: object
    spec: Tuple

    def grid(self, ndim: int) -> Tuple[int, ...]:
        """Shards along each of ``ndim`` dims."""
        spec = self.spec + (None,) * (ndim - len(self.spec))
        return tuple(axis_size(self.mesh, names) for names in spec)

    def positions(self, ndim: int) -> Dict[Tuple[int, ...], Tuple[int, ...]]:
        """Shard index → the first mesh position (row-major) that holds
        it, in index order.  The index along a dim sharded over axes
        ``(a, b)`` is ``pos[a] · size[b] + pos[b]``, the reference's
        order."""
        mesh = self.mesh
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        spec = self.spec + (None,) * (ndim - len(self.spec))
        out: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        for pos in np.ndindex(*mesh.devices.shape):
            at = dict(zip(mesh.axis_names, pos))
            idx = []
            for names in spec:
                names = () if names is None else (
                    (names,) if isinstance(names, str) else names)
                i = 0
                for n in names:
                    i = i * sizes.get(n, 1) + at.get(n, 0)
                idx.append(i)
            out.setdefault(tuple(idx), pos)
        return dict(sorted(out.items()))

    def placement(self, ndim: int) -> Dict[Tuple[int, ...], torch.device]:
        """Shard index → device, in index order: each index on the device
        at its first mesh position (``positions``)."""
        return {idx: self.mesh.devices[pos]
                for idx, pos in self.positions(ndim).items()}


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """One leaf held as its shards: ``shards`` maps each shard index (one
    entry a dim) to its tensor, in index order, on the device
    ``sharding.placement`` gives it.  ``shape`` and ``dtype`` are the whole
    leaf's."""

    sharding: Sharding
    shape: torch.Size
    shards: Dict[Tuple[int, ...], torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def slices(self, idx) -> Tuple[slice, ...]:
        """The slice of the whole leaf that shard ``idx`` holds."""
        out = []
        for i, n, dim in zip(idx, self.sharding.grid(self.ndim), self.shape):
            size = dim // n
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def map(self, fn) -> "ShardedTensor":
        """``fn`` applied to every shard, as a leaf of the same sharding."""
        return ShardedTensor(self.sharding, self.shape,
                             {idx: fn(s) for idx, s in self.shards.items()})


@dataclasses.dataclass(eq=False)
class Replicas:
    """One leaf replicated over the mesh axis ``axis`` whose copies may
    differ: ``copies[i]`` is the copy of the devices at index ``i`` of
    ``axis``, on the first of them (``Sharding(mesh, (axis,))``'s
    placement).  Read whole (``gather``) it is copy 0, as a JAX array
    declared replicated whose devices hold different values reads as its
    first device's copy."""

    mesh: object
    axis: str
    copies: list


def shard(t: torch.Tensor, sharding: Sharding):
    """``t`` on ``sharding``'s mesh: a ``ShardedTensor`` of copies of its
    slices, or, for an all-``None`` spec, ``t`` on the mesh's first
    device."""
    _check_spec(t.shape, sharding.spec, sharding.mesh)
    if all(names is None for names in sharding.spec):
        return t.to(sharding.mesh.devices.flat[0])
    out = ShardedTensor(sharding, t.shape, {})
    for idx, dev in sharding.placement(t.ndim).items():
        out.shards[idx] = t[out.slices(idx)].to(
            dev, memory_format=torch.contiguous_format, copy=True)
    return out


def empty(shape, dtype, sharding: Sharding):
    """An uninitialised leaf of ``shape`` stored as ``sharding`` gives:
    each shard on its device, or, for an all-``None`` spec, one tensor on
    the mesh's first device."""
    _check_spec(shape, sharding.spec, sharding.mesh)
    if all(names is None for names in sharding.spec):
        return torch.empty(shape, dtype=dtype,
                           device=sharding.mesh.devices.flat[0])
    out = ShardedTensor(sharding, torch.Size(shape), {})
    for idx, dev in sharding.placement(len(shape)).items():
        size = [s_.stop - s_.start for s_ in out.slices(idx)]
        out.shards[idx] = torch.empty(size, dtype=dtype, device=dev)
    return out


def gather(leaf, device) -> torch.Tensor:
    """The whole leaf on ``device``: a ``ShardedTensor``'s shards
    concatenated along its sharded dims, ``Replicas``' first copy, or a
    tensor moved there."""
    if isinstance(leaf, Replicas):
        return leaf.copies[0].to(device)
    if not isinstance(leaf, ShardedTensor):
        return leaf.to(device)
    grid = leaf.sharding.grid(leaf.ndim)

    def cat(prefix: tuple) -> torch.Tensor:
        d = len(prefix)
        if d == len(grid):
            return leaf.shards[prefix].to(device)
        parts = [cat(prefix + (i,)) for i in range(grid[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
    return cat(())


def _model_dims(spec, ndim: int) -> list:
    """The dims a spec shards over ``"model"`` (the rules give it alone)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    for names in spec:
        if isinstance(names, tuple) and "model" in names:
            raise ValueError(f"spec {spec} shards a dim over 'model' with "
                             "other axes")
    return [d for d, names in enumerate(spec) if names == "model"]


def model_slice_shape(shape, sharding: Sharding) -> Tuple[int, ...]:
    """The shape of ``model_slice``'s result for a leaf of ``shape``."""
    m = axis_size(sharding.mesh, "model")
    dims = _model_dims(sharding.spec, len(shape))
    return tuple(n // m if d in dims else n for d, n in enumerate(shape))


def model_slice(leaf, m: int, device, layer: Optional[int] = None
                ) -> torch.Tensor:
    """Model slice ``m`` of a leaf on ``device``: along each dim sharded
    over ``"model"`` only shard ``m``, whole along every other dim (the
    ``data`` axis's shards of it concatenated: the reference's FSDP gather
    within one tensor-parallel shard).  A leaf not sharded over ``"model"``
    comes whole (``gather``).  With ``layer`` only that index of the
    leading (layer) dim moves; that dim is never sharded."""
    if not isinstance(leaf, ShardedTensor):
        if isinstance(leaf, Replicas):
            leaf = leaf.copies[0]
        return (leaf if layer is None else leaf[layer]).to(device)
    grid = leaf.sharding.grid(leaf.ndim)
    dims = _model_dims(leaf.sharding.spec, leaf.ndim)
    lead = 0 if layer is None else 1
    assert layer is None or grid[0] == 1, leaf.sharding.spec

    def cat(prefix: tuple) -> torch.Tensor:
        d = len(prefix)
        if d == len(grid):
            s = leaf.shards[prefix]
            return (s if layer is None else s[layer]).to(device)
        if d in dims:
            return cat(prefix + (m,))
        parts = [cat(prefix + (i,)) for i in range(grid[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts,
                                                          dim=d - lead)
    return cat(())


def add_model_slice(acc, m: int, grad: torch.Tensor,
                    layer: Optional[int] = None) -> None:
    """``model_slice``'s transpose: add ``grad``, the gradient of model
    slice ``m`` of a leaf (its layer ``layer``), into ``acc``, the leaf's
    storage-shaped accumulator (a ``ShardedTensor`` sharded as the leaf,
    or a tensor): into each shard whose index along the dims sharded over
    ``"model"`` is ``m``, its part along the other dims (as ``model_slice``
    concatenated them), on the shard's device; for a leaf not sharded
    over ``"model"``, into every shard.  Summed over the model positions
    this gives a replicated leaf the sum of its copies' gradients."""
    if not isinstance(acc, ShardedTensor):
        (acc if layer is None else acc[layer]).add_(grad.to(acc.device))
        return
    dims = _model_dims(acc.sharding.spec, acc.ndim)
    lead = 0 if layer is None else 1
    assert layer is None or acc.sharding.grid(acc.ndim)[0] == 1, \
        acc.sharding.spec
    for idx, shard in acc.shards.items():
        if any(idx[d] != m for d in dims):
            continue
        part = tuple(slice(None) if d in dims else
                     slice(idx[d] * shard.shape[d],
                           (idx[d] + 1) * shard.shape[d])
                     for d in range(lead, acc.ndim))
        (shard if layer is None else shard[layer]).add_(
            grad[part].to(shard.device))


def model_replicated(leaf) -> bool:
    """Whether every model position reads the whole of ``leaf`` (a
    ``ShardedTensor`` with no dim over ``"model"``, or one tensor)."""
    return not isinstance(leaf, ShardedTensor) \
        or not _model_dims(leaf.sharding.spec, leaf.ndim)


class CopyGrads:
    """The gradients of a model-replicated leaf's copies, one a model
    position of a data shard: summed in float32, in the order m = 0, 1,
    ..., on the first position's device (``first``), then added into the
    storage shards once (``add_model_slice``): one send a data shard
    instead of one a position.  A (leaf, layer)'s sum goes when every
    position that read it (``expect``) has given its gradient (``put``);
    ``flush`` sends the others' (a copy no loss reached) after the
    backward."""

    def __init__(self, first):
        self.first = torch.device(first)
        self.want: dict = {}
        self.got: dict = {}

    def expect(self, key, m: int) -> None:
        self.want.setdefault(key, set()).add(m)

    def put(self, key, m: int, grad: torch.Tensor, acc,
            layer: Optional[int] = None) -> None:
        got = self.got.setdefault(key, ({}, acc, layer))[0]
        g = grad.to(self.first).float()
        got[m] = got[m] + g if m in got else g
        if self.want[key] <= got.keys():
            self._send(key)

    def _send(self, key) -> None:
        got, acc, layer = self.got.pop(key)
        total = None
        for m in sorted(got):
            total = got[m] if total is None else total + got[m]
        add_model_slice(acc, 0, total, layer)

    def flush(self) -> None:
        for key in list(self.got):
            self._send(key)


def zeros_like_storage(leaf):
    """A zero accumulator stored as ``leaf``: each shard's zeros on its
    device, or one zero tensor."""
    if isinstance(leaf, ShardedTensor):
        return leaf.map(torch.zeros_like)
    return torch.zeros_like(leaf)


@dataclasses.dataclass
class GatherCount:
    """Bytes each mesh position assembled from the storage, by leaf path
    (``model_slice``'s results, the part the position holds itself
    included)."""

    by_position: Dict[tuple, Dict[tuple, int]] = dataclasses.field(
        default_factory=dict)

    def add(self, position: tuple, path: tuple, t: torch.Tensor) -> None:
        at = self.by_position.setdefault(position, {})
        at[path] = at.get(path, 0) + t.numel() * t.element_size()

    def totals(self) -> Dict[tuple, int]:
        """Mesh position → bytes over every leaf."""
        return {pos: sum(v.values()) for pos, v in self.by_position.items()}


def pieces(leaf) -> list:
    """A leaf's storage tensors: a ``ShardedTensor``'s shards in index
    order, or the tensor itself."""
    return list(leaf.shards.values()) if isinstance(leaf, ShardedTensor) \
        else [leaf]


def shard_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching leaf of ``shardings``
    (``shard``); a ``None`` sharding leaves the leaf as it is."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return tree if shardings is None else shard(tree, shardings)


def unshard_tree(tree, device):
    """Every leaf gathered whole onto ``device``."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    return gather(tree, device)

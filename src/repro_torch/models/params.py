"""Parameter metadata system: a single source of truth per parameter.

Port of ``repro.models.params``.  Each model declares a tree of ``Meta``
(shape + logical axes + init); ``init_params`` materializes it as a dict
tree of tensors, with one seeded ``torch.Generator`` per parameter path
(the reference's per-path key derivation; the values differ from JAX's).
``params_from_numpy`` carries a reference param tree across, so both
packages compute with the same weights; ``abstract_params`` gives the
tree's shapes and dtypes without storage; ``param_pspecs`` maps each
leaf's logical axes to a sharding spec.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Meta:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names (None = never sharded)
    init: str = "normal"                  # normal | zeros | ones
    scale: Optional[float] = None         # None → 1/sqrt(fan_in) (last-but-one dim)
    dtype: Any = None                     # None → model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


MetaTree = Dict[str, Union[Meta, "MetaTree"]]


def _walk(tree: Mapping, prefix=()):
    """(path, leaf) pairs in sorted key order; a leaf is anything that is
    not a mapping (a Meta, a tensor, an array)."""
    for k, v in sorted(tree.items()):
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _path_seed(seed: int, path: Tuple[str, ...]) -> int:
    """The generator seed of one parameter: a digest of ``seed`` and its
    path, as the reference folds the path into its base key.  The digest
    mixes both into every bit (the CPU generator reads only the low 32)."""
    h = hashlib.blake2s(f"{int(seed)}\0{'/'.join(path)}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") % 2 ** 63


def _fan_in(meta: Meta) -> int:
    if len(meta.shape) == 0:
        return 1
    if len(meta.shape) == 1:
        return meta.shape[0]
    return int(np.prod(meta.shape[:-1]))  # contracting dims = all but last


def _set(out: Dict, path: Tuple[str, ...], val) -> None:
    node = out
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = val


def init_params(metas: MetaTree, seed: int = 0,
                param_dtype=torch.float32, device="cuda") -> Dict:
    """Materialize ``metas`` on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``; raises without a card).  Normal leaves are
    ``scale · N(0, 1)`` drawn in float32 from the path's own generator."""
    dev = resolve_device(device)
    out: Dict = {}
    for path, meta in _walk(metas):
        dtype = meta.dtype or param_dtype
        if meta.init == "zeros":
            val = torch.zeros(meta.shape, dtype=dtype, device=dev)
        elif meta.init == "ones":
            val = torch.ones(meta.shape, dtype=dtype, device=dev)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_path_seed(seed, path))
            scale = meta.scale if meta.scale is not None \
                else _fan_in(meta) ** -0.5
            val = (scale * torch.randn(meta.shape, generator=gen,
                                       dtype=torch.float32, device=dev)
                   ).to(dtype)
        _set(out, path, val)
    return out


def abstract_params(metas: MetaTree, param_dtype=torch.float32) -> Dict:
    """``metas`` as tensors on the ``meta`` device: the shapes and dtypes
    of ``init_params``'s tree, with no storage (the reference's
    ``ShapeDtypeStruct`` tree)."""
    out: Dict = {}
    for path, meta in _walk(metas):
        _set(out, path, torch.empty(meta.shape,
                                    dtype=meta.dtype or param_dtype,
                                    device="meta"))
    return out


def param_pspecs(metas: MetaTree, rules: Mapping[str, Optional[str]],
                 mesh=None) -> Dict:
    """Logical axes → a spec per leaf: a tuple with one entry a dim (None,
    an axis name or a tuple of names; the reference's ``PartitionSpec``).
    If ``mesh`` is given, an axis is only sharded when the dim divides the
    mesh axis size (guarded FSDP/TP)."""
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh \
        else {}

    def spec_axis(logical, dim):
        phys = rules.get(logical)
        if phys is None:
            return None
        names = phys if isinstance(phys, tuple) else (phys,)
        total = 1
        for nm in names:
            total *= axis_sizes.get(nm, 1)
        if mesh is not None and dim % total != 0:
            return None
        return phys

    out: Dict = {}
    for path, meta in _walk(metas):
        _set(out, path, tuple(spec_axis(ax, dim) if ax else None
                              for ax, dim in zip(meta.axes, meta.shape)))
    return out


def params_from_numpy(tree: Mapping, device="cuda", dtype=None) -> Dict:
    """A reference param tree (numpy arrays, or anything ``np.asarray``
    reads, such as JAX arrays) → the port's tree of tensors on ``device``.

    The layout is the reference's: stacked ``layers`` with a leading
    ``n_periods`` dim of ``pos{i}`` subtrees, ``tail{i}`` blocks, and the
    top-level embedding and norms.  Each leaf keeps its dtype (bfloat16
    arrives through float32, which holds it exactly) unless ``dtype`` is
    given.  ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``;
    a CUDA device without a card raises.
    """
    dev = resolve_device(device)
    out: Dict = {}
    for path, leaf in _walk(tree):
        arr = np.asarray(leaf)
        target = dtype
        if arr.dtype.name == "bfloat16":      # numpy has no bfloat16
            arr, target = arr.astype(np.float32), dtype or torch.bfloat16
        t = torch.tensor(arr)                    # a copy the tree owns
        _set(out, path, t.to(dev, target) if target else t.to(dev))
    return out


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_slice(tree, idx):
    """Select index ``idx`` along the leading (stacked/period) dimension."""
    return tree_map(lambda x: x[idx], tree)


def count_params(params) -> int:
    return sum(int(np.prod(x.shape)) for _, x in _walk(params))

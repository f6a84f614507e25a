"""Weights made on the device from the run's seed.

A configuration's reference module gives its parameter spec: one ``Leaf`` a
parameter, named by its path in the program's parameter tree, with its
shape, dtype and initialisation.  Each normal leaf is drawn by
``Tensor.normal_`` in its own dtype from a ``torch.Generator`` on the device
seeded by the run's seed and the leaf's path, one call a leaf, or one a
layer for a leaf stacked over layers, so the reference can make any layer
again by itself after the window, with the same values, without holding the
others.  Nothing is drawn on the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | uniform | zeros | ones
    scale: float = 1.0            # normal: its deviation; uniform: [0, s)
    stacked: bool = False         # leading dim = layers, one draw a layer
    dtype: str = "float32"


def leaf_seed(seed: int, path: Tuple[str, ...], layer: Optional[int]) -> int:
    text = f"{int(seed)}\0{'/'.join(path)}\0{'' if layer is None else layer}"
    digest = hashlib.blake2s(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % 2 ** 63


def _dtype(name: str):
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _fill(t, leaf: Leaf, seed: int, layer: Optional[int], device):
    import torch
    if leaf.init == "zeros":
        return t.zero_()
    if leaf.init == "ones":
        return t.fill_(1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, leaf.path, layer))
    if leaf.init == "uniform":
        return t.uniform_(0.0, leaf.scale, generator=gen)
    return t.normal_(0.0, leaf.scale, generator=gen)


def make_leaf(leaf: Leaf, seed: int, device, layer: Optional[int] = None):
    """One leaf on ``device``; with ``layer``, only that layer of a stacked
    leaf (the same values as that slice of the whole leaf)."""
    import torch
    dtype = _dtype(leaf.dtype)
    if layer is not None:
        return _fill(torch.empty(leaf.shape[1:], dtype=dtype, device=device),
                     leaf, seed, layer, device)
    t = torch.empty(leaf.shape, dtype=dtype, device=device)
    if leaf.stacked and leaf.init in ("normal", "uniform"):
        for i in range(leaf.shape[0]):
            _fill(t[i], leaf, seed, i, device)
        return t
    return _fill(t, leaf, seed, None, device)


def set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_tree(spec: Iterable[Leaf], seed: int, device) -> Dict:
    """Every leaf of ``spec``, as a tree keyed by the paths."""
    tree: Dict = {}
    for leaf in spec:
        set_path(tree, leaf.path, make_leaf(leaf, seed, device))
    return tree


def leaves(tree: Dict, prefix: Tuple[str, ...] = ()):
    """``(path, tensor)`` pairs of a tree in sorted key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value

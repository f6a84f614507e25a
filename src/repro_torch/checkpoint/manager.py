"""Fault-tolerant checkpointing: atomic and versioned, in the reference's
layout.

Port of ``repro.checkpoint.manager``:

    <dir>/step_<N>/manifest.json     step, flat keys, shapes/dtypes, extras
    <dir>/step_<N>/arrays.npz        flattened leaves by "//"-joined path
    <dir>/latest                     text file → "step_<N>" (atomic rename)

Write protocol: temp dir → fsync'd npz → atomic rename → update ``latest``.
A crash at any point leaves either the old or the new checkpoint visible,
never a torn one.  The layout and keys are the reference's, so either
package restores the other's float32 checkpoints.  numpy has no bfloat16:
a bfloat16 leaf is stored as the float32 array that holds it exactly (its
manifest entry says ``bfloat16``), and ``restore`` casts every leaf to its
template leaf's dtype, as the reference does.  A leaf held as shards on a
mesh (``parallel.sharding.ShardedTensor``) is gathered to the host, so the
file is the unsharded one; ``restore(shardings=)`` places each leaf on a
mesh, resharding a checkpoint onto any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.params import _set, _walk
from ..parallel.sharding import ShardedTensor, gather, shard

SEP = "//"


def _flatten(tree) -> Dict[str, Any]:
    """``"//"``-joined key path → leaf, in sorted key order (the order and
    keys of the reference's ``tree_flatten_with_path`` over dicts)."""
    return {SEP.join(path): leaf for path, leaf in _walk(tree)}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        leaf = gather(leaf, "cpu")
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save(ckpt_dir: str, step: int, tree, extras: Optional[dict] = None):
    """Write ``tree`` (a dict tree of tensors, sharded leaves or arrays) as
    ``step_<step>`` and point ``latest`` at it.  Returns the checkpoint's
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _flatten(tree)
    flat = {k: _to_numpy(v) for k, v in leaves.items()}
    manifest = {
        "step": int(step),
        "keys": {k: [list(flat[k].shape), _dtype_name(v)]
                 for k, v in leaves.items()},
        "extras": extras or {},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic "latest" pointer
    ptr_tmp = os.path.join(ckpt_dir, ".latest_tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step}")
        f.flush()
        os.fsync(f.fileno())
    os.rename(ptr_tmp, os.path.join(ckpt_dir, "latest"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step ``latest`` names, or None if there is no complete one."""
    ptr = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            device=None, shardings=None):
    """Restore into ``template``'s structure (a dict tree of tensors, which
    may lie on the ``meta`` device, or of sharded leaves).  Returns
    ``(tree, manifest)``.

    Each leaf takes its template leaf's dtype.  With ``shardings`` (a
    matching tree of ``parallel.sharding.Sharding``; a ``None`` entry
    places nothing) a leaf is placed on its sharding's mesh, resharded from
    the file (a sharded template leaf needs one); any other lands on
    ``device``, or, with ``device=None``, on its template leaf's device (a
    ``meta`` template needs ``device``).  A leaf the checkpoint lacks
    raises ``KeyError``; no ``latest`` raises ``FileNotFoundError``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dev = None if device is None else resolve_device(device)
    out: Dict = {}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for path, leaf in _walk(template):
            key = SEP.join(path)
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            sharding = _at(shardings, path)
            value = torch.from_numpy(z[key])
            if sharding is not None:
                _set(out, path, shard(value.to(leaf.dtype), sharding))
                continue
            target = dev or leaf.device
            if target.type == "meta":
                raise ValueError(f"leaf {key!r}: a meta template needs "
                                 "device=")
            _set(out, path, value.to(target, leaf.dtype))
    return out, manifest


def _at(tree, path):
    """The entry of ``tree`` at ``path``, or None where there is none."""
    for k in path:
        if not isinstance(tree, dict):
            return None
        tree = tree.get(k)
    return tree

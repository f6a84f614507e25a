"""Step functions (train, prefill, decode), their shardings, the abstract
training state and the input specs of each (arch, shape) cell.

Port of ``repro.launch.steps``.  The reference jits its steps with
``donate_argnums``; here the steps run eagerly, AdamW updates the params
and its state in place (``optim.adamw.update``) and a sharded decode step
writes the new cache into the cache's storage shards.

With a mesh the reference's one program is sharded by XLA.  Here one
process drives every device of the ``DeviceMesh`` (single-controller, as
the reference's): the params and AdamW's m and v are sharded storage
(``parallel.sharding``), the batch splits over its data-parallel axes, and
each data shard gathers the params onto its device, takes its loss and
gradients there, and the gradients are reduced into the storage shards.
Serving is the same: each data shard gathers the params and its rows of
the cache (sharded storage by ``cache_shardings``) onto its device, runs
the one-device ``prefill`` / ``decode_step`` there and writes its rows of
the new cache back into the storage shards.  An MoE model's decode step is
the exception: the reference bundles the global batch for its experts, so
the data shards walk the layers in step and exchange their rows at each
MoE FFN (``_global_moe_decode``).  The model axis shards storage, not
computation: the port has no tensor-parallel layers.

``input_specs`` gives each cell's inputs as ``meta`` tensors (no storage),
where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models import model as M
from ..models.blocks import _ffn_out, block_decode_mixer
from ..models.params import _set, _walk, tree_slice
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


def data_shards(mesh, n_rows: int) -> list:
    """``[(device, first row, end row)]``: ``n_rows`` split over the axes
    ``batch_spec`` gives them, into equal slices, each on the device of its
    shard (one slice on the mesh's first device where the rows do not
    divide)."""
    sharding = S.Sharding(mesh, S.batch_spec(mesh, n_rows, 0))
    devices = list(sharding.placement(1).values())
    size = n_rows // len(devices)
    return [(dev, i * size, (i + 1) * size) for i, dev in enumerate(devices)]


def batch_shards(mesh, batch: Dict[str, torch.Tensor]) -> list:
    """``[(device, batch slice)]``: the batch split along its leading dim
    as ``data_shards`` splits its rows, each slice on its shard's device."""
    n_rows = next(iter(batch.values())).shape[0]
    return [(dev, {k: v[lo:hi].to(dev) for k, v in batch.items()})
            for dev, lo, hi in data_shards(mesh, n_rows)]


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


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def _cache_axis(path) -> int:
    """The batch axis of the cache leaf at ``path``."""
    return M._cache_batch_axis(path[0])


def read_rows(leaf, axis: int, lo: int, hi: int, device) -> torch.Tensor:
    """Rows ``[lo, hi)`` along ``axis`` of a leaf, whole on ``device``:
    the parts of every storage shard they meet, copied into place."""
    if not isinstance(leaf, S.ShardedTensor):
        return leaf.narrow(axis, lo, hi - lo).to(device)
    shape = list(leaf.shape)
    shape[axis] = hi - lo
    out = torch.empty(shape, dtype=leaf.dtype, device=device)
    for idx, shard in leaf.shards.items():
        sl = list(leaf.slices(idx))
        a, b = max(sl[axis].start, lo), min(sl[axis].stop, hi)
        if a < b:
            piece = shard.narrow(axis, a - sl[axis].start, b - a)
            sl[axis] = slice(a - lo, b - lo)
            out[tuple(sl)] = piece.to(device)
    return out


def write_rows(leaf, axis: int, lo: int, rows: torch.Tensor) -> None:
    """Write ``rows`` (whole in every other dim) at ``lo`` along ``axis``
    into a leaf's storage: each storage shard takes the part it holds."""
    if not isinstance(leaf, S.ShardedTensor):
        leaf.narrow(axis, lo, rows.shape[axis]).copy_(rows)
        return
    hi = lo + rows.shape[axis]
    for idx, shard in leaf.shards.items():
        sl = list(leaf.slices(idx))
        a, b = max(sl[axis].start, lo), min(sl[axis].stop, hi)
        if a < b:
            start = sl[axis].start
            sl[axis] = slice(a - lo, b - lo)
            shard.narrow(axis, a - start, b - a).copy_(rows[tuple(sl)])


def _by_rows(mesh, parts: list, n_rows: int):
    """The data shards' outputs (``parts``, in shard order, each on its
    shard's device) as one leaf sharded over the batch as ``batch_spec``
    gives it: no copy.  One shard is the tensor itself."""
    if len(parts) == 1:
        return parts[0]
    sharding = S.Sharding(mesh, S.batch_spec(mesh, n_rows,
                                             parts[0].ndim - 1))
    shape = torch.Size((n_rows, *parts[0].shape[1:]))
    return S.ShardedTensor(sharding, shape, {
        (i,) + (0,) * (len(shape) - 1): p for i, p in enumerate(parts)})


def _at(tree, path):
    """The leaf of a dict tree at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def _cache_storage(cfg: ModelConfig, mesh, batch: int, part):
    """An uninitialised cache tree of ``batch`` rows on the mesh, shaped as
    the data shard's cache ``part`` but for its rows, each leaf allocated as
    its ``cache_shardings`` storage (every element is written by the data
    shards' prefills)."""
    abstract: Dict = {}
    for path, leaf in _walk(part):
        shape = list(leaf.shape)
        shape[_cache_axis(path)] = batch
        _set(abstract, path, torch.empty(shape, dtype=leaf.dtype,
                                         device="meta"))
    shardings = S.cache_shardings(cfg, mesh, abstract, batch)
    storage: Dict = {}
    for path, leaf in _walk(abstract):
        _set(storage, path, S.empty(leaf.shape, leaf.dtype,
                                    _at(shardings, path)))
    return storage


def _gathered(leaves: List, device) -> Dict:
    tree: Dict = {}
    for path, p in leaves:
        _set(tree, path, S.gather(p, device))
    return tree


def make_prefill_step(cfg: ModelConfig, batch: int, seq: int, mesh=None):
    """``prefill_step(params, tokens) → (logits, cache)``: a zero cache of
    ``batch`` rows and ``seq`` positions on the tokens' device, then
    ``M.prefill``.  An encoder-decoder's step takes ``frames`` and returns
    ``(enc_out, cache)``, its cross K/V over ``seq`` encoder positions.

    With a ``mesh`` the params arrive as sharded storage
    (``params_shardings``) and the rows split over the data-parallel axes
    (``data_shards``).  Data shard ``k``, in order, gathers every param
    leaf onto its device, prefills its rows into a cache of its own there
    and writes them into the cache's storage (``cache_shardings``).  The
    logits (or ``enc_out``) come back sharded over the batch as
    ``batch_spec`` gives it, each shard on its data shard's device; the
    cache as its storage.  Where the batch does not divide (the batch-1
    cell) one shard runs on the mesh's first device and its cache is
    re-sharded, its sequence dim over ``data``.
    """
    def one_device(params, x):
        cache = M.init_cache(cfg, x.shape[0], seq,
                             s_enc=seq if cfg.enc_dec else 0, device=x.device)
        if cfg.enc_dec:
            return M.encdec_prefill(cfg, params, x, cache)
        return M.prefill(cfg, params, x, cache)

    if mesh is None:
        return one_device

    def prefill_step(params, x):
        leaves = list(_walk(params))
        cache, outs = None, []
        with use_mesh(mesh):
            for dev, lo, hi in data_shards(mesh, batch):
                out, part = one_device(_gathered(leaves, dev),
                                       x[lo:hi].to(dev))
                if cache is None:
                    cache = _cache_storage(cfg, mesh, batch, part)
                for path, leaf in _walk(cache):
                    write_rows(leaf, _cache_axis(path), lo,
                               _at(part, path))
                outs.append(out)
                del part
        return _by_rows(mesh, outs, batch), cache
    return prefill_step


# the param keys of a block's FFN sub-layer (``blocks._ffn_out``'s)
_FFN_KEYS = ("ln2", "ffn", "ln2_post")


def _blocks(cfg: ModelConfig, params) -> list:
    """``M._run_stack``'s walk of a decoder-only stack: ``(layer type,
    subtree keys, layer index)`` for each block in its order, the index
    None for a tail block."""
    out = []
    if "layers" in params:
        for i in range(M._n_stacked(params["layers"])):
            out += [(lt, ("layers", f"pos{j}"), i)
                    for j, lt in enumerate(cfg.layer_pattern)]
    return out + [(lt, (f"tail{i}",), None)
                  for i, lt in enumerate(cfg.tail_layers)]


def _layer(leaf, i, device) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf (the leaf itself for ``i`` None),
    whole on ``device``: only that layer's part of each storage shard
    moves (the layer dim is never sharded)."""
    if i is None:
        return S.gather(leaf, device)
    if not isinstance(leaf, S.ShardedTensor):
        return leaf[i].to(device)
    assert leaf.sharding.grid(leaf.ndim)[0] == 1, leaf.sharding.spec
    return S.gather(S.ShardedTensor(
        S.Sharding(leaf.sharding.mesh, leaf.sharding.spec[1:]),
        leaf.shape[1:], {idx[1:]: s[i] for idx, s in leaf.shards.items()}),
        device)


def _block_params(params, keys, i, device, ffn: bool) -> Dict:
    """The params of one block (``_blocks``), whole on ``device``: its FFN
    sub-layer's (``ffn``) or the rest."""
    out: Dict = {}
    for path, leaf in _walk(_at(params, keys)):
        if (path[0] in _FFN_KEYS) is ffn:
            _set(out, path, _layer(leaf, i, device))
    return out


def _global_moe_decode(cfg: ModelConfig, params, cache, token, pos,
                       shards: list):
    """An MoE model's mesh decode step over ``shards`` (``data_shards``):
    every data shard embeds its rows and reads its rows of the cache onto
    its device, then the shards walk the blocks in step.  At each block
    each shard runs the mixer (``block_decode_mixer``) on its rows with
    that block's mixer params gathered onto its device; the FFN inputs of
    all shards are then gathered in row order onto the first shard's
    device, where one ``_ffn_out`` over the B rows bundles them for the
    experts at ``expert_capacity(B, ...)``, as the reference's one program
    does (a runtime's host route runs once a block), and each shard's
    output rows go back to its device.  Last, each shard's head and its
    rows of the new cache written into the storage shards.  Returns the
    shards' logits in order."""
    first = shards[0][0]
    cache_leaves = list(_walk(cache))
    xs, poss, parts = [], [], []
    for dev, lo, hi in shards:
        part: Dict = {}
        for path, leaf in cache_leaves:
            _set(part, path, read_rows(leaf, _cache_axis(path), lo, hi, dev))
        parts.append(part)
        xs.append(M._embed_in(cfg, {"embed": S.gather(params["embed"], dev)},
                              token[lo:hi].to(dev)))
        p = pos[lo:hi] if torch.is_tensor(pos) and pos.ndim == 1 else pos
        poss.append(torch.as_tensor(p, dtype=torch.int32,
                                    device=dev).expand(hi - lo))
    # each shard's new cache: its tail blocks, and its layers by index
    new: list = [{} for _ in shards]
    layers: list = [{} for _ in shards]
    for lt, keys, i in _blocks(cfg, params):
        for k, (dev, _, _) in enumerate(shards):
            c = _at(parts[k], keys)
            if i is not None:
                c = tree_slice(c, i)
            xs[k], c = block_decode_mixer(
                cfg, lt, _block_params(params, keys, i, dev, ffn=False),
                xs[k], c, poss[k])
            if i is None:
                new[k][keys[0]] = c
            else:
                layers[k].setdefault(i, {})[keys[1]] = c
        x, _, _ = _ffn_out(cfg, _block_params(params, keys, i, first,
                                              ffn=True),
                           torch.cat([x.to(first) for x in xs]))
        xs = [x[lo:hi].to(dev) for dev, lo, hi in shards]
    outs = []
    for (dev, lo, _), x, tree, by_index in zip(shards, xs, new, layers):
        head = {k: S.gather(params[k], dev)
                for k in ("embed", "unembed", "final_norm") if k in params}
        outs.append(M._out_head(cfg, head, x))
        if by_index:
            tree["layers"] = M._stack_trees([by_index[i]
                                             for i in sorted(by_index)])
        for path, leaf in cache_leaves:
            write_rows(leaf, _cache_axis(path), lo, _at(tree, path))
    return outs


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, cache, token, pos) → (logits, cache)``:
    ``M.decode_step``.  ``pos`` is a scalar (a Python int for an
    encoder-decoder, whose step reads it on the host) or per-row (B,).

    With a ``mesh`` the params and the cache arrive as sharded storage.
    Data shard ``k``, in order, gathers every param leaf and its rows of
    every cache leaf whole onto its device, decodes them there and writes
    its rows of the new cache back into the storage shards: the cache is
    updated in place and returned (the reference donates it).  The logits
    come back as ``make_prefill_step``'s do.  An MoE model's step over
    more than one data shard bundles the whole batch for its experts at
    each MoE layer, as the reference's one program does
    (``_global_moe_decode``).
    """
    if mesh is None:
        def serve_step(params, cache, token, pos):
            return M.decode_step(cfg, params, cache, token, pos)
        return serve_step

    def serve_step(params, cache, token, pos):
        leaves = list(_walk(params))
        cache_leaves = list(_walk(cache))
        n_rows = token.shape[0]
        shards = data_shards(mesh, n_rows)
        if cfg.ffn == "moe" and len(shards) > 1:
            with use_mesh(mesh):
                outs = _global_moe_decode(cfg, params, cache, token, pos,
                                          shards)
            return _by_rows(mesh, outs, n_rows), cache
        outs = []
        with use_mesh(mesh):
            for dev, lo, hi in shards:
                part: Dict = {}
                for path, leaf in cache_leaves:
                    _set(part, path, read_rows(leaf, _cache_axis(path), lo,
                                               hi, dev))
                p = pos[lo:hi].to(dev) if torch.is_tensor(pos) \
                    and pos.ndim == 1 else pos
                logits, part = M.decode_step(cfg, _gathered(leaves, dev),
                                             part, token[lo:hi].to(dev), p)
                for path, leaf in cache_leaves:
                    write_rows(leaf, _cache_axis(path), lo, _at(part, path))
                outs.append(logits)
                del part
        return _by_rows(mesh, outs, n_rows), cache
    return serve_step


# ---------------------------------------------------------------------------
# Input specs (meta tensors: no storage)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Each cell's inputs as ``meta`` tensors of the reference's shapes and
    dtypes; a decode cell's cache is ``M.init_cache(..., device="meta")``
    and its ``pos`` a scalar."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec((b, s), i32), "labels": spec((b, s), i32)}
        if cfg.n_image_tokens:
            specs["images"] = spec((b, cfg.n_image_tokens, cfg.d_image), f32)
        if cfg.enc_dec:
            specs["frames"] = spec((b, s, cfg.d_frame), f32)
        return specs
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return {"frames": spec((b, s, cfg.d_frame), f32)}
        return {"tokens": spec((b, s), i32)}
    if shape.kind == "decode":
        return {"cache": M.init_cache(cfg, b, s, s_enc=s if cfg.enc_dec
                                      else 0, device="meta"),
                "token": spec((b, 1), i32), "pos": spec((), i32)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Shardings per cell
# ---------------------------------------------------------------------------

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


def decode_shardings(cfg: ModelConfig, mesh, cache_tree, batch: int):
    """``(param shardings, cache shardings, token sharding, pos
    sharding)``, as the reference's: the token over the batch, ``pos``
    replicated."""
    return (S.params_shardings(cfg, mesh),
            S.cache_shardings(cfg, mesh, cache_tree, batch),
            S.Sharding(mesh, S.batch_spec(mesh, batch, 1)),
            S.Sharding(mesh, ()))

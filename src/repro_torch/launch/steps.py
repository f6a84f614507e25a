"""Step functions (train, prefill, decode), their shardings, the abstract
training state and the input specs of each (arch, shape) cell.

Port of ``repro.launch.steps``.  The reference jits its steps with
``donate_argnums``; here the steps run eagerly, AdamW updates the params
and its state in place (``optim.adamw.update``) and a sharded decode step
writes the new cache into the cache's storage shards.

With a mesh the reference's one program is sharded by XLA.  Here one
process drives every device of the ``DeviceMesh`` (single-controller, as
the reference's): the params and AdamW's m and v are sharded storage
(``parallel.sharding``) and the batch splits over its data-parallel axes.

Training and serving compute over the model axis too wherever
``parallel.tensor_parallel.tp_route`` takes the config: decoder-only
attention with a dense SwiGLU FFN (qwen3-1.7b, qwen3-4b, gemma2-2b,
gemma3-27b, paligemma-3b's text path) or an MoE FFN (dbrx-132b,
kimi-k2-1t-a32b: expert parallelism), RWKV6 (rwkv6-1.6b), hymba-1.5b's
hybrid mixer and whisper-small's encoder-decoder.  Each data shard's model
positions walk the layers together, each on its slice (attention and SSM
heads, FFN columns, experts, vocabulary rows or, where the model axis does
not divide the vocabulary, the whole table; K4 and K6 on its heads, K5 on
its experts), their partial outputs summed after each sub-layer, as XLA
partitions the reference's program.  A training step's positions take the
vocabulary-parallel loss and its gradients together, each adding its
slice gradients into the storage shards they came from.  An MoE decode
step over several data
shards walks every shard's positions in step and runs each MoE FFN on the
first shard's positions over the global batch, as the reference's one
program bundles it.  A model axis of one and configs whose widths do not
divide it keep the storage-only route: each data shard gathers the params
(and its rows of the cache) onto its device, runs the one-device
``loss_fn`` (``prefill`` / ``decode_step``) there and reduces its
gradients into the storage shards (writes its rows of the new cache
back); the model axis shards storage, not computation.  There an
MoE model's decode step bundles the global batch for its experts too: the
data shards walk the layers in step and exchange their rows at each MoE FFN
(``_global_moe_decode``).

``input_specs`` gives each cell's inputs as ``meta`` tensors (no storage),
where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..configs import ModelConfig, ShapeConfig
from ..models import model as M
from ..models.blocks import _ffn_out, block_decode_mixer
from ..models.params import _set, _walk, tree_map, tree_slice
from ..optim import adamw
from ..parallel import sharding as S
from ..parallel.api import resolve_spec, use_mesh
from ..parallel.tensor_parallel import (ModelGroup, fetched, model_size,
                                        tp_route)


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


def _tp_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh):
    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        count = S.GatherCount()
        grads = tree_map(S.zeros_like_storage, params)
        n_rows = next(iter(batch.values())).shape[0]
        shards = tp_shards(mesh, n_rows)
        metrics: Dict[str, list] = {"loss": [], "ce": [], "aux": []}
        with use_mesh(mesh):
            for lo, hi, group in shards:
                devices = [mesh.devices[pos] for pos in group]
                anchor = torch.zeros(0, requires_grad=True)
                copies = S.CopyGrads(devices[0])
                loss, parts = M.loss_fn_tp(
                    cfg, ModelGroup(devices),
                    _tp_fetch(params, mesh, group, count, grads, anchor,
                              copies),
                    [{k: v[lo:hi].to(dev) for k, v in batch.items()}
                     for dev in devices])
                loss.backward()
                copies.flush()
                for k, v in (("loss", loss), *parts.items()):
                    metrics[k].append(v.detach())
                del loss, parts
        n = len(shards)
        for _, a in _walk(grads):
            for piece in S.pieces(a):
                piece.div_(n)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        first = mesh.devices[shards[0][2][0]]
        metrics = {k: sum(x.to(first) for x in v) / n
                   for k, v in metrics.items()}
        train_step.gathered = count
        return params, opt_state, {**metrics, **om}
    train_step.gathered = S.GatherCount()
    return train_step


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: the loss and the gradient of every param leaf by autograd,
    then one AdamW update.  ``metrics`` holds ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr`` as float32 scalar tensors.

    With a ``mesh`` the params and m/v arrive as sharded storage
    (``train_shardings``, ``parallel.sharding.shard_tree``) and the batch is
    split over the data-parallel axes (``batch_shards``).  A config
    ``parallel.tensor_parallel.tp_route`` takes (a model axis of more than
    one that its widths divide) computes over the model axis: for each
    data shard in order (``tp_shards``), its model positions run
    ``M.loss_fn_tp`` on its rows, each gathering its model slice of one
    layer's params at a time (``sharding.model_slice``, through
    ``tensor_parallel.fetched``: again in the backward under remat;
    counted in the step's ``gathered``) and computing on its heads,
    columns, experts and vocabulary rows (K4, K6 and K5 and their backward
    kernels on its slice), the loss vocabulary-parallel; ``backward()``
    then adds each position's gradient of each slice into the storage
    shards it came from (``sharding.add_model_slice``; a model-replicated
    leaf gets the sum of every position's copy, summed on the data
    shard's first position before one add, ``sharding.CopyGrads``), a
    layer at a time as the backward reaches it.  Otherwise the
    storage-only route: data shard ``k``, in order, gathers every leaf
    onto its device, runs ``loss_fn`` on its
    slice and takes the gradients; each storage shard gets its slice of
    them summed in shard order on its own device.  Either way the sums are
    divided by the number of data shards after the last; a shard's
    gathered params and gradients are freed before the next starts.  The
    loss, ``ce`` and ``aux`` are the means of the shards' (exact for equal
    shards: both are means over rows).  Nothing reads a device value on
    the host, so shards on distinct cards overlap.
    """
    if mesh is not None:
        if tp_route(cfg, mesh):
            return _tp_train_step(cfg, opt_cfg, mesh)
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


def read_block(leaf, block: Dict[int, tuple], device) -> torch.Tensor:
    """The block of a leaf that ``block`` gives (dim → ``(start, end)``;
    whole along every other dim), on ``device``: the parts of every
    storage shard it meets, copied into place."""
    if not isinstance(leaf, S.ShardedTensor):
        idx = [slice(None)] * leaf.ndim
        for d, (a, b) in block.items():
            idx[d] = slice(a, b)
        return leaf[tuple(idx)].to(device)
    want = [block.get(d, (0, n)) for d, n in enumerate(leaf.shape)]
    out = torch.empty([b - a for a, b in want], dtype=leaf.dtype,
                      device=device)
    for idx, shard in leaf.shards.items():
        src, dst = [], []
        for sl, (a, b) in zip(leaf.slices(idx), want):
            lo, hi = max(sl.start, a), min(sl.stop, b)
            if lo >= hi:
                break
            src.append(slice(lo - sl.start, hi - sl.start))
            dst.append(slice(lo - a, hi - a))
        else:
            out[tuple(dst)] = shard[tuple(src)].to(device)
    return out


def write_block(leaf, start: Dict[int, int], data: torch.Tensor) -> None:
    """Write ``data`` at ``start`` (dim → first index; 0 along every other
    dim) into a leaf's storage: each storage shard takes the part it
    holds."""
    first = [start.get(d, 0) for d in range(data.ndim)]
    if not isinstance(leaf, S.ShardedTensor):
        leaf[tuple(slice(a, a + n) for a, n in zip(first, data.shape))] \
            .copy_(data)
        return
    for idx, shard in leaf.shards.items():
        src, dst = [], []
        for sl, a, n in zip(leaf.slices(idx), first, data.shape):
            lo, hi = max(sl.start, a), min(sl.stop, a + n)
            if lo >= hi:
                break
            src.append(slice(lo - a, hi - a))
            dst.append(slice(lo - sl.start, hi - sl.start))
        else:
            shard[tuple(dst)].copy_(data[tuple(src)])


def read_rows(leaf, axis: int, lo: int, hi: int, device) -> torch.Tensor:
    """Rows ``[lo, hi)`` along ``axis`` of a leaf, whole on ``device``."""
    return read_block(leaf, {axis: (lo, hi)}, device)


def write_rows(leaf, axis: int, lo: int, rows: torch.Tensor) -> None:
    """Write ``rows`` (whole in every other dim) at ``lo`` along ``axis``
    into a leaf's storage."""
    write_block(leaf, {axis: lo}, rows)


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


def _cache_storage(cfg: ModelConfig, mesh, batch: int, abstract):
    """An uninitialised cache tree of ``batch`` rows on the mesh, shaped as
    the ``meta`` tree ``abstract``, each leaf allocated as its
    ``cache_shardings`` storage (every element is written by the
    prefill)."""
    shardings = S.cache_shardings(cfg, mesh, abstract, batch)
    storage: Dict = {}
    for path, leaf in _walk(abstract):
        _set(storage, path, S.empty(leaf.shape, leaf.dtype,
                                    _at(shardings, path)))
    return storage


def _abstract_rows(part, batch: int) -> Dict:
    """A data shard's cache ``part`` as a ``meta`` tree of ``batch``
    rows."""
    abstract: Dict = {}
    for path, leaf in _walk(part):
        shape = list(leaf.shape)
        shape[_cache_axis(path)] = batch
        _set(abstract, path, torch.empty(shape, dtype=leaf.dtype,
                                         device="meta"))
    return abstract


def _gathered(leaves: List, device) -> Dict:
    tree: Dict = {}
    for path, p in leaves:
        _set(tree, path, S.gather(p, device))
    return tree


# -- tensor parallelism over the model axis (``parallel.tensor_parallel``) --

def tp_shards(mesh, n_rows: int) -> list:
    """``[(first row, end row, [mesh position of model index m, ...])]``:
    each data shard of ``data_shards`` with its model positions, in
    order."""
    axis = mesh.axis_names.index("model")
    placed = S.Sharding(mesh, S.batch_spec(mesh, n_rows, 0)).positions(1)
    size = n_rows // len(placed)
    return [(i * size, (i + 1) * size,
             [pos[:axis] + (m,) + pos[axis + 1:]
              for m in range(mesh.devices.shape[axis])])
            for (i,), pos in placed.items()]


def _tp_fetch(params, mesh, group: list, count: S.GatherCount,
              grads=None, anchor=None, copies=None):
    """``fetch(keys, i, rank=None)`` for ``M.prefill_tp`` /
    ``decode_step_tp`` / ``loss_fn_tp``: the subtree under ``keys`` (layer
    ``i`` of a stacked one) as each model position's slice
    (``model_slice``) on its device, or only model position ``rank``'s (a
    list of one), counted.  With ``grads`` (the storage-shaped
    accumulators of the params) each slice is ``fetched``: its gradient
    goes into ``grads`` (``add_model_slice``) in the backward, a
    model-replicated leaf's through ``copies`` (``S.CopyGrads``: the
    positions' copies summed on the first, then one add)."""
    def one(leaf, path, m, pos, i):
        def get():
            t = S.model_slice(leaf, m, mesh.devices[pos], i)
            count.add(pos, path, t)
            return t
        if grads is None:
            return get()
        acc = _at(grads, path)
        if not S.model_replicated(leaf):
            return fetched(anchor, get,
                           lambda g: S.add_model_slice(acc, m, g, i))
        copies.expect((path, i), m)
        return fetched(anchor, get,
                       lambda g: copies.put((path, i), m, g, acc, i))

    def fetch(keys, i, rank=None):
        sub = _at(params, keys)
        out = []
        for m, pos in enumerate(group):
            if rank is not None and m != rank:
                continue
            if not isinstance(sub, dict):
                out.append(one(sub, keys, m, pos, i))
                continue
            tree: Dict = {}
            for path, leaf in _walk(sub):
                _set(tree, path, one(leaf, keys + path, m, pos, i))
            out.append(tree)
        return out
    return fetch


def _piece_block(cfg: ModelConfig, size: int, m: int, path, lo: int,
                 hi: int) -> Dict[int, tuple]:
    """Model position ``m``'s block of the cache leaf at ``path`` over the
    rows ``[lo, hi)``: those rows and its heads (``M.cache_heads``)."""
    axis = _cache_axis(path)
    block = {axis: (lo, hi)}
    heads = M.cache_heads(cfg, size, m, path[-1])
    if heads is not None:
        block[axis + 1] = heads
    return block


def _read_pieces(cfg: ModelConfig, mesh, cache, lo: int, hi: int,
                 group: list) -> list:
    """Each model position's piece of the cache over the rows ``[lo,
    hi)``, on its device."""
    out = []
    for m, pos in enumerate(group):
        piece: Dict = {}
        for path, leaf in _walk(cache):
            _set(piece, path, read_block(
                leaf, _piece_block(cfg, len(group), m, path, lo, hi),
                mesh.devices[pos]))
        out.append(piece)
    return out


def _write_pieces(cfg: ModelConfig, cache, pieces: list, lo: int) -> None:
    """The positions' new cache pieces written into the storage: each head
    by the first position that computes it, a leaf without heads by the
    first position."""
    size = len(pieces)
    for path, leaf in _walk(cache):
        axis = _cache_axis(path)
        done = 0
        for m, piece in enumerate(pieces):
            x = _at(piece, path)
            heads = M.cache_heads(cfg, size, m, path[-1])
            if heads is None:
                if m == 0:
                    write_block(leaf, {axis: lo}, x)
                continue
            j0, j1 = heads
            a = max(j0, done)
            if a < j1:
                write_block(leaf, {axis: lo, axis + 1: a},
                            x.narrow(axis + 1, a - j0, j1 - a))
            done = max(done, j1)


def _by_vocab(mesh, outs: list, shape) -> S.ShardedTensor:
    """The positions' logits (``(first row, end row, m, logits)``) as one
    leaf over ``resolve_spec(shape, ("dp", None, "vocab"), mesh)``, the
    reference's ``constrain`` of its logits: each shard's rows and
    vocabulary slice on its device (where the model axis does not divide
    the vocabulary, the spec leaves it whole: the first model position's
    logits, on its own device)."""
    sharding = S.Sharding(mesh, resolve_spec(shape, ("dp", None, "vocab"),
                                             mesh))
    out = S.ShardedTensor(sharding, torch.Size(shape), {})
    for idx, dev in sharding.placement(len(shape)).items():
        rows = out.slices(idx)[0]
        meet = sorted(((lo, t) for lo, hi, m, t in outs
                       if m == idx[2] and lo < rows.stop and rows.start < hi),
                      key=lambda e: e[0])
        whole = torch.cat([t.to(dev) for _, t in meet]) if len(meet) > 1 \
            else meet[0][1]
        out.shards[idx] = whole.narrow(0, rows.start - meet[0][0],
                                       rows.stop - rows.start).to(dev)
    return out


def _tp_prefill_step(cfg: ModelConfig, batch: int, seq: int, mesh):
    size = model_size(mesh)

    def prefill_step(params, x):
        count = S.GatherCount()
        # an encoder-decoder's cross K/V over its frames, as ``M.
        # encdec_prefill`` builds them
        s_enc = x.shape[1] if cfg.enc_dec else 0
        cache = _cache_storage(cfg, mesh, batch, M.init_cache(
            cfg, batch, seq, s_enc=s_enc, device="meta"))
        outs = []
        with use_mesh(mesh):
            for lo, hi, group in tp_shards(mesh, batch):
                devices = [mesh.devices[pos] for pos in group]
                pieces = [M.init_cache_tp(cfg, size, m, hi - lo, seq, dev,
                                          s_enc=s_enc)
                          for m, dev in enumerate(devices)]
                run = M.encdec_prefill_tp if cfg.enc_dec else M.prefill_tp
                out, pieces = run(
                    cfg, ModelGroup(devices), _tp_fetch(params, mesh, group,
                                                        count),
                    [x[lo:hi].to(dev) for dev in devices], pieces)
                _write_pieces(cfg, cache, pieces, lo)
                outs += [(lo, hi, m, t) for m, t in enumerate(out)
                         if t is not None]
                del pieces
        prefill_step.gathered = count
        if cfg.enc_dec:
            # the encoder's output, the same on each position: the first's
            return _by_rows(mesh, [t for _, _, m, t in outs if m == 0],
                            batch), cache
        return _by_vocab(mesh, outs, (batch, x.shape[1], cfg.vocab_size)), \
            cache
    prefill_step.gathered = S.GatherCount()
    return prefill_step


def _tp_decode_step(cfg: ModelConfig, mesh):
    def serve_step(params, cache, token, pos):
        count = S.GatherCount()
        n_rows = token.shape[0]
        shards = tp_shards(mesh, n_rows)
        devices = [[mesh.devices[p] for p in group] for _, _, group in shards]
        outs = []
        with use_mesh(mesh):
            done = M.decode_step_tp(
                cfg, [ModelGroup(d) for d in devices],
                [_tp_fetch(params, mesh, group, count)
                 for _, _, group in shards],
                [_read_pieces(cfg, mesh, cache, lo, hi, group)
                 for lo, hi, group in shards],
                [[token[lo:hi].to(dev) for dev in d]
                 for (lo, hi, _), d in zip(shards, devices)],
                [pos[lo:hi] if torch.is_tensor(pos) and pos.ndim == 1
                 else pos for lo, hi, _ in shards])
            for (lo, hi, _), (logits, pieces) in zip(shards, done):
                _write_pieces(cfg, cache, pieces, lo)
                outs += [(lo, hi, m, t) for m, t in enumerate(logits)
                         if t is not None]
            del done
        serve_step.gathered = count
        return _by_vocab(mesh, outs, (n_rows, 1, cfg.vocab_size)), cache
    serve_step.gathered = S.GatherCount()
    return serve_step


def make_prefill_step(cfg: ModelConfig, batch: int, seq: int, mesh=None):
    """``prefill_step(params, tokens) → (logits, cache)``: a zero cache of
    ``batch`` rows and ``seq`` positions on the tokens' device, then
    ``M.prefill``.  An encoder-decoder's step takes ``frames`` and returns
    ``(enc_out, cache)``, its cross K/V over ``seq`` encoder positions.

    With a ``mesh`` the params arrive as sharded storage
    (``params_shardings``) and the rows split over the data-parallel axes
    (``data_shards``); the cache comes back as its ``cache_shardings``
    storage.  Where the batch does not divide (the batch-1 cell) one data
    shard runs at the mesh's first data position and the cache is
    re-sharded, its sequence dim over ``data``.

    A config ``parallel.tensor_parallel.tp_route`` takes (a model axis of
    more than one that its widths divide) computes over the model axis:
    for each data shard in order, its model positions walk the layers
    together (``M.prefill_tp``; an encoder-decoder's encoder and cross K/V,
    ``M.encdec_prefill_tp``), each gathering its model slice of one
    layer's params at a time (``sharding.model_slice``; counted in the
    step's ``gathered``), computing on its heads, columns and experts (K4
    or K6 on its heads, K5 on its experts, each row bundled on its own as
    the reference bundles a prefill) and writing its heads of the cache;
    the logits come back over ``("dp", None, "vocab")``, each position's
    vocabulary rows on its device (a vocabulary the model axis does not
    divide: the first position's logits whole), an encoder-decoder's
    ``enc_out`` sharded over the batch.  Otherwise the storage-only route:
    data shard ``k``, in order, gathers every param leaf onto its device,
    prefills its rows into a cache of its own there and writes them into
    the cache's storage; the logits (or ``enc_out``) come back sharded
    over the batch as ``batch_spec`` gives it.
    """
    def one_device(params, x):
        cache = M.init_cache(cfg, x.shape[0], seq,
                             s_enc=seq if cfg.enc_dec else 0, device=x.device)
        if cfg.enc_dec:
            return M.encdec_prefill(cfg, params, x, cache)
        return M.prefill(cfg, params, x, cache)

    if mesh is None:
        return one_device
    if tp_route(cfg, mesh):
        return _tp_prefill_step(cfg, batch, seq, mesh)

    def prefill_step(params, x):
        leaves = list(_walk(params))
        cache, outs = None, []
        with use_mesh(mesh):
            for dev, lo, hi in data_shards(mesh, batch):
                out, part = one_device(_gathered(leaves, dev),
                                       x[lo:hi].to(dev))
                if cache is None:
                    cache = _cache_storage(cfg, mesh, batch,
                                           _abstract_rows(part, batch))
                for path, leaf in _walk(cache):
                    write_rows(leaf, _cache_axis(path), lo,
                               _at(part, path))
                outs.append(out)
                del part
        return _by_rows(mesh, outs, batch), cache
    return prefill_step


# the param keys of a block's FFN sub-layer (``blocks._ffn_out``'s)
_FFN_KEYS = ("ln2", "ffn", "ln2_post")


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
    """The params of one block (``M.block_walk``), whole on ``device``: its FFN
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
    for lt, keys, i in M.block_walk(cfg):
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

    With a ``mesh`` the params and the cache arrive as sharded storage;
    the cache is updated in place and returned (the reference donates
    it), the logits come back as ``make_prefill_step``'s do.  On the
    tensor-parallel route (``tp_route``) each data shard's model positions
    read their heads of its rows of the cache (a K/V head the model axis
    replicates by every position whose q heads read it), and the data
    shards' positions decode together, walking the blocks in step
    (``M.decode_step_tp``), one layer's model slices gathered at a time;
    each head of the new cache is written by the first position that
    computes it.  An MoE model's step over more than one data shard runs
    each MoE FFN on the first shard's positions over the whole batch (its
    rows moved there and back).  An encoder-decoder's step decodes every
    row at the first row's position, as ``M.decode_step``.  On the
    storage-only route data shard
    ``k``, in order, gathers every param leaf and its rows of every cache
    leaf whole onto its device, decodes them there and writes its rows of
    the new cache back into the storage shards; there an MoE model's step
    over more than one data shard bundles the whole batch for its experts
    at each MoE layer too (``_global_moe_decode``).
    """
    if mesh is None:
        def serve_step(params, cache, token, pos):
            return M.decode_step(cfg, params, cache, token, pos)
        return serve_step
    if tp_route(cfg, mesh):
        return _tp_decode_step(cfg, mesh)

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

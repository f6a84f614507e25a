"""Multi-pod dry run: every (arch × shape × mesh) cell's step, one device's
share of it costed on ``meta`` tensors, and its roofline on an H100.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA over 512 placeholder host devices and reads the compiled
program's ``cost_analysis()`` and ``memory_analysis()``.  The port has no
compiler; its sharded steps (``launch/steps.py``) compute a cell
(``parallel.tensor_parallel.tp_route``: every family, where its widths
divide the model axis) on each model position's slice, or else (a model
axis its widths do not divide) on each data shard with the params gathered
whole, the model axis sharding storage only.  So a cell here is:

* the production mesh of ``meta`` devices (``make_production_mesh``);
* one device's step, run at full size and full depth on ``meta`` tensors
  under ``cost.CostMode``: its FLOP, bytes and temp bytes are one
  device's.  On the tensor-parallel route that is one model position of
  the first data shard (``_run_tp_cell``: its model slice of one layer's
  params at a time, its rows, heads, experts and vocabulary rows, an MoE
  decode step's FFN over the global batch; the other positions' partials,
  columns and rows arrive as placeholders).  A train cell's position
  runs the forward and the backward (under remat each layer's slices
  fetched twice), each layer's slice gradients added into its storage
  shards as the backward forms them, the loss vocabulary-parallel.  Where
  the positions' shares differ (a head split over positions, K/V heads
  repeated one a q head, the first position's logits over a replicated
  vocabulary) the first position and the one with the most heads are
  costed and the larger kept; the record's ``tp_position`` names it.
  Else one data shard's step (the global batch over the data-parallel
  axes; one shard of every row where it does not divide: the batch-1
  cell).  A train cell adds AdamW's update of the first device's storage
  shards;
* argument and output bytes from the shardings: each input's and output's
  per-device shard, as the reference's ``memory_analysis`` counts them
  (a tensor-parallel cell's logits over ``("dp", None, "vocab")``).
  The host scalars (AdamW's step counter, a decode step's ``pos``) count
  4 bytes each, as the reference's int32 arguments do, though the port
  keeps them on the host;
* collective bytes from the shardings: the port's own moves onto and off
  the busiest device — each computing position's gather of the param
  bytes it does not hold (the whole leaf, or on the tensor-parallel route
  its model slice, as often as the step fetches it: twice a layer in a
  train cell under remat), the gradient reduction into the storage
  shards (train: the whole leaf's, or on the tensor-parallel route each
  position's slice's into the shards it came from, a model-replicated
  leaf's copies summed on the data shard's first position), the cache a
  decode step gathers and writes back (its rows, or its rows and heads;
  the batch-1 cell: the whole rows) and what a prefill writes into the
  cache's storage; on the tensor-parallel route
  also ``tp_reduce`` (each sub-layer's partial outputs and rwkv's sums of
  squares summed on the first model position and sent back) and
  ``tp_exchange`` (the q and K/V columns of a head split over positions),
  and for an MoE FFN ``ep_route`` (the first model position's routing
  copied to the others) and ``ep_rows`` (a decode step's rows moved onto
  the first data shard's positions and back), in a train cell the
  recompute's and the backward's too.  Every data shard's positions are
  charged the costed (first) shard's moves.

Every layer runs eagerly, so no loop body is counted once: the record's
``scan_correction`` is ``{"applied": false}``.  ``compile_s`` keeps the
reference's key and holds the seconds the costed run took (there is no
compile).  The reference's ``--save-hlo`` is not offered: there is no HLO.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k [--multi-pod] [--out runs/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from fractions import Fraction

import numpy as np
import torch

from ..configs import ARCHS, SHAPES, get_config, get_shape
from ..models import model as M
from ..models.params import _set, _walk, tree_map
from ..optim import adamw
from ..parallel import sharding as S
from ..parallel.api import resolve_spec
from ..parallel import tensor_parallel as TP
from ..parallel.tensor_parallel import (ModelGroup, head_slice, kv_index,
                                        model_size, tp_route)
from . import roofline as R
from . import steps as ST
from .cost import CostMode
from .mesh import make_production_mesh

# host scalars the port keeps off the card, counted as the reference's
# int32 arguments
HOST_SCALAR_BYTES = 4
# what a kernel does on meta tensors (kernels/_meta.py)
KERNEL_ON_META = {
    "flash_attention": "fake result, registered FLOP formula (K4)",
    "flash_attention_bwd": "fake result, registered FLOP formula (K4's "
                           "backward)",
    "moe_gemm": "fake result, registered FLOP formula (K5)",
    "moe_gemm_bwd": "fake result, registered FLOP formula (K5's backward)",
    "rwkv6": "fake result, registered FLOP formula (K6)",
    "rwkv6_bwd": "fake result, registered FLOP formula (K6's backward)"}


def cell_is_skipped(arch: str, shape_name: str):
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{arch} is pure full-attention (DESIGN.md §5 skip list)")
    return None


def _opt_cfg(cfg):
    return adamw.AdamWConfig(
        state_dtype=cfg.pdtype if cfg.param_dtype == "bfloat16"
        else torch.float32)


# ---------------------------------------------------------------------------
# Bytes from the shardings
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def shard_bytes(shape, dtype, sharding) -> int:
    """One device's shard of a leaf under ``sharding``."""
    n = math.prod(shape) // math.prod(sharding.grid(len(shape)))
    return n * _itemsize(dtype)


def _tree_shard_bytes(tree, shardings) -> int:
    total = 0
    for path, leaf in _walk(tree):
        sh = ST._at(shardings, path)
        total += shard_bytes(leaf.shape, leaf.dtype, sh)
    return total


def _stored_at(shape, dtype, sharding, block=None) -> dict:
    """Mesh position → bytes of the leaf the port stores there
    (``Sharding.positions``: each shard index on its first position; an
    all-``None`` spec whole on the first), counting only the part inside
    ``block`` (dim → ``(start, end)``) where it is given."""
    grid = sharding.grid(len(shape))
    item = _itemsize(dtype)
    per = [d // g for d, g in zip(shape, grid)]
    block = block or {}
    out: dict = {}
    for idx, pos in sharding.positions(len(shape)).items():
        n = 1
        for d, (i, p) in enumerate(zip(idx, per)):
            lo, hi = block.get(d, (0, shape[d]))
            n *= max(min((i + 1) * p, hi) - max(i * p, lo), 0)
        out[pos] = out.get(pos, 0) + n * item
    return out


def _collectives(cfg, shape, mesh, specs, pshard, cshard, group=None,
                 fetched=None) -> R.CollectiveStats:
    """The port's moves per mesh position, and those of the busiest.

    On the tensor-parallel route (``group``: the costed position's
    ``ModelGroup``) every model position of a data shard gathers its
    model slice of each leaf the step fetches, as many times as it fetches
    it (``fetched``: leaf path → whole fetches; hymba's unread ``ssm/wo_s``
    is not fetched, nor an encoder-decoder prefill's decoder weights but
    the cross K/V projections; a train cell's layers twice under remat),
    sends a train cell's slice gradients to the storage shards they came
    from (a model-replicated leaf's to its data shard's first position,
    which sends their sum on), and gathers its piece of the cache (its rows,
    its heads), and moves what ``group`` counted: ``tp_reduce`` (the partial
    outputs and the norm's sums of squares in, the sums out: the first
    model position receives and sends for all), ``tp_exchange`` (the q
    and K/V columns a head split over positions needs) and an MoE FFN's
    ``ep_route`` and ``ep_rows``; every data shard's positions are charged
    the costed (first) shard's."""
    positions = list(np.ndindex(*mesh.devices.shape))
    kinds = ("param_gather", "grad_reduce", "cache_gather", "cache_reshard")
    if group is not None:
        kinds += tuple({k: 0 for mv in group.moved for k in mv})
    moved = {pos: dict.fromkeys(kinds, 0) for pos in positions}
    batch = shape.global_batch
    shards = list(S.Sharding(mesh, S.batch_spec(mesh, batch, 0))
                  .positions(1).values())
    size = batch // len(shards)
    # (data shard, first row, model index, mesh position) of every
    # computing position
    if group is None:
        computing = [(i, i * size, 0, pos) for i, pos in enumerate(shards)]
    else:
        computing = [(i, lo, m, pos) for i, (lo, _, group_pos) in
                     enumerate(ST.tp_shards(mesh, batch))
                     for m, pos in enumerate(group_pos)]
    abstract = M.abstract_params(cfg)
    n_moves = 0
    for path, leaf in _walk(abstract):
        if fetched is not None and path not in fetched:
            continue
        sh = ST._at(pshard, path)
        want = math.prod(leaf.shape) * leaf.element_size() if group is None \
            else math.prod(S.model_slice_shape(leaf.shape, sh)) \
            * leaf.element_size()
        times = 1 if fetched is None else fetched[path]
        held = _stored_at(leaf.shape, leaf.dtype, sh)
        for _, _, _, pos in computing:
            moved[pos]["param_gather"] += int(times * (want - held.get(pos,
                                                                       0)))
            n_moves += want > held.get(pos, 0)
        if shape.kind == "train":
            # each storage shard receives its part of the gradient from
            # every computing position whose slice covers it but itself;
            # a model-replicated leaf's copies first reach their data
            # shard's first position, which alone sends the sum
            dims = S._model_dims(sh.spec, leaf.ndim)
            n = shard_bytes(leaf.shape, leaf.dtype, sh)
            senders = computing
            if group is not None and not dims:
                senders = [c for c in computing if c[2] == 0]
                for i, _, m, pos in computing:
                    if m:
                        moved[senders[i][3]]["grad_reduce"] += want
            for idx, spos in sh.positions(leaf.ndim).items():
                moved[spos]["grad_reduce"] += n * sum(
                    pos != spos for _, _, m, pos in senders
                    if group is None or not dims or idx[dims[0]] == m)
    if shape.kind != "train":
        cache = specs["cache"] if shape.kind == "decode" else M.init_cache(
            cfg, batch, shape.seq_len, s_enc=shape.seq_len if cfg.enc_dec
            else 0, device="meta")
        if cshard is None:
            cshard = S.cache_shardings(cfg, mesh, cache, batch)
        m_size = model_size(mesh)
        for path, leaf in _walk(cache):
            axis = ST._cache_axis(path)
            sh = ST._at(cshard, path)
            for _, lo, m, pos in computing:
                block = {axis: (lo, lo + size)}
                if group is not None:
                    block = ST._piece_block(cfg, m_size, m, path, lo,
                                            lo + size)
                want = math.prod(b - a for a, b in (
                    block.get(d, (0, n)) for d, n in enumerate(leaf.shape))) \
                    * leaf.element_size()
                held = _stored_at(leaf.shape, leaf.dtype, sh, block)
                n = want - held.get(pos, 0)
                n_moves += n > 0
                moved[pos]["cache_reshard"] += n
                if shape.kind == "decode":
                    moved[pos]["cache_gather"] += n
    if group is not None:
        for _, _, m, pos in computing:
            for kind, n in group.moved[m].items():
                moved[pos][kind] += n
                n_moves += n > 0
    busiest = max(positions, key=lambda p: sum(moved[p].values()))
    per_op = {k: float(v) for k, v in moved[busiest].items()}
    return R.CollectiveStats(per_op, sum(per_op.values()), n_moves, [])


# ---------------------------------------------------------------------------
# One data shard's step on meta tensors
# ---------------------------------------------------------------------------

def _rows(mesh, batch: int) -> int:
    return batch // len(ST.data_shards(mesh, batch))


def _first_storage(tree, shardings):
    """Each leaf's storage shard (or the whole leaf) at the mesh's first
    position, as a ``meta`` tensor: what AdamW updates there."""
    out: dict = {}
    for path, leaf in _walk(tree):
        sh = ST._at(shardings, path)
        per = [d // g for d, g in zip(leaf.shape, sh.grid(leaf.ndim))]
        _set(out, path, torch.empty(per, dtype=leaf.dtype, device="meta"))
    return out


def _meta_fetch(cfg, pshard, fetched=None, grads=None, anchor=None,
                first: bool = True):
    """``fetch`` for ``M.prefill_tp`` / ``decode_step_tp`` /
    ``forward_tp`` on ``meta``: model slice 0 of the subtree under
    ``keys`` (layer ``i`` of a stacked one), new tensors each call, as a
    position's gather of one layer (the lone position's, whatever ``rank``
    is asked for).  Each fetch adds its share of the leaf to
    ``fetched[path]`` (1 for a whole leaf, 1/L for one of L layers).
    With ``grads`` (the first device's storage shards, ``_first_storage``)
    each slice is ``fetched``: the backward adds its storage shard's part
    of the gradient into ``grads``; a model-replicated leaf's in float32
    on the ``first`` position (``sharding.CopyGrads``' sum of the
    positions' copies)."""
    params = M.abstract_params(cfg)

    def one(leaf, sh, i, path):
        shp = S.model_slice_shape(leaf.shape, sh)
        shp = shp if i is None else shp[1:]
        if fetched is not None:
            fetched[path] = fetched.get(path, 0) + (
                1 if i is None else Fraction(1, leaf.shape[0]))

        def get():
            return torch.empty(shp, dtype=leaf.dtype, device="meta")
        if grads is None:
            return get()
        acc = ST._at(grads, path)
        acc = acc if i is None else acc[i]
        part = tuple(slice(0, n) for n in acc.shape)
        if first and not S._model_dims(sh.spec, leaf.ndim):
            return TP.fetched(anchor, get,
                              lambda g: acc.add_(g.float()[part]))
        return TP.fetched(anchor, get, lambda g: acc.add_(g[part]))

    def fetch(keys, i, rank=None):
        sub, sh = ST._at(params, keys), ST._at(pshard, keys)
        if not isinstance(sub, dict):
            return [one(sub, sh, i, keys)]
        tree: dict = {}
        for path, leaf in _walk(sub):
            _set(tree, path, one(leaf, ST._at(sh, path), i, keys + path))
        return [tree]
    return fetch


def costed_positions(cfg, size: int) -> list:
    """The model positions whose steps the dry run costs: the first (where
    the vocabulary is replicated it alone computes the logits) and, where
    another's share of the heads is larger (a head split over positions, a
    position's q heads cut from a GQA group's middle: more q heads, or K/V
    heads repeated one a q head), the first with the largest share."""
    def share(m):
        sl = head_slice(cfg, size, m)
        idx = kv_index(cfg, sl)
        return (sl.q_heads[1] - sl.q_heads[0],
                len(idx) if idx else sl.kv_heads[1] - sl.kv_heads[0])
    best = max(range(size), key=lambda m: (share(m), -m))
    return [0] if share(best) == share(0) else [0, best]


def _train_tp_cell(cfg, specs, group, pshard, mode: CostMode, fetched,
                   rows: int) -> None:
    """A train cell's lone position (``group``) on ``meta``: its rows'
    forward (``M.forward_tp``) and the backward from its loss (from its
    last residual, on a placeholder gradient, where it computes no logits:
    a replicated vocabulary's other positions), each slice gradient added
    into the first device's storage shards, then AdamW's update of them."""
    batch = {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in specs.items()}
    opt_cfg = _opt_cfg(cfg)
    mine = _first_storage(M.abstract_params(cfg), pshard)
    state = adamw.init(opt_cfg, mine)
    anchor = torch.zeros(0, device="meta", requires_grad=True)
    grads: dict = {}
    fetch = _meta_fetch(cfg, pshard, fetched, grads, anchor,
                        first=0 in group.ranks)
    with mode:
        # the accumulators are the step's own (temp), as the slices are
        grads.update(tree_map(torch.zeros_like, mine))
        logits, aux, xs = M.forward_tp(
            cfg, group, fetch, [batch["tokens"]],
            images=[batch["images"]] if "images" in batch else None,
            frames=[batch["frames"]] if "frames" in batch else None)
        loss, _ = M.tp_loss(cfg, group, logits, aux, [batch])
        del logits, aux
        if loss is None:
            torch.autograd.backward(xs, [torch.empty_like(x) for x in xs])
        else:
            del xs
            loss.backward()
        del loss
        adamw.update(opt_cfg, grads, state, mine)


def _run_tp_cell(cfg, shape, mesh, pshard, mode: CostMode, m: int = 0,
                 fetched=None) -> ModelGroup:
    """One model position's step (model index ``m`` of the first data
    shard) on ``meta``: its slices, its rows and heads; what the other
    positions send arrives as placeholders.  An MoE decode step over
    several data shards runs its FFN over every shard's rows (the global
    batch's bundles on its experts); a train cell runs its forward and
    backward (``_train_tp_cell``).  Each leaf it fetches counts in
    ``fetched`` (``_meta_fetch``).  Returns its ``ModelGroup``."""
    size = model_size(mesh)
    rows = _rows(mesh, shape.global_batch)
    group = ModelGroup(["meta"] * size, lone=m)
    if shape.kind == "train":
        _train_tp_cell(cfg, ST.input_specs(cfg, shape), group, pshard,
                       mode, fetched, rows)
        return group
    fetch = _meta_fetch(cfg, pshard, fetched)
    s_enc = shape.seq_len if cfg.enc_dec else 0
    piece = M.init_cache_tp(cfg, size, m, rows, shape.seq_len, "meta",
                            s_enc=s_enc)
    with torch.no_grad():
        if shape.kind == "prefill":
            if cfg.enc_dec:
                x = torch.empty((rows, shape.seq_len, cfg.d_frame),
                                dtype=torch.float32, device="meta")
                run = M.encdec_prefill_tp
            else:
                x = torch.empty((rows, shape.seq_len), dtype=torch.int32,
                                device="meta")
                run = M.prefill_tp
            with mode:
                run(cfg, group, fetch, [x], [piece])
            return group
        token = torch.empty((rows, 1), dtype=torch.int32, device="meta")
        n_shards = len(ST.data_shards(mesh, shape.global_batch))
        with mode:
            M.decode_step_tp(cfg, [group], [fetch],
                             [[tree_map(torch.empty_like, piece)]], [[token]],
                             [shape.seq_len // 2], rows=[rows] * n_shards)
    return group


def _run_cell(cfg, shape, mesh, specs, pshard, mode: CostMode) -> None:
    rows = _rows(mesh, shape.global_batch)
    params = M.abstract_params(cfg)

    def gathered():
        # each data shard's whole copy of the params: temp on its device
        return tree_map(torch.empty_like, params)

    if shape.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        batch = {k: torch.empty((rows, *v.shape[1:]), dtype=v.dtype,
                                device="meta") for k, v in specs.items()}
        mine = _first_storage(params, pshard)
        state = adamw.init(opt_cfg, mine)
        with mode:
            leaves = list(_walk(gathered()))
            _, _, grads = ST._loss_and_grads(cfg, leaves, batch)
            del leaves
            acc: dict = {}
            for (path, p), g in zip(_walk(mine), grads):
                _set(acc, path, g[tuple(slice(0, n) for n in p.shape)]
                     .clone())
            del grads
            adamw.update(opt_cfg, acc, state, mine)
        return
    with torch.no_grad():
        if shape.kind == "prefill":
            arg = specs.get("tokens", specs.get("frames"))
            x = torch.empty((rows, *arg.shape[1:]), dtype=arg.dtype,
                            device="meta")
            with mode:
                ST.make_prefill_step(cfg, rows, shape.seq_len)(gathered(), x)
            return
        cache = M.init_cache(cfg, rows, shape.seq_len,
                             s_enc=shape.seq_len if cfg.enc_dec else 0,
                             device="meta")
        token = torch.empty((rows, 1), dtype=torch.int32, device="meta")
        with mode:
            ST.make_decode_step(cfg)(gathered(), tree_map(torch.empty_like,
                                                          cache),
                                     token, shape.seq_len // 2)


def cost_cell(cfg, shape, mesh) -> dict:
    """One cell on ``mesh``, for one device: ``{"cost", "memory", "coll",
    "kernels", "aten_ops", "seconds", "n_data_shards", "n_model_shards",
    "tp_position"}``."""
    specs = ST.input_specs(cfg, shape)
    pshard = S.params_shardings(cfg, mesh)
    params = M.abstract_params(cfg)
    batch = shape.global_batch
    cshard = None
    tp = tp_route(cfg, mesh)
    t0 = time.perf_counter()
    group, position, fetched = None, None, None
    if tp:
        # the largest share: of the costed positions, the one with the
        # most temporary bytes (then FLOP); the leaves the step reads are
        # those any of them fetched, as often as the most fetched each
        costed, fetched = [], {}
        for m in costed_positions(cfg, model_size(mesh)):
            mode, seen = CostMode(), {}
            g = _run_tp_cell(cfg, shape, mesh, pshard, mode, m, seen)
            run = mode.summary()
            costed.append(((run["temp_bytes"], run["flops"], -m), m, g, run))
            for path, n in seen.items():
                fetched[path] = max(fetched.get(path, 0), n)
        _, position, group, run = max(costed, key=lambda c: c[0])
    else:
        mode = CostMode()
        _run_cell(cfg, shape, mesh, specs, pshard, mode)
        run = mode.summary()
    seconds = time.perf_counter() - t0
    # the params are the step's arguments, as the reference's jitted step
    # keeps only those it reads (hymba's ``ssm/wo_s`` none; a whisper
    # decode step no encoder weight): on the tensor-parallel route the
    # leaves its positions fetch; a train step updates every leaf
    p_bytes = _tree_shard_bytes(params, pshard) \
        if fetched is None or shape.kind == "train" else \
        sum(shard_bytes(leaf.shape, leaf.dtype, ST._at(pshard, path))
            for path, leaf in _walk(params) if path in fetched)
    if shape.kind == "train":
        state = adamw.init(_opt_cfg(cfg), params)
        donated = p_bytes + HOST_SCALAR_BYTES + sum(
            _tree_shard_bytes(state[k], pshard) for k in ("m", "v"))
        args = donated + sum(
            shard_bytes(v.shape, v.dtype, S.Sharding(
                mesh, S.batch_spec(mesh, v.shape[0], v.ndim - 1)))
            for v in specs.values())
        # loss, ce, aux, grad_norm, lr: float32 scalars
        outs = donated + 5 * 4
    else:
        # float32 logits; an encoder-decoder's prefill gives enc_out
        out_shape, out_dtype = (batch, shape.seq_len if shape.kind ==
                                "prefill" else 1, cfg.vocab_size), \
            torch.float32
        if cfg.enc_dec and shape.kind == "prefill":
            out_shape, out_dtype = (batch, shape.seq_len, cfg.d_model), \
                cfg.cdtype
        logits = shard_bytes(out_shape, out_dtype, S.Sharding(
            mesh, resolve_spec(out_shape, ("dp", None, "vocab"), mesh)
            if tp else S.batch_spec(mesh, batch, 2)))
        if shape.kind == "prefill":
            arg = specs.get("tokens", specs.get("frames"))
            args = p_bytes + shard_bytes(arg.shape, arg.dtype, S.Sharding(
                mesh, S.batch_spec(mesh, batch, arg.ndim - 1)))
            cache = M.init_cache(cfg, batch, shape.seq_len,
                                 s_enc=shape.seq_len if cfg.enc_dec else 0,
                                 device="meta")
            c_bytes = _tree_shard_bytes(cache, S.cache_shardings(
                cfg, mesh, cache, batch))
            outs, donated = logits + c_bytes, 0
        else:
            _, cshard, tok_sh, _ = ST.decode_shardings(
                cfg, mesh, specs["cache"], batch)
            c_bytes = _tree_shard_bytes(specs["cache"], cshard)
            args = p_bytes + c_bytes + shard_bytes(
                specs["token"].shape, torch.int32, tok_sh) \
                + HOST_SCALAR_BYTES
            outs, donated = logits + c_bytes, c_bytes
    return {"cost": {"flops": run["flops"], "bytes accessed": run["bytes"]},
            "memory": {"argument_bytes": int(args), "output_bytes": int(outs),
                       "temp_bytes": run["temp_bytes"],
                       "alias_bytes": int(donated)},
            "coll": _collectives(cfg, shape, mesh, specs, pshard, cshard,
                                 group, fetched),
            "kernels": {k: dict(v, on_meta=KERNEL_ON_META[k])
                        for k, v in run["kernels"].items()},
            "aten_ops": run["aten_ops"], "seconds": seconds,
            "n_data_shards": len(ST.data_shards(mesh, batch)),
            "n_model_shards": model_size(mesh) if tp else 1,
            "tp_position": position}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    n_chips = mesh.devices.size
    rec = dict(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16", n_chips=n_chips)
    cell = cost_cell(cfg, shape, mesh)
    rec["compile_s"] = round(cell["seconds"], 1)
    mem = cell["memory"]
    rec["memory"] = dict(mem, total_nonaliased_gib=round(
        (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
         - mem["alias_bytes"]) / 2**30, 3))
    rec["scan_correction"] = {"applied": False}
    rec["roofline"] = R.roofline_terms(cell["cost"], cell["coll"], n_chips)
    mf, total_params = R.model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    rec["total_params"] = total_params
    # every computing position runs the costed step: one a data shard, or
    # on the tensor-parallel route each model position of each data shard
    hlo_global = cell["cost"]["flops"] * cell["n_data_shards"] \
        * cell["n_model_shards"]
    rec["model_vs_hlo_flops"] = round(mf / hlo_global, 4) if hlo_global \
        else 0
    rec["n_data_shards"] = cell["n_data_shards"]
    rec["n_model_shards"] = cell["n_model_shards"]
    # the model position whose step was costed (the first data shard's;
    # None off the tensor-parallel route)
    rec["tp_position"] = cell["tp_position"]
    rec["kernels"] = cell["kernels"]
    rec["aten_ops"] = cell["aten_ops"]
    return rec


def cells(all_cells: bool, arch=None, shape=None, multi_pod=False) -> list:
    if not all_cells:
        return [(arch, shape, multi_pod)]
    return [(a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    for arch, shape, mp in cells(args.all, args.arch, args.shape,
                                 args.multi_pod):
        tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            try:
                if json.load(open(path)).get("status") in ("ok", "skipped"):
                    print(f"[CACHED] {tag}", flush=True)
                    continue
            except Exception:
                pass
        skip = cell_is_skipped(arch, shape)
        if skip:
            rec = dict(arch=arch, shape=shape,
                       mesh="2x16x16" if mp else "16x16",
                       status="skipped", reason=skip)
            print(f"[SKIP] {tag}: {skip}", flush=True)
        else:
            try:
                rec = lower_cell(arch, shape, multi_pod=mp)
                rec["status"] = "ok"
                r = rec["roofline"]
                print(f"[OK]   {tag}: compile={rec['compile_s']}s "
                      f"mem={rec['memory']['total_nonaliased_gib']}GiB "
                      f"compute={r['t_compute_s']:.3e}s "
                      f"memory={r['t_memory_s']:.3e}s "
                      f"coll={r['t_collective_s']:.3e}s "
                      f"dom={r['dominant']} "
                      f"useful={rec['model_vs_hlo_flops']}", flush=True)
            except Exception as e:  # noqa: BLE001 — record the failure
                rec = dict(arch=arch, shape=shape,
                           mesh="2x16x16" if mp else "16x16",
                           status="failed", error=str(e)[:2000],
                           traceback=traceback.format_exc()[-4000:])
                print(f"[FAIL] {tag}: {e}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()

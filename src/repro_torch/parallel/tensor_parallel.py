"""Tensor parallelism over the mesh's ``"model"`` axis for the sharded
serving and training steps (``launch.steps``).

The reference jits its steps with the params sharded by
``params_shardings`` (``"heads"``, ``"mlp"``, ``"vocab"`` and
``"experts"`` over ``"model"``) and its logits constrained to ``("dp",
None, "vocab")``, so XLA partitions attention by heads, the FFN by columns,
an MoE FFN by experts (its bundles and expert outputs constrained to
``("dp", "experts", None, None)``: pure expert parallelism), the head and
the loss by vocabulary, and a training step's gradients as its forward.
Here one process drives every mesh position in turn (single controller)
and each model position computes on its own slice:

* ``tp_route`` picks the route from the config's family and the mesh's
  model size: decoder-only attention with a dense SwiGLU FFN (qwen3,
  gemma2, gemma3, paligemma's text path) or an MoE FFN (dbrx, kimi-k2),
  RWKV6 with its channel mix, hymba's hybrid mixer (attention and SSM
  heads side by side) and the encoder-decoder (whisper: its encoder, its
  decoder's self- and cross-attention), when the widths the reference
  shards divide the model axis (the q columns, the FFN's hidden width; an
  MoE config's experts and shared-expert columns; whole RWKV heads).  A
  model axis of one and configs whose widths do not divide keep the
  storage-only route;
* ``head_slice`` gives model position ``m`` its columns of the head
  projections and the q and K/V heads it computes (a head may be split
  over positions, and a position's q heads may start inside a GQA group:
  ``kv_index`` then gives K4 one K/V head per q head); ``expert_slice``
  the experts it holds and computes;
* ``ModelGroup`` holds one data shard's model positions: ``all_reduce``
  sums their partial outputs in float32 in a fixed order (m = 0, 1, ...)
  on the first position's device, rounds once and copies the result to
  every position (under autograd its backward is the same reduction of
  the outputs' gradients, in float32 in the same order); ``to_first``
  moves each position's tensor to the first (the vocabulary-parallel
  loss's statistics); ``columns`` hands each position the columns of an
  activation it needs from the positions that computed them (the K/V
  heads a position's q heads read where ``wk`` / ``wv`` split inside a
  head); ``share`` copies what the first position computed (an MoE FFN's
  routing: every position bundles by the same slot map) to the others;
* ``rows_to_first`` / ``rows_from_first`` move each data shard's rows of
  an activation onto the first data shard's model positions and back (a
  decode step's MoE FFN bundles the global batch, as the reference's one
  program does);
* ``vocab_lookup`` is one position's part of the vocabulary-parallel
  embedding: its rows of the table, zeros for tokens outside its range.
  Where the model axis does not divide the vocabulary the reference's
  guard replicates the table (``vocab_split`` false): every position
  looks tokens up in the whole table and the first computes the logits;
* ``fetched`` makes a param slice a training step reads from the storage
  a node of the autograd graph: its backward adds the slice's gradient
  into the storage-shaped accumulator (``sharding.add_model_slice``) once
  a layer and position, re-fetches under remat included.

A group made with ``lone`` runs one position on ``meta`` tensors (the dry
run): what the other positions would send arrives as placeholders.  Every
group counts the bytes each position sends and receives (``moved``), as
the dry run's collectives: ``tp_reduce``, ``tp_exchange``, and for an MoE
FFN ``ep_route`` (the routing's copies) and ``ep_rows`` (the rows moved
for a decode step's global bundles); under autograd the backward's moves
(the same bytes, the other way) count under the same kinds, by a hook on
the move's outputs (``charge_back``) for every kind of move.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .sharding import axis_size


def model_size(mesh) -> int:
    """The size of the mesh's ``"model"`` axis (1 without one)."""
    return axis_size(mesh, "model") if "model" in mesh.axis_names else 1


def in_scope(cfg) -> bool:
    """The families whose serving and training steps compute over
    ``"model"`` (every family of ``configs``)."""
    if cfg.enc_dec:
        return cfg.mixer == "attn" and cfg.ffn == "swiglu"
    return (cfg.mixer in ("attn", "hymba") and cfg.ffn in ("swiglu", "moe")
            ) or (cfg.mixer == "rwkv" and cfg.ffn == "rwkv_cm")


def divides(cfg, size: int) -> bool:
    """Whether ``size`` model positions split ``cfg``'s widths as the
    reference's guards shard them: the q columns and the FFN's hidden
    width; an MoE FFN's experts and its shared experts' hidden width
    (where they do not divide, the reference's guard replicates them);
    whole RWKV heads.  The K/V columns, hymba's SSM state columns and the
    vocabulary need not divide: the guard replicates them, and a position
    reads what it needs (``ModelGroup.columns``, the whole table).  Heads
    need not divide either way: a head split over positions takes the
    columns it lacks from the others, and a position whose q heads start
    inside a GQA group reads one K/V head per q head (``kv_index``)."""
    h, dh = cfg.n_heads, cfg.d_head
    if (h * dh) % size or cfg.d_ff % size:
        return False
    if cfg.ffn == "moe" and (cfg.n_experts % size or (
            cfg.d_ff_expert * cfg.n_shared_experts) % size):
        return False
    if cfg.mixer == "rwkv":
        return h % size == 0
    return True


def vocab_split(cfg, size: int) -> bool:
    """Whether the model axis splits the vocabulary (else the reference's
    guard replicates the table and the logits' vocabulary dim)."""
    return cfg.vocab_size % size == 0


def tp_route(cfg, mesh) -> bool:
    """Whether the sharded serving and training steps of ``cfg`` on
    ``mesh`` compute over the model axis (else: the storage-only route)."""
    size = model_size(mesh)
    return size > 1 and in_scope(cfg) and divides(cfg, size)


@dataclasses.dataclass(frozen=True)
class HeadSlice:
    """Model position ``m``'s share of a layer's heads: the columns of
    ``wq`` (rows of ``wo``) its model slice holds, the q heads those
    columns meet (hymba's SSM heads too), the columns of ``wk`` / ``wv``
    it holds (all of them where the guard replicates them) and the K/V
    heads its q heads read.  Each range is ``[first, end)``."""

    q_cols: Tuple[int, int]
    q_heads: Tuple[int, int]
    kv_cols: Tuple[int, int]
    kv_heads: Tuple[int, int]


def model_cols(width: int, size: int, m: int) -> Tuple[int, int]:
    """The columns ``[first, end)`` of a ``width``-column projection sharded
    over ``"model"`` that model position ``m`` of ``size`` holds: its
    ``width / size``, or all of them where the reference's guard
    replicates the projection (``width`` does not divide)."""
    if width % size:
        return 0, width
    return m * width // size, (m + 1) * width // size


def head_slice(cfg, size: int, m: int) -> HeadSlice:
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q_cols = model_cols(h * dh, size, m)
    q_heads = (q_cols[0] // dh, -(-q_cols[1] // dh))
    group = h // hkv
    kv_heads = (q_heads[0] // group, (q_heads[1] - 1) // group + 1)
    return HeadSlice(q_cols, q_heads, model_cols(hkv * dh, size, m), kv_heads)


def kv_index(cfg, sl: HeadSlice) -> Optional[List[int]]:
    """The K/V head (counted from ``sl.kv_heads[0]``) each of a position's
    q heads reads, where its q heads do not fill whole GQA groups from a
    group's first head (K4 and the decode attention then take the K/V
    heads repeated one a q head); None where they do, or where they lie in
    one group (the ratio of q to K/V heads is then an integer)."""
    group = cfg.n_heads // cfg.n_kv_heads
    (a, b), (j0, j1) = sl.q_heads, sl.kv_heads
    if j1 - j0 == 1 or (a == j0 * group and b == j1 * group):
        return None
    return [q // group - j0 for q in range(a, b)]


def expert_slice(cfg, size: int, m: int) -> Tuple[int, int]:
    """The experts ``[first, end)`` model position ``m`` of ``size`` holds
    and computes: its ``E / size`` of the ``"experts"`` dim."""
    n = cfg.n_experts // size
    return m * n, (m + 1) * n


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class ModelGroup:
    """One data shard's model positions, computing in turn.

    ``devices[m]`` is model position ``m``'s device.  Lists of per-position
    tensors follow ``ranks``: every position, or with ``lone`` only that
    one (on ``meta`` devices: the dry run's one position's step)."""

    def __init__(self, devices, lone: Optional[int] = None):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.ranks = list(range(self.size)) if lone is None else [lone]
        if lone is not None and self.devices[lone].type != "meta":
            raise ValueError("a lone position runs on meta tensors only")
        self.moved: List[Dict[str, int]] = [
            {"tp_reduce": 0, "tp_exchange": 0} for _ in self.devices]

    def count(self, r: int, kind: str, n: int) -> None:
        """Add ``n`` bytes to position ``r``'s ``kind`` of moves."""
        self.moved[r][kind] = self.moved[r].get(kind, 0) + n

    def device(self, i: int) -> torch.device:
        """The device of the ``i``-th entry of a per-position list."""
        return self.devices[self.ranks[i]]

    def charge(self, kind: str, per_rank: list) -> None:
        """Add ``per_rank[r]`` bytes to each position ``r``'s ``kind``."""
        for r, n in enumerate(per_rank):
            self.count(r, kind, n)

    def charge_back(self, kind: str, per_rank: list, outs: list) -> None:
        """Charge ``per_rank`` again when the backward reaches ``outs``
        (the transposed moves: the same bytes the other way), once; nothing
        where no output takes part in a gradient."""
        for t in outs:
            if t.requires_grad:
                t.register_hook(lambda grad: self.charge(kind, per_rank))
                return

    def _sum_first(self, parts: list) -> torch.Tensor:
        """The float32 sum, in the order m = 0, 1, ..., of every
        position's entry (``parts`` one a position of ``ranks``; a
        placeholder for the others) on the first position's device."""
        first = self.devices[0]
        by_rank = dict(zip(self.ranks, parts))
        acc = None
        for r in range(self.size):
            p = by_rank.get(r)
            p = torch.empty_like(parts[0], dtype=torch.float32) if p is None \
                else p.to(first, torch.float32)
            acc = p if acc is None else acc + p
        return acc

    def all_reduce(self, parts: list, dtype) -> list:
        """The sum of every position's partial (``parts``, one a position
        in ``ranks``) in float32, in the order m = 0, 1, ..., on the first
        position's device, rounded once to ``dtype`` and copied to each
        position's device.  The first position receives the others'
        partials and sends each the result.  Under autograd
        (``_AllReduce``) the backward sums the outputs' gradients the same
        way and sends each position the sum."""
        n = parts[0].numel()
        sent, back = n * parts[0].element_size(), n * _itemsize(dtype)
        per_rank = [(self.size - 1) * (sent + back) if r == 0
                    else sent + back for r in range(self.size)]
        self.charge("tp_reduce", per_rank)
        track = torch.is_grad_enabled() and any(p.requires_grad
                                                for p in parts)
        out = list(_AllReduce.apply(self, dtype, track, *parts))
        self.charge_back("tp_reduce", per_rank, out)
        return out

    def to_first(self, parts: list, kind: str = "tp_reduce") -> list:
        """Every position's entry of ``parts`` (one a position of
        ``ranks``) on the first position's device, in the order m = 0, 1,
        ... (placeholders for the positions a lone group does not run):
        the first receives the others'."""
        n = parts[0].numel() * parts[0].element_size()
        per_rank = [(self.size - 1) * n if r == 0 else n
                    for r in range(self.size)]
        self.charge(kind, per_rank)
        first = self.devices[0]
        by_rank = dict(zip(self.ranks, parts))
        out = [by_rank[r].to(first) if r in by_rank
               else parts[0].new_empty(parts[0].shape, device=first)
               for r in range(self.size)]
        self.charge_back(kind, per_rank, out)
        return out

    def share(self, tensors: list) -> list:
        """The first position's ``tensors`` on every position's device (a
        list a position of ``ranks``): the first sends each of the others
        a copy (``ep_route``)."""
        n = sum(t.numel() * t.element_size() for t in tensors)
        self.charge("ep_route", [(self.size - 1) * n if r == 0 else n
                                 for r in range(self.size)])
        out = [[t.to(self.device(i)) for t in tensors]
               for i in range(len(self.ranks))]
        # the backward sends the first position the gradients of the
        # copies that have one (the routing's gates)
        n = sum(t.numel() * t.element_size() for t in tensors
                if t.requires_grad)
        self.charge_back("ep_route", [(self.size - 1) * n if r == 0 else n
                                      for r in range(self.size)],
                         [t for ts in out for t in ts])
        return out

    def columns(self, pieces: list, held: list, want: list) -> list:
        """Each position's columns ``want[m]`` of an activation whose
        last dim each position ``m`` holds the columns ``held[m]`` of
        (``pieces``, one a position in ``ranks``): its own where they
        cover them, else the parts of every position's piece that meet
        them, in column order, copied onto its device."""
        lead = pieces[0].shape[:-1]
        row_bytes = lead.numel() * pieces[0].element_size()
        per_rank = [0] * self.size
        for r, (a, b) in enumerate(want):
            ha, hb = held[r]
            if ha <= a and b <= hb:
                continue
            for s, (sa, sb) in enumerate(held):
                lo, hi = max(a, sa), min(b, sb)
                if s != r and lo < hi:
                    per_rank[r] += (hi - lo) * row_bytes
                    per_rank[s] += (hi - lo) * row_bytes
        self.charge("tp_exchange", per_rank)
        by_rank = dict(zip(self.ranks, pieces))
        out = []
        for i, r in enumerate(self.ranks):
            (a, b), (ha, hb) = want[r], held[r]
            if ha <= a and b <= hb:
                out.append(by_rank[r][..., a - ha:b - ha])
                continue
            segs = []
            for s, (sa, sb) in enumerate(held):
                lo, hi = max(a, sa), min(b, sb)
                if lo >= hi:
                    continue
                p = by_rank.get(s)
                segs.append(pieces[0].new_empty((*lead, hi - lo)) if p is None
                            else p[..., lo - sa:hi - sa].to(self.device(i)))
            out.append(torch.cat(segs, dim=-1))
        if any(per_rank):
            self.charge_back("tp_exchange", per_rank, out)
        return out


class _AllReduce(torch.autograd.Function):
    """``ModelGroup.all_reduce``'s values: the sum copied to each
    position's device (with ``track`` each output a tensor of its own, as
    autograd needs); the backward is the same reduction of the outputs'
    gradients (float32, m = 0, 1, ..., on the first position) sent back to
    every partial in its dtype.  ``all_reduce`` counts both ways."""

    @staticmethod
    def forward(ctx, g, dtype, track, *parts):
        ctx.g, ctx.like = g, [(p.dtype, p.device) for p in parts]
        out = g._sum_first(parts).to(dtype)
        return tuple(out.to(g.device(i), copy=track and i > 0)
                     for i in range(len(parts)))

    @staticmethod
    def backward(ctx, *grads):
        total = ctx.g._sum_first(list(grads))
        return (None, None, None,
                *(total.to(dev, dt) for dt, dev in ctx.like))


class _Fetched(torch.autograd.Function):
    """A param slice a training step reads: ``get()`` in the forward;
    ``put(gradient)`` in the backward, which returns nothing (the slice's
    gradient goes into the accumulator, not through the graph)."""

    @staticmethod
    def forward(ctx, anchor, get, put):
        ctx.put = put
        t = get()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        ctx.put(grad)
        return None, None, None


def fetched(anchor: torch.Tensor, get, put) -> torch.Tensor:
    """``get()`` as a node of the autograd graph whose backward calls
    ``put(gradient)`` once, where the backward reaches it: under remat the
    recompute's ``get()`` runs again, its node is never differentiated.
    ``anchor`` is any tensor that requires grad (a zero-element one): a
    custom ``Function`` is recorded only where an input requires grad."""
    return _Fetched.apply(anchor, get, put)


def rows_to_first(groups: list, xss: list, rows: list) -> list:
    """Every data shard's rows of an activation, in row order, on each
    model position of the first shard's group: position ``m``'s on its
    device, from position ``m`` of each shard (``xss[k]``: group ``k``'s
    entries; ``rows[k]``: shard ``k``'s row count, for every data shard,
    where ``groups`` may hold only the first, a lone group's, the other
    shards' rows arriving as placeholders).  Counted as ``ep_rows``."""
    first = groups[0]
    out = []
    for i in range(len(first.ranks)):
        dev = first.device(i)
        segs = [xss[k][i].to(dev) if k < len(groups) else
                xss[0][i].new_empty((n, *xss[0][i].shape[1:]))
                for k, n in enumerate(rows)]
        out.append(torch.cat(segs) if len(segs) > 1 else segs[0])
    _count_rows(groups, xss[0][0], rows)
    return out


def rows_from_first(groups: list, xs: list, rows: list) -> list:
    """``rows_to_first`` undone: each data shard's rows of the first
    group's ``xs`` on its own positions' devices (``groups``' entries
    only).  Counted as ``ep_rows``."""
    out, lo = [], 0
    for k, g in enumerate(groups):
        out.append([x[lo:lo + rows[k]].to(g.device(i))
                    for i, x in enumerate(xs)])
        lo += rows[k]
    _count_rows(groups, xs[0], rows)
    return out


def _count_rows(groups: list, x: torch.Tensor, rows: list) -> None:
    """Each model position of data shard ``k > 0`` sends (or receives) its
    rows; the first shard's position receives (or sends) all of them."""
    row = x[:1].numel() * x.element_size()
    for r in range(groups[0].size):
        groups[0].count(r, "ep_rows", sum(rows[1:]) * row)
        for k, g in enumerate(groups[1:], 1):
            g.count(r, "ep_rows", rows[k] * row)


def vocab_lookup(tokens: torch.Tensor, table: torch.Tensor, lo: int,
                 dtype) -> torch.Tensor:
    """One position's part of the embedding: the rows of ``table`` (the
    vocabulary's rows ``[lo, lo + len(table))``) of the tokens in that
    range in ``dtype``, zeros for every other token.  Summed over the
    positions each token has one nonzero term, so the sum is exact."""
    idx = tokens.long() - lo
    inside = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)].to(dtype)
    return torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=dtype, device=rows.device))

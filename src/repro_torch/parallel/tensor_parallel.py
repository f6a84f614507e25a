"""Tensor parallelism over the mesh's ``"model"`` axis for the sharded
serving steps (``launch.steps``).

The reference jits its serving steps with the params sharded by
``params_shardings`` (``"heads"``, ``"mlp"`` and ``"vocab"`` over
``"model"``) and its logits constrained to ``("dp", None, "vocab")``, so
XLA partitions attention by heads, the FFN by columns and the head by
vocabulary.  Here one process drives every mesh position in turn (single
controller) and each model position computes on its own slice:

* ``tp_route`` picks the route from the config's family and the mesh's
  model size: decoder-only attention with a dense SwiGLU FFN (qwen3,
  gemma2, gemma3, paligemma's text path) and RWKV6 with its channel mix,
  when every sharded width divides the model axis.  Other families (MoE,
  hymba's hybrid mixer, the encoder-decoder) keep the storage-only route;
* ``head_slice`` gives model position ``m`` its columns of the head
  projections and the q and K/V heads it computes;
* ``ModelGroup`` holds one data shard's model positions: ``all_reduce``
  sums their partial outputs in float32 in a fixed order (m = 0, 1, ...)
  on the first position's device, rounds once and copies the result to
  every position; ``columns`` hands each position the columns of an
  activation it needs from the positions that computed them (the K/V
  heads a position's q heads read where ``wk`` / ``wv`` split inside a
  head);
* ``vocab_lookup`` is one position's part of the vocabulary-parallel
  embedding: its rows of the table, zeros for tokens outside its range.

A group made with ``lone`` runs one position on ``meta`` tensors (the dry
run): what the other positions would send arrives as placeholders.  Every
group counts the bytes each position sends and receives (``moved``), as
the dry run's ``tp_reduce`` and ``tp_exchange`` collectives.
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
    """The families whose serving steps compute over ``"model"``."""
    if cfg.enc_dec:
        return False
    return (cfg.mixer == "attn" and cfg.ffn == "swiglu") or (
        cfg.mixer == "rwkv" and cfg.ffn == "rwkv_cm")


def divides(cfg, size: int) -> bool:
    """Whether ``size`` model positions split ``cfg``'s widths: the q
    columns, the FFN's hidden width and the vocabulary; whole RWKV heads;
    a position's q heads reading whole K/V heads (or one q head a
    position, shared by several positions)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if (h * dh) % size or cfg.d_ff % size or cfg.vocab_size % size:
        return False
    if cfg.mixer == "rwkv":
        return h % size == 0
    if h % size == 0:
        per, group = h // size, h // hkv
        return per % group == 0 or group % per == 0
    return size % h == 0


def tp_route(cfg, mesh) -> bool:
    """Whether the sharded serving steps of ``cfg`` on ``mesh`` compute
    over the model axis (else: the storage-only route)."""
    size = model_size(mesh)
    return size > 1 and in_scope(cfg) and divides(cfg, size)


@dataclasses.dataclass(frozen=True)
class HeadSlice:
    """Model position ``m``'s share of a layer's heads: the columns of
    ``wq`` (rows of ``wo``) its model slice holds, the q heads those
    columns meet, the columns of ``wk`` / ``wv`` it holds (all of them
    where the guard replicates them) and the K/V heads its q heads read.
    Each range is ``[first, end)``."""

    q_cols: Tuple[int, int]
    q_heads: Tuple[int, int]
    kv_cols: Tuple[int, int]
    kv_heads: Tuple[int, int]


def head_slice(cfg, size: int, m: int) -> HeadSlice:
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qc = h * dh // size
    q_cols = (m * qc, (m + 1) * qc)
    q_heads = (q_cols[0] // dh, -(-q_cols[1] // dh))
    group = h // hkv
    kv_heads = (q_heads[0] // group, (q_heads[1] - 1) // group + 1)
    kvc = hkv * dh
    kv_cols = (m * kvc // size, (m + 1) * kvc // size) if kvc % size == 0 \
        else (0, kvc)
    return HeadSlice(q_cols, q_heads, kv_cols, kv_heads)


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

    def device(self, i: int) -> torch.device:
        """The device of the ``i``-th entry of a per-position list."""
        return self.devices[self.ranks[i]]

    def all_reduce(self, parts: list, dtype) -> list:
        """The sum of every position's partial (``parts``, one a position
        in ``ranks``) in float32, in the order m = 0, 1, ..., on the first
        position's device, rounded once to ``dtype`` and copied to each
        position's device.  The first position receives the others'
        partials and sends each the result."""
        n = parts[0].numel()
        sent, back = n * parts[0].element_size(), n * _itemsize(dtype)
        for r, mv in enumerate(self.moved):
            mv["tp_reduce"] += (self.size - 1) * (sent + back) if r == 0 \
                else sent + back
        first = self.devices[0]
        by_rank = dict(zip(self.ranks, parts))
        acc = None
        for r in range(self.size):
            p = by_rank.get(r)
            p = torch.empty_like(parts[0], dtype=torch.float32) if p is None \
                else p.to(first, torch.float32)
            acc = p if acc is None else acc + p
        out = acc.to(dtype)
        return [out.to(self.devices[r]) for r in self.ranks]

    def columns(self, pieces: list, held: list, want: list) -> list:
        """Each position's columns ``want[m]`` of an activation whose
        last dim each position ``m`` holds the columns ``held[m]`` of
        (``pieces``, one a position in ``ranks``): its own where they
        cover them, else the parts of every position's piece that meet
        them, in column order, copied onto its device."""
        lead = pieces[0].shape[:-1]
        row_bytes = lead.numel() * pieces[0].element_size()
        for r, (a, b) in enumerate(want):
            ha, hb = held[r]
            if ha <= a and b <= hb:
                continue
            for s, (sa, sb) in enumerate(held):
                lo, hi = max(a, sa), min(b, sb)
                if s != r and lo < hi:
                    self.moved[r]["tp_exchange"] += (hi - lo) * row_bytes
                    self.moved[s]["tp_exchange"] += (hi - lo) * row_bytes
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
        return out


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

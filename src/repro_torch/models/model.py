"""Model assembly: decoder-only LMs with the ``attn`` and ``hymba`` mixers.

Port of ``repro.models.model`` (the serving half).  Layers are stacked per
*pattern period* (gemma2's local + global = period 2), with any remainder
layers as explicit tail blocks, so the param and cache trees are the
reference's.  The reference scans the stack with ``lax.scan``; here a
Python loop walks its leading dimension.  ``constrain`` (sharding hints)
is dropped: there is one device.

Entry points:
  lm_metas / init_params
  forward(cfg, params, tokens)      → (logits, aux_loss)
  init_cache / prefill / decode_step
  cache_write_slot / cache_evict_slot / cache_slot_occupancy

Encoder-decoder models (whisper) and image prefixes (paligemma) raise
``NotImplementedError`` (ROADMAP queue 1 item 10), as do the blocks this
slice does not port (see ``blocks``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from . import params as P
from .blocks import (block_decode, block_forward, block_make_cache,
                     block_metas, block_prefill)
from .layers import embed_lookup, rms_norm, unembed
from .params import Meta

_LATER = "not ported yet (ROADMAP queue 1 item 10)"


def _decoder_only(cfg) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(f"encoder-decoder models are {_LATER}")
    if cfg.n_image_tokens:
        raise NotImplementedError(f"image-prefix models are {_LATER}")


# ---------------------------------------------------------------------------
# Metas and parameters
# ---------------------------------------------------------------------------

def _stack(metas: Dict, n: int) -> Dict:
    """Prepend a stacked leading dim to every Meta in the tree."""
    out = {}
    for k, v in metas.items():
        if isinstance(v, Meta):
            out[k] = Meta((n,) + v.shape, ("layers",) + v.axes, v.init,
                          v.scale, v.dtype)
        else:
            out[k] = _stack(v, n)
    return out


def lm_metas(cfg) -> Dict:
    _decoder_only(cfg)
    d = cfg.d_model
    metas: Dict = {
        "embed": Meta((cfg.vocab_size, d), ("vocab", None), scale=1.0),
        "final_norm": Meta((d,), (None,),
                           init="zeros" if cfg.gemma_style else "ones"),
    }
    if not cfg.tie_embeddings:
        metas["unembed"] = Meta((cfg.vocab_size, d), ("vocab", None),
                                scale=d ** -0.5)
    if cfg.n_periods > 0:
        period = {f"pos{i}": block_metas(cfg, lt)
                  for i, lt in enumerate(cfg.layer_pattern)}
        metas["layers"] = _stack(period, cfg.n_periods)
    for i, lt in enumerate(cfg.tail_layers):
        metas[f"tail{i}"] = block_metas(cfg, lt)
    return metas


def init_params(cfg, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from ``seed`` on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``; raises without a card)."""
    return P.init_params(lm_metas(cfg), seed, cfg.pdtype, device)


# the weights every use of which casts them to the compute dtype first
# (``dense``, ``embed_lookup``, ``unembed``); norms and biases stay as they
# are, since ``rms_norm`` widens its weight to float32
_COMPUTE_CAST = frozenset({"embed", "unembed", "wq", "wk", "wv", "wo",
                           "wr_s", "wk_s", "wv_s", "ww_s", "wo_s",
                           "w_gate", "w_up", "w_down"})


def compute_params(cfg, params: Dict, device="cuda") -> Dict:
    """``params`` on ``device`` with one compute-dtype copy of every weight
    that the model only ever uses cast to the compute dtype.

    The reference casts those weights on every call (``dense``); casting
    once at load gives the same values, and at hymba-1.5b's width (float32
    params, bfloat16 compute) saves a cast of each weight per layer call.
    Other leaves are moved to ``device`` as they are.
    """
    dev = resolve_device(device)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.to(dev, cfg.cdtype if k in _COMPUTE_CAST else v.dtype)
                for k, v in tree.items()}
    return walk(params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_in(cfg, params, tokens):
    scale = cfg.d_model ** 0.5 if cfg.gemma_style else None
    return embed_lookup(tokens, params["embed"], scale=scale,
                        compute_dtype=cfg.cdtype)


def _out_head(cfg, params, x):
    x = rms_norm(x, params["final_norm"], plus_one=cfg.gemma_style)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(x, table, cap=cfg.final_softcap)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def forward(cfg, params, tokens, *, images=None, frames=None):
    """tokens: (B, S).  Returns (logits (B, S, vocab) float32, aux_loss)."""
    _decoder_only(cfg)
    if images is not None or frames is not None:
        raise NotImplementedError(f"image and frame inputs are {_LATER}")
    x = _embed_in(cfg, params, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = 0.0
    for i in range(cfg.n_periods if "layers" in params else 0):
        layer_p = P.tree_slice(params["layers"], i)
        for j, lt in enumerate(cfg.layer_pattern):
            x, a = block_forward(cfg, lt, layer_p[f"pos{j}"], x, positions)
            aux = aux + a
    for i, lt in enumerate(cfg.tail_layers):
        x, a = block_forward(cfg, lt, params[f"tail{i}"], x, positions)
        aux = aux + a
    return _out_head(cfg, params, x), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _stack_trees(trees):
    """Per-layer dict trees → one tree with a leading layer dim."""
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict) else
            torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_cache(cfg, batch: int, max_seq: int, *, device="cuda") -> Dict:
    """Zero cache tree on ``device``: ``layers`` stacked per period (batch
    on axis 1), ``tail{i}`` blocks (batch on axis 0)."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    cache: Dict = {}
    if cfg.n_periods > 0:
        per_period = {
            f"pos{i}": block_make_cache(cfg, lt, batch, max_seq, cfg.cdtype,
                                        dev)
            for i, lt in enumerate(cfg.layer_pattern)}
        cache["layers"] = _stack_trees([per_period] * cfg.n_periods)
    for i, lt in enumerate(cfg.tail_layers):
        cache[f"tail{i}"] = block_make_cache(cfg, lt, batch, max_seq,
                                             cfg.cdtype, dev)
    return cache


def _run_stack(cfg, params, cache, x, step):
    """Apply ``step(layer_type, layer_params, x, layer_cache) → (x,
    new_layer_cache)`` over the stacked periods and the tail blocks."""
    new_cache: Dict = {}
    if "layers" in params:
        new_layers = []
        for i in range(cfg.n_periods):
            layer_p = P.tree_slice(params["layers"], i)
            layer_c = P.tree_slice(cache["layers"], i)
            new_c = {}
            for j, lt in enumerate(cfg.layer_pattern):
                key = f"pos{j}"
                x, new_c[key] = step(lt, layer_p[key], x, layer_c[key])
            new_layers.append(new_c)
        new_cache["layers"] = _stack_trees(new_layers)
    for i, lt in enumerate(cfg.tail_layers):
        key = f"tail{i}"
        x, new_cache[key] = step(lt, params[key], x, cache[key])
    return x, new_cache


def prefill(cfg, params, tokens, cache, *, images=None):
    """Forward + cache population. Returns (logits, cache)."""
    _decoder_only(cfg)
    if images is not None:
        raise NotImplementedError(f"image inputs are {_LATER}")
    x = _embed_in(cfg, params, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def step(lt, p, h, c):
        h, c, _ = block_prefill(cfg, lt, p, h, positions, c)
        return h, c
    x, new_cache = _run_stack(cfg, params, cache, x, step)
    return _out_head(cfg, params, x), new_cache


def decode_step(cfg, params, cache, token, pos):
    """token: (B, 1) int; pos: () int or per-row (B,) int.

    A scalar ``pos`` decodes the whole batch at one position (the one-shot
    batch path); a vector decodes every batch row at its own position —
    continuous batching, where each row is an independent request slot.
    Returns (logits, new_cache)."""
    _decoder_only(cfg)
    x = _embed_in(cfg, params, token)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=x.device).expand(token.shape[0])

    def step(lt, p, h, c):
        return block_decode(cfg, lt, p, h, c, pos)
    x, new_cache = _run_stack(cfg, params, cache, x, step)
    return _out_head(cfg, params, x), new_cache


# -- Slot-wise cache management (continuous batching) -----------------------
#
# The serve scheduler treats each batch row of the decode cache as an
# independent *request slot*: a new request prefills into a free row, decodes
# at its own position, and is evicted when it retires.  These helpers are the
# only code that needs to know where the batch axis sits in each cache
# subtree (axis 1 under the stacked "layers", axis 0 for tail blocks).


def _cache_batch_axis(key: str) -> int:
    return 1 if key == "layers" else 0


def _map_leaves(fn, tree, *others):
    """``fn(name, leaf, *other_leaves)`` over a dict tree and trees of the
    same keys; ``name`` is the leaf's own key (``slot_pos`` marks a
    slot→position map)."""
    return {k: _map_leaves(fn, v, *(o[k] for o in others))
            if isinstance(v, dict) else fn(k, v, *(o[k] for o in others))
            for k, v in tree.items()}


def cache_write_slot(cache, slot: int, row_cache, *, valid_upto=None):
    """Copy batch row 0 of ``row_cache`` (a batch-1 cache, e.g. from a
    per-request prefill) into batch row ``slot`` of ``cache``.

    ``valid_upto`` invalidates cache entries at positions >= it in the
    written row's slot→position maps: a prefill padded to a bucketed length
    leaves pad K/V in the cache, and marking their slots empty (-1) makes
    decode attention skip them (pure pattern surgery, no value rewrite).
    """
    out = {}
    for key, sub in cache.items():
        axis = _cache_batch_axis(key)

        def write(name, full, one, axis=axis):
            row = one.select(axis, 0).to(full.dtype)
            if valid_upto is not None and name == "slot_pos":
                row = torch.where(row >= valid_upto,
                                  torch.full_like(row, -1), row)
            full = full.clone()
            full.select(axis, slot).copy_(row)
            return full

        out[key] = _map_leaves(write, sub, row_cache[key])
    return out


def cache_evict_slot(cache, slot: int):
    """Retire batch row ``slot``: zero its K/V and recurrent state and mark
    every slot→position map entry empty (-1), so no stale KV can leak into
    the row's next occupant (the no-orphaned-slots invariant)."""
    out = {}
    for key, sub in cache.items():
        axis = _cache_batch_axis(key)

        def evict(name, leaf, axis=axis):
            leaf = leaf.clone()
            leaf.select(axis, slot).fill_(-1 if name == "slot_pos" else 0)
            return leaf

        out[key] = _map_leaves(evict, sub)
    return out


def _slot_maps(tree):
    """Every slot→position map (``slot_pos`` leaf) of a cache subtree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _slot_maps(v)
        elif k == "slot_pos":
            yield v


def cache_slot_occupancy(cache) -> np.ndarray:
    """Per-slot count of valid (position >= 0) KV entries summed over every
    attention cache in the tree — 0 for a free/evicted slot.  The serve-loop
    tests assert a drained scheduler leaves this all-zero.  (Copies the
    slot→position maps to the host.)"""
    total = None
    for key, sub in cache.items():
        axis = _cache_batch_axis(key)
        for leaf in _slot_maps(sub):
            valid = leaf.cpu().numpy() >= 0
            other = tuple(i for i in range(valid.ndim) if i != axis)
            cnt = valid.sum(axis=other)
            total = cnt if total is None else total + cnt
    return total

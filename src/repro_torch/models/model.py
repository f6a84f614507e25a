"""Model assembly: decoder-only LMs with the ``attn``, ``rwkv`` and ``hymba``
mixers and the ``swiglu``, ``moe`` and ``rwkv_cm`` FFNs, image prefixes
(paligemma) and the encoder-decoder (whisper).

Port of ``repro.models.model``.  Layers are stacked per *pattern period*
(gemma2's local + global = period 2), with any remainder layers as explicit
tail blocks, so the param and cache trees are the reference's.  An
encoder-decoder's two stacks are uniform (one ``encoder`` or ``decoder``
block a layer, no ``pos{i}`` level).  The reference scans each stack with
``lax.scan``; here a Python loop walks its leading dimension.  With
``cfg.remat`` and grad mode on, each period runs under a non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``): its activations are recomputed in the backward.
``constrain`` marks the reference's sharding hints (``parallel.api``).

Training differentiates ``loss_fn`` through the float32 params as they
are (never ``compute_params``), so every cast to the compute dtype is an
op of the graph and the gradients reach the float32 leaves.

Entry points:
  lm_metas / init_params / abstract_params / compute_params
  forward(cfg, params, tokens, images=, frames=)  → (logits, aux_loss)
  loss_fn(cfg, params, batch)                     → (loss, {ce, aux})
  init_cache / prefill / decode_step / encdec_prefill
  cache_write_slot / cache_evict_slot / cache_slot_occupancy /
  cache_slot_residue
  prefill_tp / encdec_prefill_tp / decode_step_tp (data shards' model
  positions, each on its slice: the sharded serving steps' tensor and
  expert parallelism)
  forward_tp / loss_fn_tp (one data shard's model positions: the sharded
  training step's)
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from ..parallel.api import constrain
from ..parallel.tensor_parallel import (head_slice, rows_from_first,
                                        rows_to_first, vocab_lookup,
                                        vocab_split)
from . import params as P
from .blocks import (_ffn_tp, block_decode, block_decode_mixer_tp,
                     block_decode_tp, block_forward, block_make_cache,
                     block_metas, block_prefill, block_seq_tp, cross_kv,
                     cross_kv_tp)
from .layers import (cross_entropy_loss, cross_entropy_tp, dense,
                     embed_lookup, rms_norm, unembed)
from .params import Meta


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
    d = cfg.d_model
    metas: Dict = {
        "embed": Meta((cfg.vocab_size, d), ("vocab", None), scale=1.0),
        "final_norm": Meta((d,), (None,),
                           init="zeros" if cfg.gemma_style else "ones"),
    }
    if not cfg.tie_embeddings:
        metas["unembed"] = Meta((cfg.vocab_size, d), ("vocab", None),
                                scale=d ** -0.5)
    if cfg.n_image_tokens:
        metas["img_proj"] = Meta((cfg.d_image, d), (None, "embed"))
    if cfg.enc_dec:
        metas["frame_proj"] = Meta((cfg.d_frame, d), (None, "embed"))
        metas["enc_layers"] = _stack(block_metas(cfg, "encoder"),
                                     cfg.n_enc_layers)
        metas["enc_norm"] = Meta((d,), (None,), init="ones")
        metas["layers"] = _stack(block_metas(cfg, "decoder"), cfg.n_layers)
        return metas
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


def abstract_params(cfg) -> Dict:
    """The param tree's shapes and dtypes as tensors on the ``meta``
    device (no storage)."""
    return P.abstract_params(lm_metas(cfg), cfg.pdtype)


# the weights every use of which casts them to the compute dtype first
# (``dense``, ``embed_lookup``, ``unembed``); norms and biases stay as they
# are, since ``rms_norm`` widens its weight to float32
_COMPUTE_CAST = frozenset({"embed", "unembed", "img_proj", "frame_proj",
                           "wq", "wk", "wv", "wo",
                           "wr_s", "wk_s", "wv_s", "ww_s", "wo_s",
                           "wr", "wg", "ww", "w_rcm", "w_in", "w_out",
                           "w_gate", "w_up", "w_down",
                           "shared_gate", "shared_up", "shared_down"})


def compute_params(cfg, params: Dict, device="cuda") -> Dict:
    """``params`` on ``device`` with one compute-dtype copy of every weight
    that the model only ever uses cast to the compute dtype.

    The reference casts those weights on every call (``dense``); casting
    once at load gives the same values, and at hymba-1.5b's width (float32
    params, bfloat16 compute) saves a cast of each weight per layer call.
    Other leaves are moved to ``device`` as they are: norms, biases, the
    token-shift mixes, RWKV6's ``u`` and the MoE router, which the model
    reads in float32.
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


def _image_in(cfg, params, images):
    """Precomputed patch embeddings (B, n_img, d_image) → the image prefix
    (B, n_img, d_model) in the compute dtype."""
    w = params["img_proj"]
    return dense(images.to(w.device, cfg.cdtype), w)


def _sinusoid_np(s: int, d: int) -> np.ndarray:
    """The reference's sinusoid position table (whisper), (s, d) float64."""
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def _sinusoid(s: int, d: int, dtype, device="cpu") -> torch.Tensor:
    """``_sinusoid_np`` cast to ``dtype`` from float64 on the host, as the
    reference casts it: bit-equal to its table."""
    return torch.from_numpy(_sinusoid_np(s, d)).to(dtype).to(device)


def _out_head(cfg, params, x):
    x = rms_norm(x, params["final_norm"], plus_one=cfg.gemma_style)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(x, table, cap=cfg.final_softcap)
    return constrain(logits, "dp", None, "vocab")


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _n_stacked(stacked) -> int:
    """The leading (layer) dim of a stacked tree."""
    return next(_named_leaves(stacked))[1].shape[0]


def _unstack(stacked) -> list:
    """A stacked tree as one tree per layer, each leaf a view of its layer.

    ``torch.unbind`` takes every layer at once, so the backward stacks the
    layers' gradients in one pass; indexing each layer on its own would
    have each layer's backward write a zero-filled gradient of the whole
    stack and add it in (the stack's bytes times the layer count)."""
    n = _n_stacked(stacked)
    out = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v) if isinstance(v, dict) else torch.unbind(v)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _forward_stack(cfg, stacked, x, positions, prefix: int = 0,
                   enc_out=None, pattern=None):
    """``block_forward`` over a stacked tree: per period (``pos{j}``
    subtrees cycling ``pattern``) or, for a uniform stack (an
    encoder-decoder's), ``pattern[0]`` at every layer.  Returns (x, aux)."""
    pattern = pattern or cfg.layer_pattern
    layers = _unstack(stacked)

    def period(i, x):
        layer_p = layers[i]
        if "pos0" not in layer_p:              # uniform stack (enc-dec)
            return block_forward(cfg, pattern[0], layer_p, x, positions,
                                 prefix, enc_out)
        aux = 0.0
        for j, lt in enumerate(pattern):
            x, a = block_forward(cfg, lt, layer_p[f"pos{j}"], x, positions,
                                 prefix, enc_out)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for i in range(len(layers)):
        if remat:
            # the blocks draw no random numbers: no RNG state to replay
            x, a = torch.utils.checkpoint.checkpoint(
                period, i, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = period(i, x)
        aux = aux + a
    return x, aux


def forward(cfg, params, tokens, *, images=None, frames=None):
    """tokens: (B, S); images: (B, n_img, d_image); frames: (B, S_enc,
    d_frame).  Returns (logits float32, aux_loss).

    An image-prefix model prepends the projected images and attends
    bidirectionally over them (prefix-LM); its logits cover the whole
    (prefix + text) sequence.  An encoder-decoder encodes ``frames`` and
    decodes ``tokens`` over them."""
    if cfg.enc_dec:
        return _encdec_forward(cfg, params, tokens, frames)
    x = _embed_in(cfg, params, tokens)
    prefix = 0
    if cfg.n_image_tokens and images is not None:
        x = torch.cat([_image_in(cfg, params, images), x], dim=1)
        prefix = images.shape[1]
    x = constrain(x, "dp", None, None)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = 0.0
    if "layers" in params:
        x, aux = _forward_stack(cfg, params["layers"], x, positions, prefix)
    for i, lt in enumerate(cfg.tail_layers):
        x, a = block_forward(cfg, lt, params[f"tail{i}"], x, positions,
                             prefix)
        aux = aux + a
    return _out_head(cfg, params, x), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def _encode(cfg, params, frames):
    """The encoder: projected frames plus the sinusoid table through the
    ``encoder`` stack (non-causal), then ``enc_norm``."""
    w = params["frame_proj"]
    b, s_enc, _ = frames.shape
    xe = dense(frames.to(w.device, cfg.cdtype), w)
    xe = xe + _sinusoid(s_enc, cfg.d_model, xe.dtype, xe.device)[None]
    xe, _ = _forward_stack(cfg, params["enc_layers"], xe,
                           _positions(b, s_enc, xe.device),
                           pattern=("encoder",))
    return rms_norm(xe, params["enc_norm"])


def _encdec_forward(cfg, params, tokens, frames):
    enc_out = _encode(cfg, params, frames)
    xd = _embed_in(cfg, params, tokens)
    b, s_dec = tokens.shape
    xd = xd + _sinusoid(s_dec, cfg.d_model, xd.dtype, xd.device)[None]
    xd, aux = _forward_stack(cfg, params["layers"], xd,
                             _positions(b, s_dec, xd.device),
                             enc_out=enc_out, pattern=("decoder",))
    return _out_head(cfg, params, xd), torch.as_tensor(
        aux, dtype=torch.float32, device=xd.device)


def loss_fn(cfg, params, batch):
    """batch: tokens (B, S), labels (B, S) [, images | frames], tensors on
    the params' device.  Returns ``(ce + router_aux_coef · aux, {"ce",
    "aux"})``; an image-prefix model's logits over its prefix are
    dropped before the loss."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          images=batch.get("images"),
                          frames=batch.get("frames"))
    if cfg.n_image_tokens and "images" in batch:
        logits = logits[:, batch["images"].shape[1]:]
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _stack_trees(trees):
    """Per-layer dict trees → one tree with a leading layer dim."""
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict) else
            torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_cache(cfg, batch: int, max_seq: int, *, s_enc: int = 0,
               device="cuda") -> Dict:
    """Zero cache tree on ``device``: ``layers`` stacked per period (batch
    on axis 1), ``tail{i}`` blocks (batch on axis 0).  An encoder-decoder's
    is one uniform ``layers`` stack whose decoder blocks also hold the
    cross K/V of ``s_enc`` encoder positions (``xk``, ``xv``).
    ``device="meta"`` gives the tree's shapes and dtypes with no storage
    (``launch.steps.input_specs``)."""
    dev = resolve_device(device, abstract=True)
    if cfg.enc_dec:
        c = block_make_cache(cfg, "decoder", batch, max_seq, cfg.cdtype, dev)
        shape = (batch, cfg.n_kv_heads, s_enc, cfg.d_head)
        c["xk"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        c["xv"] = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        return {"layers": _stack_trees([c] * cfg.n_layers)}
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


def _run_stack(cfg, params, cache, x, step, pattern=None):
    """Apply ``step(layer_type, layer_params, x, layer_cache) → (x,
    new_layer_cache)`` over the stacked layers (per period, or
    ``pattern[0]`` at every layer of a uniform stack) and the tail
    blocks."""
    pattern = pattern or cfg.layer_pattern
    new_cache: Dict = {}
    if "layers" in params:
        new_layers = []
        for i in range(_n_stacked(params["layers"])):
            layer_p = P.tree_slice(params["layers"], i)
            layer_c = P.tree_slice(cache["layers"], i)
            if "pos0" not in layer_p:          # uniform stack (enc-dec)
                x, new_c = step(pattern[0], layer_p, x, layer_c)
            else:
                new_c = {}
                for j, lt in enumerate(pattern):
                    key = f"pos{j}"
                    x, new_c[key] = step(lt, layer_p[key], x, layer_c[key])
            new_layers.append(new_c)
        new_cache["layers"] = _stack_trees(new_layers)
    for i, lt in enumerate(cfg.tail_layers):
        key = f"tail{i}"
        x, new_cache[key] = step(lt, params[key], x, cache[key])
    return x, new_cache


def encdec_prefill(cfg, params, frames, cache):
    """Run the encoder and build every decoder layer's cross K/V
    (whisper serving).  Returns (enc_out, cache with ``xk`` / ``xv``)."""
    enc_out = _encode(cfg, params, frames)
    xattn = params["layers"]["xattn"]
    pairs = [cross_kv(cfg, P.tree_slice(xattn, i), enc_out)
             for i in range(_n_stacked(xattn))]
    layers = dict(cache["layers"],
                  xk=torch.stack([k for k, _ in pairs]),
                  xv=torch.stack([v for _, v in pairs]))
    return enc_out, dict(cache, layers=layers)


def prefill(cfg, params, tokens, cache, *, images=None):
    """Forward + cache population. Returns (logits, cache).

    An image-prefix model prepends the projected images; as in the
    reference, attention here is causal over the whole sequence (only
    ``forward`` is prefix-LM)."""
    x = _embed_in(cfg, params, tokens)
    if cfg.n_image_tokens and images is not None:
        x = torch.cat([_image_in(cfg, params, images), x], dim=1)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def step(lt, p, h, c):
        h, c, _ = block_prefill(cfg, lt, p, h, positions, c)
        return h, c
    x, new_cache = _run_stack(cfg, params, cache, x, step)
    return _out_head(cfg, params, x), new_cache


def _decode_sinusoid(cfg, x, s_cache: int, pos: int):
    """An encoder-decoder's decode input ``x`` plus the sinusoid row at
    ``pos`` of the float64 table over the cache's ``s_cache`` positions
    (its last row past its end), cast as the reference casts it."""
    row = _sinusoid_np(s_cache, cfg.d_model)[min(pos, s_cache - 1)]
    return x + torch.from_numpy(row).to(x.dtype).to(x.device)


def decode_step(cfg, params, cache, token, pos):
    """token: (B, 1) int; pos: () int or per-row (B,) int.

    A scalar ``pos`` decodes the whole batch at one position (the one-shot
    batch path); a vector decodes every batch row at its own position —
    continuous batching, where each row is an independent request slot.
    An encoder-decoder decodes every row at the first row's position (its
    serving is one-shot only), with the sinusoid row at that position
    (the cache's last row past its end).  Returns (logits, new_cache)."""
    x = _embed_in(cfg, params, token)
    pattern = None
    if cfg.enc_dec:
        pos = int(torch.as_tensor(pos).reshape(-1)[0])
        x = _decode_sinusoid(cfg, x, cache["layers"]["k"].shape[3], pos)
        pattern = ("decoder",)
    else:
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=x.device).expand(token.shape[0])

    def step(lt, p, h, c):
        return block_decode(cfg, lt, p, h, c, pos)
    x, new_cache = _run_stack(cfg, params, cache, x, step, pattern)
    return _out_head(cfg, params, x), new_cache


# ---------------------------------------------------------------------------
# Serving over the model axis (tensor parallelism; ``launch.steps``)
# ---------------------------------------------------------------------------
#
# One data shard's model positions ``g`` (``parallel.tensor_parallel.
# ModelGroup``) prefill or decode together, each on its slice: lists hold
# one entry a position of ``g.ranks``.  ``fetch(keys, i)`` gives each
# position its slice of the params under ``keys`` (layer ``i`` of a stacked
# subtree; ``i`` None: as it is), one layer at a time; ``caches`` are the
# positions' cache pieces (``init_cache_tp``).

def block_walk(cfg) -> list:
    """The blocks of a decoder stack in ``_run_stack``'s order: ``(layer
    type, subtree keys, layer index)``, the index None for a tail block;
    an encoder-decoder's uniform stack of ``decoder`` blocks has no
    ``pos{j}`` level."""
    if cfg.enc_dec:
        return [("decoder", ("layers",), i) for i in range(cfg.n_layers)]
    out = [(lt, ("layers", f"pos{j}"), i) for i in range(cfg.n_periods)
           for j, lt in enumerate(cfg.layer_pattern)]
    return out + [(lt, (f"tail{i}",), None)
                  for i, lt in enumerate(cfg.tail_layers)]


def _cache_at(cache: Dict, keys, i) -> Dict:
    """The block cache under ``keys`` (layer ``i`` of a stacked one, as
    views)."""
    for k in keys:
        cache = cache[k]
    return cache if i is None else P.tree_slice(cache, i)


def cache_heads(cfg, size: int, m: int, name: str):
    """The heads ``[first, end)`` of the cache leaf ``name`` that model
    position ``m`` of ``size`` computes: the K/V heads its q heads read
    (``k``, ``v``; the cross K/V ``xk``, ``xv``), the recurrent heads its
    q columns meet (RWKV6's ``wkv``, hymba's ``ssm_state``); None for a
    leaf without a head dim (``slot_pos``, ``shift``, ``shift_cm``), which
    every position computes whole.  The head dim follows the batch dim."""
    if name in ("k", "v", "xk", "xv"):
        return head_slice(cfg, size, m).kv_heads
    if name in ("wkv", "ssm_state"):
        return head_slice(cfg, size, m).q_heads
    return None


def init_cache_tp(cfg, size: int, m: int, batch: int, max_seq: int,
                  device, s_enc: int = 0) -> Dict:
    """Model position ``m``'s zero cache piece: ``init_cache`` over its
    heads (``cache_heads``)."""
    sl = head_slice(cfg, size, m)
    (a, b), (j0, j1) = sl.q_heads, sl.kv_heads
    local = dataclasses.replace(cfg, n_kv_heads=j1 - j0, n_heads=b - a)
    return init_cache(local, batch, max_seq, s_enc=s_enc, device=device)


def _embed_in_tp(cfg, g, tables, tokens):
    """The embedding on each position.  Vocabulary-parallel where the
    model axis splits the vocabulary: each position's rows of the table
    for the tokens in its range, summed (exactly: one nonzero term a
    token), then gemma's scale; else every position looks its tokens up
    in the whole table (the reference's guard replicates it), no
    reduction."""
    if not vocab_split(cfg, g.size):
        return [_embed_in(cfg, {"embed": tab}, t)
                for t, tab in zip(tokens, tables)]
    n = cfg.vocab_size // g.size
    xs = g.all_reduce([vocab_lookup(t, tab, r * n, cfg.cdtype)
                       for t, tab, r in zip(tokens, tables, g.ranks)],
                      cfg.cdtype)
    if cfg.gemma_style:
        xs = [x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype,
                               device=x.device) for x in xs]
    return xs


def _out_head_tp(cfg, g, fetch, xs, embed) -> list:
    """Each position's float32 logits over its vocabulary rows (B, S,
    V / size): the final norm (replicated) and its rows of the table (the
    embedding's, ``embed``, where tied), soft-capped elementwise.  Where
    the model axis does not split the vocabulary the first position
    computes the logits over all of it from the whole table and the others
    none (None): the reference's ``("dp", None, "vocab")`` then leaves the
    vocabulary whole on the data shard's first position."""
    if not vocab_split(cfg, g.size):
        out = [None] * len(xs)
        if 0 in g.ranks:
            i = g.ranks.index(0)
            w = fetch(("final_norm",), None, rank=0)[0]
            t = embed[i] if cfg.tie_embeddings else fetch(("unembed",), None,
                                                          rank=0)[0]
            out[i] = unembed(rms_norm(xs[i], w, plus_one=cfg.gemma_style), t,
                             cap=cfg.final_softcap)
        return out
    norms = fetch(("final_norm",), None)
    tables = embed if cfg.tie_embeddings else fetch(("unembed",), None)
    return [unembed(rms_norm(x, w, plus_one=cfg.gemma_style), t,
                    cap=cfg.final_softcap)
            for x, w, t in zip(xs, norms, tables)]


class _BlockView(Mapping):
    """One position's view of a block's params (a subtree of ``metas``):
    each leaf is fetched by ``leaf(path)``, for every position at once,
    the first time a position reads it, so a leaf no step reads is never
    gathered (hymba's ``ssm/wo_s``, which no forward reads; a decode
    block's cross ``wk`` / ``wv``, read once by ``encdec_prefill_tp``)."""

    def __init__(self, leaf, metas: Dict, r: int, path: tuple = ()):
        self._leaf, self._metas, self._r, self._path = leaf, metas, r, path

    def __getitem__(self, name):
        sub, path = self._metas[name], self._path + (name,)
        if isinstance(sub, dict):
            return _BlockView(self._leaf, sub, self._r, path)
        return self._leaf(path)[self._r]

    def __iter__(self):
        return iter(self._metas)

    def __len__(self) -> int:
        return len(self._metas)


def _block_tp(cfg, fetch, layer_type, keys, i, n: int, ffn: bool = True):
    """A block's params for each of ``n`` positions (``_BlockView``s: a
    leaf is fetched when first read), its FFN's left out, and ``ffn(j)``:
    the ``j``-th position's slice of the FFN's params, fetched when called
    (None where ``ffn`` is false: another group runs it)."""
    got: Dict[tuple, list] = {}

    def leaf(path):
        if path not in got:
            got[path] = fetch(keys + path, i)
        return got[path]
    metas = {k: v for k, v in block_metas(cfg, layer_type).items()
             if k != "ffn"}
    ps = [_BlockView(leaf, metas, r) for r in range(n)]
    if not ffn:
        return ps, None
    return ps, lambda j: fetch(keys + ("ffn",), i, rank=j)[0]


def _run_stack_tp(cfg, fetch, caches, xs, step):
    """``_run_stack`` over the positions: ``step(layer_type, params, ffn,
    xs, caches) → (xs, caches)`` a block (``_block_tp``'s ``params`` and
    ``ffn``).  Returns (xs, each position's new cache)."""
    layers = [{} for _ in xs]
    new = [{} for _ in xs]
    for lt, keys, i in block_walk(cfg):
        cs = [_cache_at(c, keys, i) for c in caches]
        xs, cs = step(lt, *_block_tp(cfg, fetch, lt, keys, i, len(xs)),
                      xs, cs)
        for r, c in enumerate(cs):
            if i is None:
                new[r][keys[0]] = c
            else:
                layers[r].setdefault(i, {})[keys[1]] = c
    for r, by_index in enumerate(layers):
        if by_index:
            new[r]["layers"] = _stack_trees([by_index[i]
                                             for i in sorted(by_index)])
    return xs, new


def prefill_tp(cfg, g, fetch, tokens, caches):
    """``prefill`` over the model positions ``g``: ``tokens`` (B, S) on
    each position's device.  Returns (each position's logits over its
    vocabulary rows, or the first position's over all of it
    (``_out_head_tp``); each position's cache piece)."""
    embed = fetch(("embed",), None)
    xs = _embed_in_tp(cfg, g, embed, tokens)
    b, s, _ = xs[0].shape
    positions = [_positions(b, s, x.device) for x in xs]

    def step(lt, ps, ffn, hs, cs):
        return block_seq_tp(cfg, lt, g, ps, ffn, hs, positions, cs)[:2]
    xs, new = _run_stack_tp(cfg, fetch, caches, xs, step)
    return _out_head_tp(cfg, g, fetch, xs, embed), new


def _stack_tp(cfg, g, fetch, xs, positions, blocks, prefix: int = 0,
              enc_outs=None):
    """``block_seq_tp`` over ``blocks`` (``block_walk``'s entries, in
    order), as ``_forward_stack`` and the tail loop of ``forward``: with
    ``cfg.remat`` and grad mode on, each layer index's blocks (a period of
    the stack) under one non-reentrant checkpoint over every position.
    The fetches run inside it, so the backward fetches the slices again
    and each layer's slice gradients leave as the backward forms them.
    Returns (xs, aux)."""
    remat = cfg.remat and torch.is_grad_enabled()

    def run(period, xs):
        aux = 0.0
        for lt, keys, i in period:
            ps, ffn = _block_tp(cfg, fetch, lt, keys, i, len(xs))
            xs, _, a = block_seq_tp(cfg, lt, g, ps, ffn, xs, positions,
                                    None, prefix, enc_outs)
            aux = aux + a
        return xs, aux

    aux = 0.0
    for i, period in itertools.groupby(blocks, key=lambda b: b[2]):
        period = list(period)
        if remat and i is not None:
            # the blocks draw no random numbers: no RNG state to replay
            xs, a = torch.utils.checkpoint.checkpoint(
                run, period, xs, use_reentrant=False,
                preserve_rng_state=False)
        else:
            xs, a = run(period, xs)
        aux = aux + a
    return xs, aux


def encode_tp(cfg, g, fetch, frames) -> list:
    """``_encode`` over the model positions ``g``: ``frames`` (B, S_enc,
    d_frame) on each position's device.  ``frame_proj``, the sinusoid and
    ``enc_norm`` whole on each position; each ``encoder`` block on its
    heads (K4, non-causal) and FFN columns, one reduction a sub-layer
    (under remat one checkpoint a layer, as ``_encode``'s stack).
    Returns each position's encoder output (the same on each)."""
    ws = fetch(("frame_proj",), None)
    b, s_enc, _ = frames[0].shape
    positions = [_positions(b, s_enc, w.device) for w in ws]
    # the stack holds the only reference to its input, so each layer's
    # input is freed as the next layer's is formed
    xs, _ = _stack_tp(cfg, g, fetch, [
        x + _sinusoid(s_enc, cfg.d_model, x.dtype, x.device)[None]
        for x in (dense(f.to(w.device, cfg.cdtype), w)
                  for f, w in zip(frames, ws))], positions, [
        ("encoder", ("enc_layers",), i) for i in range(cfg.n_enc_layers)])
    return [rms_norm(x, w) for x, w in zip(xs, fetch(("enc_norm",), None))]


def encdec_prefill_tp(cfg, g, fetch, frames, caches) -> tuple:
    """``encdec_prefill`` over the model positions ``g``: the encoder
    (``encode_tp``), then each decoder layer's cross K/V heads each
    position's cross-attention reads, from its columns of that layer's
    ``xattn/wk`` and ``xattn/wv`` (``cross_kv_tp``), written into its
    cache piece.  Returns (each position's encoder output, its cache
    piece)."""
    enc = encode_tp(cfg, g, fetch, frames)
    for i in range(cfg.n_layers):
        ps = [{"wk": k, "wv": v} for k, v in zip(
            fetch(("layers", "xattn", "wk"), i),
            fetch(("layers", "xattn", "wv"), i))]
        for name, heads in zip(("xk", "xv"), cross_kv_tp(cfg, g, ps, enc)):
            for c, x in zip(caches, heads):
                c["layers"][name][i].copy_(x)
    return enc, caches


def decode_step_tp(cfg, groups, fetches, caches, tokens, pos, rows=None):
    """``decode_step`` over the model positions of one or more data shards
    (``groups``, in row order; ``fetches``, ``caches``, ``tokens`` (B_k, 1)
    and ``pos`` (() or per-row (B_k,)) one a group, each as ``prefill_tp``
    takes them for one), the groups walking the blocks in step.  An MoE
    FFN over more than one data shard bundles the global batch, as the
    reference's one program does: each shard's FFN inputs go onto the
    first shard's positions (``rows_to_first``), which run the FFN over
    every row, their experts over the whole batch's bundles, and send each
    shard its rows back; the other shards fetch no FFN params.  An
    encoder-decoder decodes every row at the first row's position (of the
    first group), with the sinusoid row at that position, as
    ``decode_step``.  ``rows``: every data shard's row count, where
    ``groups`` holds only the first (the dry run's lone position; the
    others' rows arrive as placeholders).  Each position's cache piece is
    updated in place (the step's own copy: ``launch.steps`` reads it from
    the storage and writes it back), so no second copy of it is made.
    Returns ``[(logits, caches)]`` a group, as ``prefill_tp``'s."""
    rows = rows or [t[0].shape[0] for t in tokens]
    global_ffn = cfg.ffn == "moe" and len(rows) > 1
    embeds = [f(("embed",), None) for f in fetches]
    xss = [_embed_in_tp(cfg, g, e, t)
           for g, e, t in zip(groups, embeds, tokens)]
    if cfg.enc_dec:
        at = int(torch.as_tensor(pos[0]).reshape(-1)[0])
        s_cache = caches[0][0]["layers"]["k"].shape[3]
        xss = [[_decode_sinusoid(cfg, x, s_cache, at) for x in xs]
               for xs in xss]
        pos = [at] * len(groups)
    poss = [[torch.as_tensor(p, dtype=torch.int32, device=x.device).expand(
        t.shape[0]) for x, t in zip(xs, toks)]
        for p, xs, toks in zip(pos, xss, tokens)]
    for lt, keys, i in block_walk(cfg):
        for k, g in enumerate(groups):
            cs = [_cache_at(c, keys, i) for c in caches[k]]
            ps, ffn = _block_tp(cfg, fetches[k], lt, keys, i, len(xss[k]),
                                ffn=k == 0 or not global_ffn)
            if global_ffn:
                xss[k], new = block_decode_mixer_tp(cfg, lt, g, ps, xss[k],
                                                    cs, poss[k])
            else:
                xss[k], new = block_decode_tp(cfg, lt, g, ps, ffn, xss[k],
                                              cs, poss[k])
            for c, n in zip(cs, new):
                _write_into(c, n)
            if k == 0:
                first = ps, ffn
        if global_ffn:
            xs, _, _ = _ffn_tp(cfg, groups[0], *first,
                               rows_to_first(groups, xss, rows))
            xss = rows_from_first(groups, xs, rows)
    return [(_out_head_tp(cfg, g, f, xs, e), c)
            for g, f, xs, e, c in zip(groups, fetches, xss, embeds, caches)]


def forward_tp(cfg, g, fetch, tokens, images=None, frames=None) -> tuple:
    """``forward`` over the model positions ``g``, each on its slice:
    ``tokens`` (B, S) (and ``images`` / ``frames``) on each position's
    device, ``fetch`` as ``prefill_tp`` takes it (a training step's
    differentiable: ``launch.steps``).  The embedding (vocabulary-parallel
    where the model axis divides the vocabulary), paligemma's image prefix
    (``img_proj`` whole on each position) or whisper's encoder
    (``encode_tp``), every block on each position's heads, FFN columns
    and experts (``block_seq_tp``, under remat one checkpoint a
    period), then ``_out_head_tp``.  Returns (each position's float32
    logits over its vocabulary rows, or the first's over all of it and
    None for the others; the aux loss; each position's last residual)."""
    enc = encode_tp(cfg, g, fetch, frames) if cfg.enc_dec else None
    embed = fetch(("embed",), None)
    xs = _embed_in_tp(cfg, g, embed, tokens)
    prefix = 0
    if cfg.enc_dec:
        s_dec = tokens[0].shape[1]
        xs = [x + _sinusoid(s_dec, cfg.d_model, x.dtype, x.device)[None]
              for x in xs]
    elif cfg.n_image_tokens and images is not None:
        xs = [torch.cat([_image_in(cfg, {"img_proj": w}, im), x], dim=1)
              for w, im, x in zip(fetch(("img_proj",), None), images, xs)]
        prefix = images[0].shape[1]
    b, s, _ = xs[0].shape
    positions = [_positions(b, s, x.device) for x in xs]
    xs, aux = _stack_tp(cfg, g, fetch, xs, positions, block_walk(cfg),
                        prefix, enc)
    logits = _out_head_tp(cfg, g, fetch, xs, embed)
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=g.device(0)), xs


def tp_loss(cfg, g, logits, aux, batches) -> tuple:
    """``loss_fn``'s loss from ``forward_tp``'s logits and aux:
    ``cross_entropy_tp`` where the model axis splits the vocabulary, else
    the plain loss on the first position's logits; an image-prefix model's
    prefix rows dropped first.  Returns ``(ce + router_aux_coef · aux,
    {"ce", "aux"})`` on the first position's device, or ``(None, ...)``
    for a lone position that computes no logits (the dry run's)."""
    labels = [b["labels"] for b in batches]
    if cfg.n_image_tokens and "images" in batches[0]:
        n = batches[0]["images"].shape[1]
        logits = [None if lg is None else lg[:, n:] for lg in logits]
    if vocab_split(cfg, g.size):
        ce = cross_entropy_tp(g, logits, labels)
    elif 0 in g.ranks:
        i = g.ranks.index(0)
        ce = cross_entropy_loss(logits[i], labels[i])
    else:
        return None, {"ce": None, "aux": aux}
    aux = aux.to(ce.device)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


def loss_fn_tp(cfg, g, fetch, batches) -> tuple:
    """``loss_fn`` over the model positions ``g`` of one data shard:
    ``batches`` its rows (tokens, labels [, images | frames]) on each
    position's device.  Returns ``(loss, {"ce", "aux"})`` on the first
    position's device; its backward differentiates every position's
    slice."""
    logits, aux, _ = forward_tp(cfg, g, fetch, [b["tokens"] for b in batches],
                                images=[b["images"] for b in batches]
                                if "images" in batches[0] else None,
                                frames=[b["frames"] for b in batches]
                                if "frames" in batches[0] else None)
    return tp_loss(cfg, g, logits, aux, batches)


def _write_into(cache: Dict, new: Dict) -> None:
    """A block's new cache copied into its slice of a position's piece,
    leaf by leaf (a leaf the block updated in place is that slice)."""
    for name, x in new.items():
        if x is not cache[name]:
            cache[name].copy_(x)


# -- Slot-wise cache management (continuous batching) -----------------------
#
# The serve scheduler treats each batch row of the decode cache as an
# independent *request slot*: a new request prefills into a free row, decodes
# at its own position, and is evicted when it retires.  These helpers are the
# only code that needs to know where the batch axis sits in each cache
# subtree (axis 1 under the stacked "layers", axis 0 for tail blocks).  The
# recurrent state leaves (hymba's ``ssm_state``; rwkv's ``wkv``, ``shift``
# and ``shift_cm``) sit on the same batch axis as the K/V caches.


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
    slot→position maps to the host.)  A recurrent-only family (rwkv) has no
    attention cache: all zeros, as in the reference."""
    total = None
    for key, sub in cache.items():
        axis = _cache_batch_axis(key)
        for leaf in _slot_maps(sub):
            valid = leaf.cpu().numpy() >= 0
            other = tuple(i for i in range(valid.ndim) if i != axis)
            cnt = valid.sum(axis=other)
            total = cnt if total is None else total + cnt
    if total is None:
        key = next(iter(cache))
        _, leaf = next(_named_leaves(cache[key]))
        total = np.zeros(leaf.shape[_cache_batch_axis(key)], dtype=np.int64)
    return total


def cache_slot_residue(cache) -> np.ndarray:
    """Per-slot count of nonzero entries in every K/V and recurrent-state
    leaf (``wkv``, ``shift``, ``shift_cm``, ``ssm_state``; every leaf but
    the slot→position maps) — 0 right after ``cache_evict_slot``.  Unlike
    ``cache_slot_occupancy`` it sees a recurrent-only cache's state.  An
    idle row decodes a dummy token, so its recurrent state may be nonzero
    again later: read this at eviction, not after a drain."""
    total = 0
    for key, sub in cache.items():
        axis = _cache_batch_axis(key)
        for name, leaf in _named_leaves(sub):
            if name != "slot_pos":
                nz = (leaf != 0).movedim(axis, 0)
                total = total + nz.reshape(nz.shape[0], -1).sum(1)
    return total.cpu().numpy()


def _named_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v)
        else:
            yield k, v


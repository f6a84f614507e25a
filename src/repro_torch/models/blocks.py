"""Transformer-block assembly for the ``attn``, ``rwkv`` and ``hymba`` mixers
with the ``swiglu``, ``moe`` and ``rwkv_cm`` FFNs, prefix-LM attention
(paligemma) and the ``encoder`` / ``decoder`` blocks of an encoder-decoder
(whisper: the decoder's cross-attention sub-layer).

Port of ``repro.models.blocks``.  A block = mixer + ffn with pre-norms
(and gemma-style post-norms).  Every block provides three entry points
with identical parameters:

  * ``block_forward`` — full-sequence (prefill math)
  * ``block_prefill`` — forward + emit decode cache
  * ``block_decode``  — single token with cache

and their counterparts over a data shard's model positions (``*_tp``:
tensor and expert parallelism; ``block_seq_tp`` both the prefill's and
the training step's).

Param declarations (Meta) live beside the compute so shapes cannot drift;
the param tree equals the reference's key for key and shape for shape
(hymba's unused ``wo_s`` included).  On the card, attention over a
sequence goes through kernel K4, the RWKV6 WKV and hymba's SSM heads
through kernel K6, and the MoE FFN's expert products through kernel K5
(``moe.moe_ffn``).  Prefix-LM attention and cross-attention are plain
masked products in float32, as in the reference, which computes them
outside any kernel.

Caches are updated functionally, as in the reference: each entry point
returns new cache tensors and leaves its inputs unchanged.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..parallel.tensor_parallel import (expert_slice, head_slice, kv_index,
                                        model_cols)
from .attention import NEG_INF, AttnSpec, decode_attention, flash_attention
from .layers import (dense, dense_partial, grad_fence, rms_norm, rotary,
                     sum_squares, swiglu, swiglu_hidden)
from .moe import moe_ffn, moe_ffn_ep, moe_route
from .params import Meta
from .ssm import rwkv6_chunked, rwkv6_decode_step


# ---------------------------------------------------------------------------
# Meta declarations
# ---------------------------------------------------------------------------

def _attn_metas(cfg) -> Dict[str, Meta]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    m = {
        "wq": Meta((d, h * dh), ("embed", "heads")),
        "wk": Meta((d, hkv * dh), ("embed", "heads")),
        "wv": Meta((d, hkv * dh), ("embed", "heads")),
        "wo": Meta((h * dh, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        m["q_norm"] = Meta((dh,), (None,), init="ones")
        m["k_norm"] = Meta((dh,), (None,), init="ones")
    return m


def _ssm_metas(cfg) -> Dict[str, Meta]:
    """Hymba-style SSM heads: state=ssm_state per head, value=d_head."""
    d, h, dh, s = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.ssm_state
    return {
        "wr_s": Meta((d, h * s), ("embed", "heads")),
        "wk_s": Meta((d, h * s), ("embed", "heads")),
        "wv_s": Meta((d, h * dh), ("embed", "heads")),
        "ww_s": Meta((d, h * s), ("embed", "heads")),
        "wb_s": Meta((h * s,), (None,), init="zeros"),
        "wo_s": Meta((h * dh, d), ("heads", "embed")),
        "norm_a": Meta((h * dh,), (None,), init="ones"),
        "norm_s": Meta((h * dh,), (None,), init="ones"),
    }


def _rwkv_metas(cfg) -> Dict[str, Meta]:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "mu_r": Meta((d,), (None,), init="zeros"),
        "mu_k": Meta((d,), (None,), init="zeros"),
        "mu_v": Meta((d,), (None,), init="zeros"),
        "mu_w": Meta((d,), (None,), init="zeros"),
        "mu_g": Meta((d,), (None,), init="zeros"),
        "wr": Meta((d, h * dh), ("embed", "heads")),
        "wk": Meta((d, h * dh), ("embed", "heads")),
        "wv": Meta((d, h * dh), ("embed", "heads")),
        "ww": Meta((d, h * dh), ("embed", "heads"), scale=0.01),
        "w_bias": Meta((h * dh,), (None,), init="zeros"),
        "wg": Meta((d, h * dh), ("embed", "heads")),
        "u": Meta((h, dh), (None, None), scale=0.5),
        "wo": Meta((h * dh, d), ("heads", "embed")),
        "out_norm": Meta((h * dh,), (None,), init="ones"),
    }


def _ffn_metas(cfg) -> Dict[str, Meta]:
    d = cfg.d_model
    if cfg.ffn == "moe":
        e, dff = cfg.n_experts, cfg.d_ff_expert
        m = {
            "router": Meta((d, e), ("embed", None), scale=0.02),
            "w_gate": Meta((e, d, dff), ("experts", "embed", None)),
            "w_up": Meta((e, d, dff), ("experts", "embed", None)),
            "w_down": Meta((e, dff, d), ("experts", None, "embed")),
        }
        if cfg.n_shared_experts:
            sdff = dff * cfg.n_shared_experts
            m.update({
                "shared_gate": Meta((d, sdff), ("embed", "mlp")),
                "shared_up": Meta((d, sdff), ("embed", "mlp")),
                "shared_down": Meta((sdff, d), ("mlp", "embed")),
            })
        return m
    if cfg.ffn == "rwkv_cm":
        return {
            "mu_cm": Meta((cfg.d_model,), (None,), init="zeros"),
            "w_rcm": Meta((d, d), ("embed", "embed2")),
            "w_in": Meta((d, cfg.d_ff), ("embed", "mlp")),
            "w_out": Meta((cfg.d_ff, d), ("mlp", "embed")),
        }
    return {
        "w_gate": Meta((d, cfg.d_ff), ("embed", "mlp")),
        "w_up": Meta((d, cfg.d_ff), ("embed", "mlp")),
        "w_down": Meta((cfg.d_ff, d), ("mlp", "embed")),
    }


def block_metas(cfg, layer_type: str) -> Dict:
    d = cfg.d_model
    m = {"ln1": Meta((d,), (None,), init="zeros" if cfg.gemma_style else "ones"),
         "ln2": Meta((d,), (None,), init="zeros" if cfg.gemma_style else "ones")}
    if cfg.post_norm:
        m["ln1_post"] = Meta((d,), (None,),
                             init="zeros" if cfg.gemma_style else "ones")
        m["ln2_post"] = Meta((d,), (None,),
                             init="zeros" if cfg.gemma_style else "ones")
    if cfg.mixer == "attn":
        m["attn"] = _attn_metas(cfg)
    elif cfg.mixer == "rwkv":
        m["rwkv"] = _rwkv_metas(cfg)
    elif cfg.mixer == "hymba":
        m["attn"] = _attn_metas(cfg)
        m["ssm"] = _ssm_metas(cfg)
    if layer_type == "decoder":       # enc-dec: cross-attention sub-layer
        m["xattn"] = _attn_metas(cfg)
        m["lnx"] = Meta((d,), (None,), init="ones")
    m["ffn"] = _ffn_metas(cfg)
    return m


# ---------------------------------------------------------------------------
# Mixer: attention
# ---------------------------------------------------------------------------

def _attn_spec(cfg, layer_type: str) -> AttnSpec:
    window = cfg.window if layer_type == "local" else 0
    causal = layer_type != "encoder"
    return AttnSpec(causal=causal, window=window, softcap=cfg.attn_softcap,
                    scale=cfg.d_head ** -0.5)


def _theta(cfg, layer_type: str) -> float:
    if layer_type == "local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _qkv_cols(p, x):
    """The q, k and v projections of x, flat: (B, S, columns) each."""
    return dense(x, p["wq"]), dense(x, p["wk"]), dense(x, p["wv"])


def _heads(cfg, p, q, k, v, positions, layer_type, rope: bool):
    """Flat projections (B, S, heads·D) → heads: qk-norm, then the
    rotation at ``positions`` (B, S) where ``rope``.  Returns (B, H, S, D),
    (B, Hkv, S, D); the head counts are the columns'."""
    b, s, _ = q.shape
    dh = cfg.d_head
    q, k, v = (z.reshape(b, s, -1, dh) for z in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    if rope:
        theta = _theta(cfg, layer_type)
        q = rotary(q, positions[:, None, :], theta=theta)
        k = rotary(k, positions[:, None, :], theta=theta)
    return q, k, v.transpose(1, 2)


def _qkv(cfg, p, x, positions, layer_type):
    return _heads(cfg, p, *_qkv_cols(p, x), positions, layer_type,
                  cfg.use_rope)    # (B, H, S, D), (B, Hkv, S, D)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) → (B, S, H·D)."""
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh)


def attn_forward(cfg, p, x, positions, layer_type, prefix: int = 0):
    q, k, v = _qkv(cfg, p, x, positions, layer_type)
    spec = _attn_spec(cfg, layer_type)
    if cfg.prefix_lm and prefix > 0:
        out = _prefix_attention(q, k, v, spec, prefix)
    else:
        out = flash_attention(q, k, v, spec)
    return dense(_merge_heads(out), p["wo"])


def _masked_attention(q, k, v, scale: float, mask=None):
    """Plain attention in float32 over unequal q and kv lengths; ``mask``
    (S_q, S_kv) bool marks the visible pairs (None: all)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=q.device))
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", pr, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def _prefix_attention(q, k, v, spec: AttnSpec, prefix: int):
    """Prefix-LM (paligemma): bidirectional over the first ``prefix``
    positions, causal elsewhere.  Plain masked attention, as in the
    reference, which also ignores ``spec.softcap`` and ``spec.window``
    here."""
    s, d = q.shape[2], q.shape[3]
    scale = spec.scale if spec.scale is not None else d ** -0.5
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix)
    return _masked_attention(q, k, v, scale, mask)


def attn_make_cache(cfg, layer_type, batch, max_seq, dtype, device):
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    s_cache = min(cfg.window, max_seq) if (
        layer_type == "local" and cfg.window) else max_seq
    return {
        "k": torch.zeros((batch, hkv, s_cache, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, hkv, s_cache, dh), dtype=dtype,
                         device=device),
        # per-row slot→position map: serve slots are independent requests
        # at independent positions (continuous batching), so validity is
        # tracked per batch row, not per cache
        "slot_pos": torch.full((batch, s_cache), -1, dtype=torch.int32,
                               device=device),
    }


def _fill_cache(cache, k, v, positions):
    """The prefill's cache: the whole sequence when it fits, else the last
    ``s_cache`` positions at ring slots ``pos % s_cache``."""
    s = k.shape[2]
    s_cache = cache["k"].shape[2]
    kc, vc = cache["k"].clone(), cache["v"].clone()
    slot_pos = cache["slot_pos"].clone()
    positions = positions.to(torch.int32)
    if s_cache >= s:
        kc[:, :, :s] = k
        vc[:, :, :s] = v
        slot_pos[:, :s] = positions
    else:      # ring: keep the last s_cache tokens, slot = pos % s_cache
        tail = s - s_cache
        pos_t = positions[:, tail:]
        slot = torch.remainder(pos_t, s_cache).long()       # (B, s_cache)
        for row in range(k.shape[0]):
            kc[row, :, slot[row]] = k[row, :, tail:]
            vc[row, :, slot[row]] = v[row, :, tail:]
            slot_pos[row, slot[row]] = pos_t[row]
    return {"k": kc, "v": vc, "slot_pos": slot_pos}


def attn_prefill(cfg, p, x, positions, layer_type, cache):
    """Forward + populate cache (last ``s_cache`` positions for ring)."""
    q, k, v = _qkv(cfg, p, x, positions, layer_type)
    out = flash_attention(q, k, v, _attn_spec(cfg, layer_type))
    return dense(_merge_heads(out), p["wo"]), _fill_cache(cache, k, v,
                                                          positions)


def _decode_pos_vec(pos, b: int, device) -> torch.Tensor:
    """Normalize a decode position — () scalar or per-row (B,) — to (B,)
    int32.  Scalar callers (one-shot batch decode) broadcast; the
    continuous-batching scheduler passes a vector (slots decode at
    independent positions)."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(b)


def _cache_token_write(cache, k, v, pos, in_place: bool = False):
    """Write this step's K/V at each row's slot (``pos % s_cache``, the
    ring discipline; Python's modulo, so an idle row at position -1 writes
    slot ``s_cache - 1``) and stamp the per-row slot→position map, into
    copies of the cache's tensors (into them with ``in_place``).

    k/v: (B, Hkv, 1, D); pos: (B,) int32.  Returns (kc, vc, slot_pos).
    """
    b = k.shape[0]
    s_cache = cache["k"].shape[2]
    slot = torch.remainder(pos, s_cache).long()             # (B,)
    rows = torch.arange(b, device=k.device)
    kc, vc, slot_pos = (cache[n] if in_place else cache[n].clone()
                        for n in ("k", "v", "slot_pos"))
    kc[rows, :, slot] = k[:, :, 0]
    vc[rows, :, slot] = v[:, :, 0]
    slot_pos[rows, slot] = pos
    return kc, vc, slot_pos


def _attn_decode_heads(cfg, p, x_t, cache, pos, layer_type):
    """attn_decode without the output projection (returns flat heads)."""
    pos = _decode_pos_vec(pos, x_t.shape[0], x_t.device)
    return _decode_attend(cfg, p, *_qkv_cols(p, x_t), cache, pos,
                          layer_type)


def _decode_attend(cfg, p, q, k, v, cache, pos, layer_type,
                   in_place: bool = False, kv_index=None):
    """One token's flat projections (B, 1, columns) attended against the
    cache at per-row ``pos`` (B,), after this step's K/V are written (the
    rotation applied whatever ``use_rope`` says, as in the reference; into
    the cache's own tensors with ``in_place``).  ``kv_index``: the K/V
    head each q head reads, where the heads are not whole GQA groups (the
    cache stays one entry a K/V head; the attention reads them repeated).
    Returns (flat heads, the attention's new cache)."""
    q, k, v = _heads(cfg, p, q, k, v, pos[:, None], layer_type, True)
    kc, vc, slot_pos = _cache_token_write(cache, k, v, pos, in_place)
    ka, va = _expand_kv(kc, vc, kv_index)
    out = decode_attention(q, ka, va, slot_pos, pos,
                           _attn_spec(cfg, layer_type))
    return _merge_heads(out), {"k": kc, "v": vc, "slot_pos": slot_pos}


def _expand_kv(k, v, kv_index):
    """K/V heads (B, Hkv, S, D) repeated to one a q head by ``kv_index``
    (None: as they are)."""
    if kv_index is None:
        return k, v
    idx = torch.as_tensor(kv_index, dtype=torch.long, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


def attn_decode(cfg, p, x_t, cache, pos, layer_type):
    """x_t: (B, 1, d); cache k/v: (B, Hkv, S_cache, D); pos: () or (B,)."""
    out, new_cache = _attn_decode_heads(cfg, p, x_t, cache, pos, layer_type)
    return dense(out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec / whisper)
# ---------------------------------------------------------------------------

def cross_kv(cfg, p, enc_out):
    """The encoder output (B, S_enc, d) projected by a cross-attention's
    ``wk`` and ``wv`` to kv heads: two (B, Hkv, S_enc, D)."""
    b, s_enc, _ = enc_out.shape

    def heads(w):
        return dense(enc_out, w).reshape(b, s_enc, cfg.n_kv_heads,
                                         cfg.d_head).transpose(1, 2)
    return heads(p["wk"]), heads(p["wv"])


def cross_attn_forward(cfg, p, h, enc_out):
    """h: (B, S_dec, d); enc_out: (B, S_enc, d).  Full (unmasked)
    attention of every decoder position over the encoder's."""
    b, s, _ = h.shape
    q = dense(h, p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(
        1, 2)
    k, v = cross_kv(cfg, p, enc_out)
    out = _masked_attention(q, k, v, cfg.d_head ** -0.5)
    return dense(_merge_heads(out), p["wo"])


def cross_attn_decode(cfg, p, x_t, xk, xv):
    """x_t: (B, 1, d); xk / xv: the encoder's K/V (B, Hkv, S_enc, D), built
    once by ``encdec_prefill``."""
    b = x_t.shape[0]
    q = dense(x_t, p["wq"]).reshape(b, 1, cfg.n_heads,
                                    cfg.d_head).transpose(1, 2)
    spec = AttnSpec(causal=False, window=0, softcap=0.0,
                    scale=cfg.d_head ** -0.5)
    s_enc = xk.shape[2]
    slot_pos = torch.arange(s_enc, dtype=torch.int32, device=x_t.device)
    out = decode_attention(q, xk, xv, slot_pos, s_enc, spec)
    return dense(_merge_heads(out), p["wo"])


# ---------------------------------------------------------------------------
# Mixer: RWKV6
# ---------------------------------------------------------------------------

def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _shift_tokens(x: torch.Tensor) -> torch.Tensor:
    """Each position's previous token, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rwkv_project(cfg, p, x, x_prev):
    """r, k, v, w as (B, H, S, D) heads and the gate g flat; H is the
    columns' head count (a tensor-parallel position's own heads)."""
    b, s, d = x.shape
    dh = cfg.d_head
    r = dense(_lerp(x, x_prev, p["mu_r"]), p["wr"])
    k = dense(_lerp(x, x_prev, p["mu_k"]), p["wk"])
    v = dense(_lerp(x, x_prev, p["mu_v"]), p["wv"])
    g = dense(_lerp(x, x_prev, p["mu_g"]), p["wg"])
    wraw = dense(_lerp(x, x_prev, p["mu_w"]), p["ww"]) + p["w_bias"].to(
        x.dtype)
    # decay in (0,1): exp(-softplus(-wraw)-0.5) keeps a useful dynamic range
    w = torch.exp(-torch.exp(wraw.float() - 0.5))
    w = torch.clamp(w, 1e-6, 1 - 1e-6)

    def heads(z):
        return z.reshape(b, s, -1, dh).transpose(1, 2)
    return heads(r), heads(k), heads(v), heads(w), g


def _rwkv_scan(cfg, p, x, x_prev):
    """The WKV over a sequence (K6): (o flat in x's dtype, the gate g,
    the final state)."""
    r, k, v, w, g = _rwkv_project(cfg, p, x, x_prev)
    o, wkv_state = rwkv6_chunked(r, k, v, w, p["u"],
                                 chunk=min(64, x.shape[1]))
    return _merge_heads(o).to(x.dtype), g, wkv_state


def rwkv_forward(cfg, p, x, state_in=None):
    """x: (B, S, d). Returns (out, {"wkv": final state, "shift": last x}).

    As in the reference, the WKV state starts from zero; ``state_in``
    supplies only the token shift's first previous token."""
    x_prev = _shift_tokens(x)
    if state_in is not None:
        x_prev[:, 0] = state_in["shift"].to(x.dtype)
    o, g, wkv_state = _rwkv_scan(cfg, p, x, x_prev)
    o = rms_norm(o, p["out_norm"])
    o = o * torch.nn.functional.silu(g)
    return dense(o, p["wo"]), {"wkv": wkv_state, "shift": x[:, -1]}


def rwkv_make_cache(cfg, batch, dtype, device):
    h, dh = cfg.n_heads, cfg.d_head
    return {"wkv": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                               device=device),
            "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                 device=device),
            "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}


def _rwkv_step(cfg, p, x, wkv_cache, shift):
    """One token's WKV x (B, d) after the cached ``shift``: (o (B, H·D)
    in x's dtype, the gate g (B, H·D), the new state)."""
    b = x.shape[0]
    x_prev = shift.to(x.dtype)
    r, k, v, w, g = _rwkv_project(cfg, p, x[:, None, :], x_prev[:, None, :])
    o, state = rwkv6_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 w[:, :, 0], p["u"], wkv_cache)
    return o.reshape(b, -1).to(x.dtype), g[:, 0], state


def rwkv_decode(cfg, p, x_t, cache):
    """x_t: (B, 1, d)."""
    x = x_t[:, 0]
    o, g, state = _rwkv_step(cfg, p, x, cache["wkv"], cache["shift"])
    o = rms_norm(o, p["out_norm"]) * torch.nn.functional.silu(g)
    out = dense(o, p["wo"])[:, None, :]
    return out, {"wkv": state, "shift": x, "shift_cm": cache["shift_cm"]}


def _cm_in(p, x, x_prev):
    """The channel mix's receptance gate (``w_rcm`` whole) and hidden
    activation (its columns of ``w_in``)."""
    xk = _lerp(x, x_prev, p["mu_cm"])
    rgate = torch.sigmoid(dense(xk, p["w_rcm"]))
    return rgate, torch.square(torch.relu(dense(xk, p["w_in"])))


def rwkv_channel_mix(cfg, p, x, x_prev):
    rgate, hidden = _cm_in(p, x, x_prev)
    return rgate * dense(hidden, p["w_out"])


# ---------------------------------------------------------------------------
# Mixer: Hymba (parallel attention + SSM heads)
# ---------------------------------------------------------------------------

def _ssm_project(cfg, p, x):
    b, s, d = x.shape
    h, dh, st = cfg.n_heads, cfg.d_head, cfg.ssm_state
    r = dense(x, p["wr_s"]).reshape(b, s, h, st).transpose(1, 2)
    k = dense(x, p["wk_s"]).reshape(b, s, h, st).transpose(1, 2)
    v = dense(x, p["wv_s"]).reshape(b, s, h, dh).transpose(1, 2)
    wraw = dense(x, p["ww_s"]) + p["wb_s"].to(x.dtype)
    w = torch.exp(-torch.exp(wraw.float() - 0.5))
    w = torch.clamp(w, 1e-6, 1 - 1e-6)
    w = w.reshape(b, s, h, st).transpose(1, 2)
    return r, k, v, w


def _hymba_mix(cfg, p, x, a):
    """The SSM branch beside attention heads ``a`` (B, S, H·D), the
    normalize-and-average fusion (Hymba §3) and the output projection.
    Returns (out, final SSM state)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r, ks, vs, w = _ssm_project(cfg, p["ssm"], x)
    u0 = torch.zeros((h, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    o, state = rwkv6_chunked(r, ks, vs, w, u0, chunk=min(64, s))
    o = _merge_heads(o).to(x.dtype)
    fused = 0.5 * (rms_norm(a, p["ssm"]["norm_a"])
                   + rms_norm(o, p["ssm"]["norm_s"]))
    return dense(fused, p["attn"]["wo"]), state


def hymba_forward(cfg, p, x, positions, layer_type):
    q, k, v = _qkv(cfg, p["attn"], x, positions, layer_type)
    a = _merge_heads(flash_attention(q, k, v, _attn_spec(cfg, layer_type)))
    out, _ = _hymba_mix(cfg, p, x, a)
    return out


def hymba_prefill(cfg, p, x, positions, layer_type, cache):
    """hymba_forward + the decode cache.  The reference runs the attention
    a second time inside ``attn_prefill`` for the cache and discards its
    output; the cache is filled here from the k and v already computed, so
    K4 runs once per layer (the same cache and output)."""
    q, k, v = _qkv(cfg, p["attn"], x, positions, layer_type)
    a = _merge_heads(flash_attention(q, k, v, _attn_spec(cfg, layer_type)))
    out, ssm_state = _hymba_mix(cfg, p, x, a)
    new_cache = _fill_cache(cache, k, v, positions)
    new_cache["ssm_state"] = ssm_state
    return out, new_cache


def hymba_make_cache(cfg, layer_type, batch, max_seq, dtype, device):
    c = attn_make_cache(cfg, layer_type, batch, max_seq, dtype, device)
    c["ssm_state"] = torch.zeros(
        (batch, cfg.n_heads, cfg.ssm_state, cfg.d_head), dtype=torch.float32,
        device=device)
    return c


def hymba_decode(cfg, p, x_t, cache, pos, layer_type):
    b = x_t.shape[0]
    h, dh = cfg.n_heads, cfg.d_head
    a, attn_cache = _attn_decode_heads(cfg, p["attn"], x_t, cache, pos,
                                       layer_type)
    r, ks, vs, w = _ssm_project(cfg, p["ssm"], x_t)
    u0 = torch.zeros((h, cfg.ssm_state), dtype=torch.float32,
                     device=x_t.device)
    o, state = rwkv6_decode_step(r[:, :, 0], ks[:, :, 0], vs[:, :, 0],
                                 w[:, :, 0], u0, cache["ssm_state"])
    o = o.reshape(b, 1, h * dh).to(x_t.dtype)
    fused = 0.5 * (rms_norm(a, p["ssm"]["norm_a"])
                   + rms_norm(o, p["ssm"]["norm_s"]))
    out = dense(fused, p["attn"]["wo"])
    new_cache = dict(attn_cache)
    new_cache["ssm_state"] = state
    return out, new_cache


# ---------------------------------------------------------------------------
# Block assembly
# ---------------------------------------------------------------------------

def _norm(cfg, x, w):
    return rms_norm(x, w, plus_one=cfg.gemma_style)


def _apply_ffn(cfg, p, x, x_prev_for_cm=None):
    """Returns (out, aux_loss)."""
    if cfg.ffn == "moe":
        return moe_ffn(x, p, n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor)
    if cfg.ffn == "rwkv_cm":
        return rwkv_channel_mix(cfg, p, x, x_prev_for_cm), 0.0
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _mixer_out(cfg, p, mixed, x):
    if cfg.post_norm:
        mixed = _norm(cfg, mixed, p["ln1_post"])
    return x + mixed


def _ffn_out(cfg, p, x, cm_prev=None):
    """The FFN sub-layer.  ``cm_prev`` is the channel mix's previous token
    at decode (the cached ``shift_cm``); over a sequence it is each
    position's predecessor.  Returns (x, aux_loss, the FFN's input)."""
    h2 = _norm(cfg, x, p["ln2"])
    if cfg.ffn == "rwkv_cm" and cm_prev is None:
        cm_prev = _shift_tokens(h2)
    out, aux = _apply_ffn(cfg, p["ffn"], h2, cm_prev)
    if cfg.post_norm:
        out = _norm(cfg, out, p["ln2_post"])
    return x + out, aux, h2


def block_forward(cfg, layer_type, p, x, positions, prefix: int = 0,
                  enc_out=None):
    """Full-sequence block; a ``decoder`` block given ``enc_out`` attends
    over it after its mixer. Returns (x, aux_loss)."""
    h = grad_fence(_norm(cfg, x, p["ln1"]))
    if cfg.mixer == "attn":
        mixed = attn_forward(cfg, p["attn"], h, positions, layer_type, prefix)
    elif cfg.mixer == "rwkv":
        mixed, _ = rwkv_forward(cfg, p["rwkv"], h)
    elif cfg.mixer == "hymba":
        mixed = hymba_forward(cfg, p, h, positions, layer_type)
    else:
        raise ValueError(cfg.mixer)
    x = _mixer_out(cfg, p, mixed, x)
    if layer_type == "decoder" and enc_out is not None:
        x = x + cross_attn_forward(cfg, p["xattn"], _norm(cfg, x, p["lnx"]),
                                   enc_out)
    x, aux, _ = _ffn_out(cfg, p, x)
    return x, aux


def block_make_cache(cfg, layer_type, batch, max_seq, dtype, device):
    if cfg.mixer == "attn":
        return attn_make_cache(cfg, layer_type, batch, max_seq, dtype, device)
    if cfg.mixer == "rwkv":
        return rwkv_make_cache(cfg, batch, dtype, device)
    if cfg.mixer == "hymba":
        return hymba_make_cache(cfg, layer_type, batch, max_seq, dtype,
                                device)
    raise ValueError(cfg.mixer)


def block_prefill(cfg, layer_type, p, x, positions, cache):
    """Full-sequence forward that also populates the decode cache.
    Returns (x, cache, aux_loss)."""
    h = _norm(cfg, x, p["ln1"])
    if cfg.mixer == "attn":
        mixed, cache = attn_prefill(cfg, p["attn"], h, positions, layer_type,
                                    cache)
    elif cfg.mixer == "rwkv":
        mixed, st = rwkv_forward(cfg, p["rwkv"], h)
        cache = dict(cache, wkv=st["wkv"], shift=st["shift"])
    elif cfg.mixer == "hymba":
        mixed, cache = hymba_prefill(cfg, p, h, positions, layer_type, cache)
    else:
        raise ValueError(cfg.mixer)
    x, aux, h2 = _ffn_out(cfg, p, _mixer_out(cfg, p, mixed, x))
    if cfg.ffn == "rwkv_cm":
        cache = dict(cache, shift_cm=h2[:, -1])
    return x, cache, aux


def block_decode_mixer(cfg, layer_type, p, x_t, cache, pos):
    """``block_decode`` up to its FFN: the mixer and, where the layer has
    it, the cross-attention.  Returns (x_t, new_cache)."""
    h = _norm(cfg, x_t, p["ln1"])
    if cfg.mixer == "attn":
        mixed, new_attn = attn_decode(
            cfg, p["attn"], h, {k: cache[k] for k in ("k", "v", "slot_pos")},
            pos, layer_type)
        cache = dict(cache)
        cache.update(new_attn)
    elif cfg.mixer == "rwkv":
        mixed, cache = rwkv_decode(cfg, p["rwkv"], h, cache)
    elif cfg.mixer == "hymba":
        mixed, cache = hymba_decode(cfg, p, h, cache, pos, layer_type)
    else:
        raise ValueError(cfg.mixer)
    x_t = _mixer_out(cfg, p, mixed, x_t)
    if layer_type == "decoder" and "xk" in cache:
        x_t = x_t + cross_attn_decode(cfg, p["xattn"],
                                      _norm(cfg, x_t, p["lnx"]),
                                      cache["xk"], cache["xv"])
    return x_t, cache


def block_decode(cfg, layer_type, p, x_t, cache, pos):
    """One-token block step. Returns (x_t, new_cache)."""
    x_t, cache = block_decode_mixer(cfg, layer_type, p, x_t, cache, pos)
    cm = cfg.ffn == "rwkv_cm"
    x_t, _, h2 = _ffn_out(cfg, p, x_t, cache["shift_cm"].to(
        x_t.dtype)[:, None, :] if cm else None)
    if cm:
        cache = dict(cache, shift_cm=h2[:, 0])
    return x_t, cache


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis (``parallel.tensor_parallel``)
# ---------------------------------------------------------------------------
#
# One data shard's model positions ``g`` (a ``ModelGroup``) run a block in
# turn.  Each argument that is a list has one entry a position of
# ``g.ranks``: ``ps`` its slice of the block's params (``sharding.
# model_slice``: its columns of the head and FFN projections, its rows of
# ``wo``, ``w_down``, ``w_out``), ``xs`` the residual stream (the same on
# every position, on its device), ``caches`` its piece of the block's
# cache (its K/V and cross K/V heads, its WKV or SSM heads).  Each
# sub-layer ends in a partial output that ``g.all_reduce`` sums before the
# post-norm and the residual.


def _attn_heads_tp(cfg, g, ps, hs, layer_type, caches=None, positions=None,
                   pos=None, prefix: int = 0):
    """Attention on each position's q heads (K4 over a sequence, prefix-LM
    attention over a ``prefix`` as ``attn_forward`` computes it, the plain
    decode attention against the cache at ``pos``, this step's K/V
    written into the position's cache piece in place), before the output
    projection: (each position's head outputs cut to its ``q_cols``, its
    new cache: ``caches[i]`` with the attention's leaves replaced; None
    entries without ``caches``, an encoder's).  The q and K/V columns a
    position's heads need and its projections do not hold (a head split
    over positions) come from the positions that hold them; where its q
    heads are not whole GQA groups, K4 and the decode attention read the
    K/V heads repeated one a q head (``kv_index``)."""
    dh = cfg.d_head
    sl = [head_slice(cfg, g.size, r) for r in range(g.size)]
    cols = [_qkv_cols(p, h) for p, h in zip(ps, hs)]
    q, k, v = (g.columns([c[j] for c in cols], held,
                         [(a * dh, b * dh) for a, b in want])
               for j, held, want in (
                   (0, [s.q_cols for s in sl], [s.q_heads for s in sl]),
                   (1, [s.kv_cols for s in sl], [s.kv_heads for s in sl]),
                   (2, [s.kv_cols for s in sl], [s.kv_heads for s in sl])))
    outs, new = [], []
    for i, r in enumerate(g.ranks):
        p, idx = ps[i], kv_index(cfg, sl[r])
        if pos is None:
            qh, kh, vh = _heads(cfg, p, q[i], k[i], v[i], positions[i],
                                layer_type, cfg.use_rope)
            spec = _attn_spec(cfg, layer_type)
            if cfg.prefix_lm and prefix > 0:
                o = _prefix_attention(qh, *_expand_kv(kh, vh, idx), spec,
                                      prefix)
            else:
                o = flash_attention(qh, *_expand_kv(kh, vh, idx), spec)
            o = _merge_heads(o)
            c = None if caches is None else _fill_cache(caches[i], kh, vh,
                                                        positions[i])
        else:
            o, c = _decode_attend(cfg, p, q[i], k[i], v[i], caches[i],
                                  pos[i], layer_type, in_place=True,
                                  kv_index=idx)
        outs.append(_own_cols(o, sl[r], dh))
        new.append(None if c is None else dict(caches[i], **c))
    return outs, new


def _own_cols(o, sl, dh: int):
    """Flat head outputs (..., heads·D) of ``sl.q_heads`` cut to the
    position's ``sl.q_cols``."""
    a = sl.q_cols[0] - sl.q_heads[0] * dh
    return o[..., a:a + sl.q_cols[1] - sl.q_cols[0]]


def _attn_tp(cfg, g, ps, hs, layer_type, caches, positions=None, pos=None,
             prefix: int = 0):
    """``_attn_heads_tp`` and each position's rows of ``wo``: (partials,
    caches)."""
    outs, new = _attn_heads_tp(cfg, g, ps, hs, layer_type, caches,
                               positions, pos, prefix)
    return [dense_partial(o, p["wo"]) for o, p in zip(outs, ps)], new


def _xattn_tp(cfg, g, ps, hs, caches, seq: bool = False) -> list:
    """Cross-attention on each position's q heads against its cross K/V
    heads (``xk``, ``xv`` of its cache piece): the partials of its rows of
    ``wo``.  One token against the cache (the decode attention), or with
    ``seq`` every decoder position (the plain masked attention of
    ``cross_attn_forward``)."""
    dh = cfg.d_head
    sl = [head_slice(cfg, g.size, r) for r in range(g.size)]
    q = g.columns([dense(h, p["wq"]) for p, h in zip(ps, hs)],
                  [s.q_cols for s in sl],
                  [(a * dh, b * dh) for a, b in (s.q_heads for s in sl)])
    spec = AttnSpec(causal=False, window=0, softcap=0.0, scale=dh ** -0.5)
    parts = []
    for i, r in enumerate(g.ranks):
        b, s = q[i].shape[:2]
        qh = q[i].reshape(b, s, -1, dh).transpose(1, 2)
        xk, xv = _expand_kv(caches[i]["xk"], caches[i]["xv"],
                            kv_index(cfg, sl[r]))
        if seq:
            o = _masked_attention(qh, xk, xv, spec.scale)
        else:
            s_enc = xk.shape[2]
            slot_pos = torch.arange(s_enc, dtype=torch.int32,
                                    device=qh.device)
            o = decode_attention(qh, xk, xv, slot_pos, s_enc, spec)
        parts.append(dense_partial(_own_cols(_merge_heads(o), sl[r], dh),
                                   ps[i]["wo"]))
    return parts


def _cross_tp(cfg, g, ps, xs, kvs, seq: bool = False) -> list:
    """A ``decoder`` block's cross-attention sub-layer over each
    position's cross K/V heads (``kvs``: its cache piece, or with ``seq``
    ``cross_kv_tp``'s heads of the encoder output): ``_xattn_tp``, one
    reduction, the residual."""
    xo = g.all_reduce(_xattn_tp(
        cfg, g, [p["xattn"] for p in ps],
        [_norm(cfg, x, p["lnx"]) for p, x in zip(ps, xs)], kvs, seq),
        xs[0].dtype)
    return [x + o for x, o in zip(xs, xo)]


def cross_kv_tp(cfg, g, ps, enc_outs) -> tuple:
    """Each position's cross K/V heads (``head_slice``'s ``kv_heads``) of
    the encoder output, (B, Hkv_m, S_enc, D) each: its columns of the
    cross-attention's ``wk`` and ``wv``, the columns of its heads it does
    not hold from the positions that do."""
    dh = cfg.d_head
    sl = [head_slice(cfg, g.size, r) for r in range(g.size)]

    def heads(name):
        cols = g.columns([dense(e, p[name]) for p, e in zip(ps, enc_outs)],
                         [s.kv_cols for s in sl],
                         [(a * dh, b * dh) for a, b in (s.kv_heads
                                                        for s in sl)])
        return [c.reshape(*c.shape[:2], -1, dh).transpose(1, 2)
                for c in cols]
    return heads("wk"), heads("wv")


def _ssm_heads_tp(cfg, g, ps, hs) -> tuple:
    """Hymba's SSM projections on each position's heads (those its q
    columns meet): r, k, w (B, H_m, S, state) and v (B, H_m, S, D), each
    list one a position.  A projection the model axis splits is read
    column by column from the positions that hold its heads' columns;
    ``wb_s`` (replicated) is cut to them locally."""
    st, dh, h = cfg.ssm_state, cfg.d_head, cfg.n_heads
    heads = [head_slice(cfg, g.size, r).q_heads for r in range(g.size)]

    def cols(name, width):
        return g.columns([dense(x, p[name]) for p, x in zip(ps, hs)],
                         [model_cols(h * width, g.size, r)
                          for r in range(g.size)],
                         [(a * width, b * width) for a, b in heads])
    rs, ks, vs, ws = (cols("wr_s", st), cols("wk_s", st), cols("wv_s", dh),
                      cols("ww_s", st))
    out = []
    for i, r in enumerate(g.ranks):
        a, b = heads[r]
        wraw = ws[i] + ps[i]["wb_s"][a * st:b * st].to(ws[i].dtype)
        w = torch.clamp(torch.exp(-torch.exp(wraw.float() - 0.5)),
                        1e-6, 1 - 1e-6)
        bs, s = hs[i].shape[:2]
        out.append(tuple(z.reshape(bs, s, b - a, -1).transpose(1, 2)
                         for z in (rs[i], ks[i], vs[i], w)))
    return out


def _hymba_tp(cfg, g, ps, hs, layer_type, caches, positions=None, pos=None):
    """Hymba's mixer on each position's heads: attention (``_attn_heads_tp``)
    and the SSM heads its q columns meet (K6 with u = 0 over a sequence,
    ``rwkv6_decode_step`` at ``pos``), both cut to its q columns; the
    fusion's two RMS norms over all H·D channels from the reduced sums of
    squares of every position's own columns (one reduction carries both);
    its rows of ``attn/wo``: (partials, caches with ``ssm_state`` its SSM
    heads' state)."""
    dh, st = cfg.d_head, cfg.ssm_state
    sl = [head_slice(cfg, g.size, r) for r in range(g.size)]
    attn = [p["attn"] for p in ps]
    outs, new = _attn_heads_tp(cfg, g, attn, hs, layer_type, caches,
                               positions, pos)
    ssm = _ssm_heads_tp(cfg, g, [p["ssm"] for p in ps], hs)
    os = []
    for i, r in enumerate(g.ranks):
        rr, kk, vv, ww = ssm[i]
        u0 = torch.zeros((rr.shape[1], st), dtype=torch.float32,
                         device=rr.device)
        if pos is None:
            o, state = rwkv6_chunked(rr, kk, vv, ww, u0,
                                     chunk=min(64, rr.shape[2]))
            o = _merge_heads(o)
        else:
            o, state = rwkv6_decode_step(rr[:, :, 0], kk[:, :, 0],
                                         vv[:, :, 0], ww[:, :, 0], u0,
                                         caches[i]["ssm_state"])
            o = o.reshape(o.shape[0], 1, -1)
        os.append(_own_cols(o.to(hs[i].dtype), sl[r], dh))
        if new[i] is not None:
            new[i]["ssm_state"] = state
    sumsq = g.all_reduce([torch.cat([sum_squares(a), sum_squares(o)], -1)
                          for a, o in zip(outs, os)], torch.float32)
    width = cfg.n_heads * dh
    parts = []
    for i, r in enumerate(g.ranks):
        c0, c1 = sl[r].q_cols
        p = ps[i]["ssm"]
        fused = 0.5 * (rms_norm(outs[i], p["norm_a"][c0:c1],
                                sumsq=sumsq[i][..., :1], width=width)
                       + rms_norm(os[i], p["norm_s"][c0:c1],
                                  sumsq=sumsq[i][..., 1:], width=width))
        parts.append(dense_partial(fused, attn[i]["wo"]))
    return parts, new


def _rwkv_local(cfg, p, r: int, size: int) -> Dict:
    """A position's RWKV6 params: the head-indexed leaves the model axis
    replicates (``u``, ``w_bias``, ``out_norm``) cut to its heads."""
    h = cfg.n_heads // size
    cols = slice(r * h * cfg.d_head, (r + 1) * h * cfg.d_head)
    return dict(p, u=p["u"][r * h:(r + 1) * h], w_bias=p["w_bias"][cols],
                out_norm=p["out_norm"][cols])


def _rwkv_tp(cfg, g, ps, hs, caches, decode: bool):
    """The RWKV6 time mix on each position's heads (K6 over a sequence):
    (partials, caches).  ``out_norm`` is one RMS norm over all H·D
    channels: each position's sum of squares is reduced first."""
    ps = [_rwkv_local(cfg, p, r, g.size) for p, r in zip(ps, g.ranks)]
    os, gates, new = [], [], []
    for p, x, c in zip(ps, hs, caches or [None] * len(hs)):
        if decode:
            o, gt, st = _rwkv_step(cfg, p, x[:, 0], c["wkv"], c["shift"])
            c = dict(c, wkv=st, shift=x[:, 0])
        else:
            o, gt, st = _rwkv_scan(cfg, p, x, _shift_tokens(x))
            c = None if c is None else dict(c, wkv=st, shift=x[:, -1])
        os.append(o)
        gates.append(gt)
        new.append(c)
    sumsq = g.all_reduce([sum_squares(o) for o in os], torch.float32)
    width = cfg.n_heads * cfg.d_head
    parts = []
    for p, o, gt, ss in zip(ps, os, gates, sumsq):
        o = rms_norm(o, p["out_norm"], sumsq=ss, width=width) \
            * torch.nn.functional.silu(gt)
        out = dense_partial(o, p["wo"])
        parts.append(out[:, None, :] if decode else out)
    return parts, new


def _ffn_tp(cfg, g, ps, ffn, xs, cm_prevs=None):
    """The FFN sub-layer on each position's columns of the hidden width,
    or on its experts (an MoE FFN: the first position routes, every
    position bundles by its slot map, ``moe_ffn_ep``): (xs, the FFN's
    inputs, the routing's aux loss on the routing position, 0.0 for a
    dense FFN).  The channel mix's receptance gate (``w_rcm`` whole)
    multiplies the reduced sum."""
    h2s = [_norm(cfg, x, p["ln2"]) for p, x in zip(ps, xs)]
    parts, gates, routes, aux = [], [], None, 0.0
    for i, h2 in enumerate(h2s):
        f = ffn(i)
        if cfg.ffn == "moe":
            if routes is None:
                *route, aux = moe_route(
                    h2, f["router"], n_experts=cfg.n_experts,
                    top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
                routes = g.share(route)
            parts.append(moe_ffn_ep(
                h2, f, routes[i], expert_slice(cfg, g.size, g.ranks[i]),
                n_experts=cfg.n_experts, top_k=cfg.moe_top_k))
        elif cfg.ffn == "rwkv_cm":
            prev = _shift_tokens(h2) if cm_prevs is None else cm_prevs[i]
            rgate, hidden = _cm_in(f, h2, prev)
            gates.append(rgate)
            parts.append(dense_partial(hidden, f["w_out"]))
        else:
            parts.append(dense_partial(swiglu_hidden(h2, f["w_gate"],
                                                     f["w_up"]), f["w_down"]))
        del f
    outs = g.all_reduce(parts, xs[0].dtype)
    if gates:
        outs = [gt * o for gt, o in zip(gates, outs)]
    if cfg.post_norm:
        outs = [_norm(cfg, o, p["ln2_post"]) for p, o in zip(ps, outs)]
    return [x + o for x, o in zip(xs, outs)], h2s, aux


def _mixer_tp(cfg, g, ps, xs, parts):
    """The mixer's partials reduced, then the post-norm and the residual,
    once."""
    mixed = g.all_reduce(parts, xs[0].dtype)
    return [_mixer_out(cfg, p, m, x) for p, m, x in zip(ps, mixed, xs)]


def block_seq_tp(cfg, layer_type, g, ps, ffn, xs, positions, caches=None,
                 prefix: int = 0, enc_outs=None):
    """``block_prefill`` (with ``caches``) or ``block_forward`` (without:
    they come back None) over the model positions ``g``: (xs, caches, the
    MoE routing's aux loss).  An image prefix's prefix-LM attention (each
    position's heads through the plain ``_prefix_attention``); a
    ``decoder`` block's cross-attention over ``enc_outs`` (each position's
    encoder output)."""
    cached = caches is not None
    hs = [grad_fence(_norm(cfg, x, p["ln1"])) for p, x in zip(ps, xs)]
    if cfg.mixer == "attn":
        parts, caches = _attn_tp(cfg, g, [p["attn"] for p in ps], hs,
                                 layer_type, caches, positions=positions,
                                 prefix=prefix)
    elif cfg.mixer == "hymba":
        parts, caches = _hymba_tp(cfg, g, ps, hs, layer_type, caches,
                                  positions=positions)
    else:
        parts, caches = _rwkv_tp(cfg, g, [p["rwkv"] for p in ps], hs, caches,
                                 decode=False)
    xs = _mixer_tp(cfg, g, ps, xs, parts)
    if layer_type == "decoder" and enc_outs is not None:
        ks, vs = cross_kv_tp(cfg, g, [p["xattn"] for p in ps], enc_outs)
        xs = _cross_tp(cfg, g, ps, xs, [{"xk": k, "xv": v}
                                        for k, v in zip(ks, vs)], seq=True)
    xs, h2s, aux = _ffn_tp(cfg, g, ps, ffn, xs)
    if not cached:
        return xs, None, aux
    if cfg.ffn == "rwkv_cm":
        caches = [dict(c, shift_cm=h2[:, -1]) for c, h2 in zip(caches, h2s)]
    return xs, caches, aux


def block_decode_mixer_tp(cfg, layer_type, g, ps, xs, caches, pos):
    """``block_decode_tp`` up to its FFN: the mixer and, where the layer
    has it, the cross-attention against each position's cross K/V heads
    (one reduction each): (xs, caches); ``pos`` per position, (B,) each."""
    hs = [_norm(cfg, x, p["ln1"]) for p, x in zip(ps, xs)]
    if cfg.mixer == "attn":
        parts, new = _attn_tp(cfg, g, [p["attn"] for p in ps], hs,
                              layer_type, caches, pos=pos)
    elif cfg.mixer == "hymba":
        parts, new = _hymba_tp(cfg, g, ps, hs, layer_type, caches, pos=pos)
    else:
        parts, new = _rwkv_tp(cfg, g, [p["rwkv"] for p in ps], hs, caches,
                              decode=True)
    xs = _mixer_tp(cfg, g, ps, xs, parts)
    if layer_type == "decoder" and "xk" in caches[0]:
        xs = _cross_tp(cfg, g, ps, xs, caches)
    return xs, new


def block_decode_tp(cfg, layer_type, g, ps, ffn, xs, caches, pos):
    """``block_decode`` over the model positions ``g``: (xs, caches);
    ``pos`` per position, (B,) each."""
    xs, caches = block_decode_mixer_tp(cfg, layer_type, g, ps, xs, caches,
                                       pos)
    cm = cfg.ffn == "rwkv_cm"
    xs, h2s, _ = _ffn_tp(cfg, g, ps, ffn, xs, [
        c["shift_cm"].to(x.dtype)[:, None, :] for c, x in zip(caches, xs)]
        if cm else None)
    if cm:
        caches = [dict(c, shift_cm=h2[:, 0]) for c, h2 in zip(caches, h2s)]
    return xs, caches

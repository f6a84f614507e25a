"""Transformer-block assembly for the ``attn`` and ``hymba`` mixers with the
SwiGLU FFN.

Port of ``repro.models.blocks``.  A block = mixer + ffn with pre-norms
(and gemma-style post-norms).  Every block provides three entry points
with identical parameters:

  * ``block_forward`` — full-sequence (prefill math)
  * ``block_prefill`` — forward + emit decode cache
  * ``block_decode``  — single token with cache

Param declarations (Meta) live beside the compute so shapes cannot drift;
the param tree equals the reference's key for key and shape for shape
(hymba's unused ``wo_s`` included).  Attention over a sequence goes
through kernel K4 and the SSM heads through kernel K6 on the card.

Caches are updated functionally, as in the reference: each entry point
returns new cache tensors and leaves its inputs unchanged.

Not ported yet (ROADMAP queue 1 item 10), each raising
``NotImplementedError``: the ``rwkv`` mixer, the ``rwkv_cm`` and ``moe``
FFNs, cross-attention (enc-dec) and prefix-LM attention.
"""
from __future__ import annotations

from typing import Dict

import torch

from .attention import AttnSpec, decode_attention, flash_attention
from .layers import dense, grad_fence, rms_norm, rotary, swiglu
from .params import Meta
from .ssm import rwkv6_chunked, rwkv6_decode_step

_LATER = "not ported yet (ROADMAP queue 1 item 10)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is {_LATER}")


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


def _ffn_metas(cfg) -> Dict[str, Meta]:
    if cfg.ffn != "swiglu":
        raise _not_ported(f"the {cfg.ffn!r} FFN")
    d = cfg.d_model
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
    elif cfg.mixer == "hymba":
        m["attn"] = _attn_metas(cfg)
        m["ssm"] = _ssm_metas(cfg)
    else:
        raise _not_ported(f"the {cfg.mixer!r} mixer")
    if layer_type == "decoder":
        raise _not_ported("cross-attention (enc-dec)")
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


def _qkv(cfg, p, x, positions, layer_type):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(x, p["wq"]).reshape(b, s, h, dh)
    k = dense(x, p["wk"]).reshape(b, s, hkv, dh)
    v = dense(x, p["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    if cfg.use_rope:
        theta = _theta(cfg, layer_type)
        q = rotary(q, positions[:, None, :], theta=theta)
        k = rotary(k, positions[:, None, :], theta=theta)
    v = v.transpose(1, 2)
    return q, k, v    # (B, H, S, D), (B, Hkv, S, D)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) → (B, S, H·D)."""
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh)


def attn_forward(cfg, p, x, positions, layer_type, prefix: int = 0):
    if cfg.prefix_lm and prefix > 0:
        raise _not_ported("prefix-LM attention")
    q, k, v = _qkv(cfg, p, x, positions, layer_type)
    out = flash_attention(q, k, v, _attn_spec(cfg, layer_type))
    return dense(_merge_heads(out), p["wo"])


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


def _cache_token_write(cache, k, v, pos):
    """Write this step's K/V at each row's slot (``pos % s_cache``, the
    ring discipline; Python's modulo, so an idle row at position -1 writes
    slot ``s_cache - 1``) and stamp the per-row slot→position map.

    k/v: (B, Hkv, 1, D); pos: (B,) int32.  Returns (kc, vc, slot_pos).
    """
    b = k.shape[0]
    s_cache = cache["k"].shape[2]
    slot = torch.remainder(pos, s_cache).long()             # (B,)
    rows = torch.arange(b, device=k.device)
    kc, vc = cache["k"].clone(), cache["v"].clone()
    slot_pos = cache["slot_pos"].clone()
    kc[rows, :, slot] = k[:, :, 0]
    vc[rows, :, slot] = v[:, :, 0]
    slot_pos[rows, slot] = pos
    return kc, vc, slot_pos


def _attn_decode_heads(cfg, p, x_t, cache, pos, layer_type):
    """attn_decode without the output projection (returns flat heads)."""
    b = x_t.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(x_t, p["wq"]).reshape(b, 1, h, dh)
    k = dense(x_t, p["wk"]).reshape(b, 1, hkv, dh)
    v = dense(x_t, p["wv"]).reshape(b, 1, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    theta = _theta(cfg, layer_type)
    pos = _decode_pos_vec(pos, b, x_t.device)
    pos_arr = pos[:, None, None]
    q = rotary(q.transpose(1, 2), pos_arr, theta=theta)
    k = rotary(k.transpose(1, 2), pos_arr, theta=theta)
    v = v.transpose(1, 2)
    kc, vc, slot_pos = _cache_token_write(cache, k, v, pos)
    out = decode_attention(q, kc, vc, slot_pos, pos,
                           _attn_spec(cfg, layer_type))
    return _merge_heads(out), {"k": kc, "v": vc, "slot_pos": slot_pos}


def attn_decode(cfg, p, x_t, cache, pos, layer_type):
    """x_t: (B, 1, d); cache k/v: (B, Hkv, S_cache, D); pos: () or (B,)."""
    out, new_cache = _attn_decode_heads(cfg, p, x_t, cache, pos, layer_type)
    return dense(out, p["wo"]), new_cache


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


def _apply_ffn(cfg, p, x):
    """Returns (out, aux_loss)."""
    if cfg.ffn != "swiglu":
        raise _not_ported(f"the {cfg.ffn!r} FFN")
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _mixer_out(cfg, p, mixed, x):
    if cfg.post_norm:
        mixed = _norm(cfg, mixed, p["ln1_post"])
    return x + mixed


def _ffn_out(cfg, p, x):
    out, aux = _apply_ffn(cfg, p["ffn"], _norm(cfg, x, p["ln2"]))
    if cfg.post_norm:
        out = _norm(cfg, out, p["ln2_post"])
    return x + out, aux


def block_forward(cfg, layer_type, p, x, positions, prefix: int = 0):
    """Full-sequence block. Returns (x, aux_loss)."""
    h = grad_fence(_norm(cfg, x, p["ln1"]))
    if cfg.mixer == "attn":
        mixed = attn_forward(cfg, p["attn"], h, positions, layer_type, prefix)
    elif cfg.mixer == "hymba":
        mixed = hymba_forward(cfg, p, h, positions, layer_type)
    else:
        raise _not_ported(f"the {cfg.mixer!r} mixer")
    return _ffn_out(cfg, p, _mixer_out(cfg, p, mixed, x))


def block_make_cache(cfg, layer_type, batch, max_seq, dtype, device):
    if cfg.mixer == "attn":
        return attn_make_cache(cfg, layer_type, batch, max_seq, dtype, device)
    if cfg.mixer == "hymba":
        return hymba_make_cache(cfg, layer_type, batch, max_seq, dtype,
                                device)
    raise _not_ported(f"the {cfg.mixer!r} mixer")


def block_prefill(cfg, layer_type, p, x, positions, cache):
    """Full-sequence forward that also populates the decode cache.
    Returns (x, cache, aux_loss)."""
    h = _norm(cfg, x, p["ln1"])
    if cfg.mixer == "attn":
        mixed, cache = attn_prefill(cfg, p["attn"], h, positions, layer_type,
                                    cache)
    elif cfg.mixer == "hymba":
        mixed, cache = hymba_prefill(cfg, p, h, positions, layer_type, cache)
    else:
        raise _not_ported(f"the {cfg.mixer!r} mixer")
    x, aux = _ffn_out(cfg, p, _mixer_out(cfg, p, mixed, x))
    return x, cache, aux


def block_decode(cfg, layer_type, p, x_t, cache, pos):
    """One-token block step. Returns (x_t, new_cache)."""
    h = _norm(cfg, x_t, p["ln1"])
    if cfg.mixer == "attn":
        mixed, new_attn = attn_decode(
            cfg, p["attn"], h, {k: cache[k] for k in ("k", "v", "slot_pos")},
            pos, layer_type)
        cache = dict(cache)
        cache.update(new_attn)
    elif cfg.mixer == "hymba":
        mixed, cache = hymba_decode(cfg, p, h, cache, pos, layer_type)
    else:
        raise _not_ported(f"the {cfg.mixer!r} mixer")
    x_t, _ = _ffn_out(cfg, p, _mixer_out(cfg, p, mixed, x_t))
    return x_t, cache

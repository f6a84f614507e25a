"""Useful model operations of a training step and of a prefill, for the
``mfu.*`` metrics: the model's own operations, counted from the
configuration file's sizes, whatever the program computes besides.

* A parameter that a token passes through costs 2 operations forward and 4
  backward (6 a trained token).  The embedding lookup is no product and is
  not counted; the head (d_model × vocab) is.  An MoE layer counts its
  router and its ``moe_top_k`` experts a token, not the capacity padding.
* Recomputation under remat is not counted: it is not useful work.
* Attention adds QKᵀ and PV over the visible pairs (4·H·D a pair forward);
  the RWKV6 WKV adds its state products (4·H·K·V a token forward: r·S and
  the state's update).  Backward is twice forward.
* A prefill needs the logits of its last position only (its first token):
  the head is counted once a prompt.
"""
from __future__ import annotations


def mixer_params(c) -> int:
    d, h, dh = c["d_model"], c["n_heads"], c["d_head"]
    if c["mixer"] == "rwkv":
        return 5 * d * h * dh + h * dh * d          # r, k, v, g, w; out
    if c["mixer"] == "attn":
        return 2 * d * h * dh + 2 * d * c["n_kv_heads"] * dh
    raise ValueError(f"no operation count for mixer {c['mixer']!r}")


def ffn_params(c) -> int:
    """Parameters of the FFN a token passes through."""
    d = c["d_model"]
    if c["ffn"] == "moe":
        return d * c["n_experts"] + c["moe_top_k"] * 3 * d * c["d_ff_expert"]
    if c["ffn"] == "rwkv_cm":
        return d * d + 2 * d * c["d_ff"]
    if c["ffn"] == "swiglu":
        return 3 * d * c["d_ff"]
    raise ValueError(f"no operation count for ffn {c['ffn']!r}")


def active_params(c) -> int:
    """Non-embedding parameters a token passes through, the head aside."""
    return c["n_layers"] * (mixer_params(c) + ffn_params(c))


def head_params(c) -> int:
    return c["d_model"] * c["vocab_size"]


def mixer_forward_flop(c, seq: int) -> float:
    """Forward operations of the sequence mixer beyond its projections, a
    layer, over a whole sequence of ``seq`` tokens."""
    h, dh = c["n_heads"], c["d_head"]
    if c["mixer"] == "rwkv":
        return 4 * h * dh * dh * seq
    if c["mixer"] == "attn":
        return 4 * h * dh * seq * (seq + 1) / 2      # causal pairs
    raise ValueError(f"no operation count for mixer {c['mixer']!r}")


def train_flop(c, batch: int, seq: int) -> float:
    """One training step of ``batch`` sequences of ``seq`` tokens."""
    tokens = batch * seq
    dense = 6 * (active_params(c) + head_params(c)) * tokens
    return dense + 3 * c["n_layers"] * batch * mixer_forward_flop(c, seq)


def prefill_flop(c, prompt_len: int) -> float:
    """One prompt's prefill to its first token."""
    return 2 * active_params(c) * prompt_len \
        + c["n_layers"] * mixer_forward_flop(c, prompt_len) \
        + 2 * head_params(c)

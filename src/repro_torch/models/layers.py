"""Shared model layers: norms, rotary embeddings, dense projections, embed.

Port of ``repro.models.layers``.  Params are plain dicts of tensors
produced by the Meta system (``params``).  Compute dtype policy as in the
reference: inputs are cast to ``cfg.compute_dtype`` at block boundaries;
norms, softmax statistics and the loss accumulate in fp32.  Every cast of a
weight (``dense``, ``embed_lookup``, ``unembed``) is an op of the autograd
graph, so training's gradients reach the float32 leaves.
"""
from __future__ import annotations

from typing import Optional

import torch


def grad_fence(x: torch.Tensor) -> torch.Tensor:
    """The identity.  The reference's ``grad_fence`` is an identity whose
    backward casts the cotangent to the primal's dtype; torch's autograd
    already hands every tensor a gradient of its own dtype (the backward
    of each cast casts back), so nothing is left to do here."""
    return x


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False, sumsq: Optional[torch.Tensor] = None,
             width: int = 0) -> torch.Tensor:
    """RMSNorm with fp32 statistics. ``plus_one``: gemma-style (1 + w).

    ``x`` may be one tensor-parallel slice of a wider activation: then
    ``sumsq`` is the float32 sum of squares over all ``width`` channels
    (``sum_squares`` of each slice, reduced) and ``weight`` the slice's."""
    x32 = x.float()
    if sumsq is None:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    else:
        var = sumsq / width
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares over the last dim, kept: one slice's
    share of ``rms_norm``'s statistic."""
    x32 = x.float()
    return (x32 * x32).sum(dim=-1, keepdim=True)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics (population variance)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor, *,
           theta: float = 10000.0) -> torch.Tensor:
    """Apply rotary position embedding.  x: (..., S, D), positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs       # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w contracting x's last dim with w's first dim, in x's dtype.

    w may be (d_in, d_out) or (d_in, a, b) (fused head projections).  The
    weight is cast to x's dtype first, as in the reference; a weight that
    already has it (``model.compute_params``) is used as it is.
    """
    out = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


class _MmFloat32(torch.autograd.Function):
    """``x2 @ w2`` of compute-dtype matrices with a float32 result (one
    product, float32 sums), and its gradient: ``dx = g @ w2ᵀ`` in x's
    dtype, ``dw = x2ᵀ @ g`` summed in float32 and rounded to w's dtype,
    ``g`` first rounded to the compute dtype (the gradient ``dense`` gets
    on one device).  torch has no derivative of ``mm`` with ``out_dtype``."""

    @staticmethod
    def forward(ctx, x2, w2):
        ctx.save_for_backward(x2, w2)
        return torch.mm(x2, w2, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w2 = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w2.T
        dw = torch.mm(x2.T, g, out_dtype=torch.float32).to(w2.dtype)
        return dx, dw


def dense_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dense`` over a slice of the contracted dim, in float32: one
    tensor-parallel position's partial product, summed with the others'
    before one rounding to the compute dtype.  Products of compute-dtype
    values summed in float32 (``dense`` itself where that is float32);
    differentiable on every device (``_MmFloat32`` on the card and on
    ``meta``)."""
    if x.dtype == torch.float32:
        return dense(x, w)
    w2 = w.to(x.dtype).reshape(w.shape[0], -1)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type in ("cuda", "meta"):
        out = _MmFloat32.apply(x2, w2)
    else:
        out = x2.float() @ w2.float()
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor, *,
                 scale: Optional[float] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding gather; optional sqrt(d) scaling (gemma)."""
    x = table[tokens.long()].to(compute_dtype)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=compute_dtype, device=x.device)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor, *,
            cap: float = 0.0) -> torch.Tensor:
    """Project to vocabulary logits (optionally soft-capped), fp32 out.

    The table is cast to x's dtype, then both operands are widened to fp32
    for the product: the reference's ``preferred_element_type=float32``
    (exact products of the compute-dtype values, fp32 sums)."""
    logits = x.float() @ table.to(x.dtype).float().T
    return softcap(logits, cap)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@Wg) * (x@Wu) @ Wd, used by every dense FFN here."""
    return dense(swiglu_hidden(x, w_gate, w_up), w_down)


def swiglu_hidden(x: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU's hidden activation silu(x@Wg) * (x@Wu) (a tensor-parallel
    position's columns of it from its columns of Wg and Wu)."""
    return torch.nn.functional.silu(dense(x, w_gate)) * dense(x, w_up)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """Whisper-style GELU MLP with biases (the tanh approximation, as
    ``jax.nn.gelu``'s default)."""
    h = torch.nn.functional.gelu(dense(x, w_up) + b_up.to(x.dtype),
                                 approximate="tanh")
    return dense(h, w_down) + b_down.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32. logits: (B, S, V), labels: (B, S).

    The float32 logsumexp minus the gold logit.  The reference extracts the
    gold logit with a one-hot contraction so that vocab-sharded logits stay
    sharded; on one device a gather reads the same value.  ``mask`` (B, S)
    weights each token; the mean is then over ``max(mask.sum(), 1)``.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def cross_entropy_tp(g, logits: list, labels: list) -> torch.Tensor:
    """``cross_entropy_loss`` over vocabulary-parallel logits: ``logits``
    each model position's float32 logits over its vocabulary rows (B, S,
    V / size; the rows ``[r · V / size, (r + 1) · V / size)`` of position
    ``r``), ``labels`` (B, S) on each, one entry a position of ``g.ranks``
    (``parallel.tensor_parallel.ModelGroup``).  Each position gives the max
    of its logits, the sum of their exponentials below it and the gold
    logit where the label falls in its range (zero elsewhere: the
    reference's one-hot contraction, one nonzero term a token); the three
    reach the first position (``g.to_first``), which reduces them in
    float32 in the order m = 0, 1, ...: logz = M + log Σ s_r e^(m_r − M).
    Returns the mean NLL on the first position's device.  The maxima are
    constants of the gradient (they cancel in the value)."""
    stats = []
    for lg, lab, r in zip(logits, labels, g.ranks):
        lg = lg.float()
        n = lg.shape[-1]
        mx = lg.amax(dim=-1).detach()
        s = torch.exp(lg - mx[..., None]).sum(dim=-1)
        idx = lab.long() - r * n
        inside = (idx >= 0) & (idx < n)
        gold = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros((), device=lg.device))
        stats.append(torch.stack([mx, s, gold], dim=-1))
    parts = g.to_first(stats)
    top = torch.stack([p[..., 0] for p in parts]).amax(dim=0)
    total = gold = None
    for p in parts:
        t = p[..., 1] * torch.exp(p[..., 0] - top)
        total = t if total is None else total + t
        gold = p[..., 2] if gold is None else gold + p[..., 2]
    return (top + torch.log(total) - gold).mean()

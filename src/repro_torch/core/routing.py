"""Token→expert assignment math — ONE source of truth.

Copy of ``repro.core.routing`` with a PyTorch branch in place of the
``jax.numpy`` one.  The rank-within-expert capacity assignment (argsort →
first-occurrence → position → keep/drop → bundle-slot destination) is the
heart of MoE dispatch, and it runs in two worlds that must agree
bit-for-bit:

* **numpy, on the host** — ``core.inspector.inspect_moe_dispatch`` bakes
  it into the pattern-pure ``MoeDispatchPlan`` (plan-cached, persisted);
* **torch, on a tensor's device** — callers that keep the routing on the
  card pass ``xp=torch``.

Callers pass the array namespace: ``xp=np`` (default) or ``xp=torch``.
Both branches use a stable sort (``torch.argsort`` is not stable unless
asked) and break top-k ties toward the lower expert index (``torch.topk``
promises no order on ties, so the torch branch sorts too), so the integers
— expert ids, positions, keep masks, slot destinations — are equal in both
for equal inputs.  The float results (softmax, gates) may differ in the
last bits between the two libraries.
"""
from __future__ import annotations

import numpy as np


def _is_np(xp) -> bool:
    return xp is np


def softmax_probs(logits, xp=np):
    """Row softmax, max-shifted — the router's probability map."""
    if _is_np(xp):
        z = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)
    z = logits - logits.amax(dim=-1, keepdim=True)
    e = xp.exp(z)
    return e / e.sum(dim=-1, keepdim=True)


def top_k_experts(probs, top_k: int, xp=np):
    """Top-k expert selection + renormalized gates → (expert, gate).

    Both branches take a stable argsort of the negated probs, so ties break
    toward the lower expert index (the order ``jax.lax.top_k`` produces in
    the reference); both feed one ``normalize_gates``.
    """
    if _is_np(xp):
        expert = np.argsort(-probs, axis=-1, kind="stable")[..., :top_k]
        gate = np.take_along_axis(probs, expert, axis=-1)
    else:
        expert = xp.argsort(-probs, dim=-1, stable=True)[..., :top_k]
        gate = xp.gather(probs, -1, expert)
    return expert, normalize_gates(gate, xp=xp)


def expert_assignment(e_flat, capacity: int, n_experts: int, xp=np):
    """Capacity-limited bundle-slot assignment for flat expert choices.

    ``e_flat``: (n_tokens * top_k,) expert index per flat assignment, in
    row-major token order.  Returns ``(pos, keep, dest)``: position within
    the expert's bundle, the keep mask (``pos < capacity``; overflow drops
    in stable flat order), and the destination slot — with
    ``n_experts * capacity`` as the overflow slot.
    """
    n = e_flat.shape[0]
    if _is_np(xp):
        order = np.argsort(e_flat, kind="stable")
        sorted_e = e_flat[order]
        # rank within expert: index − first-occurrence index (sorted layout)
        first = np.searchsorted(sorted_e, sorted_e, side="left")
        pos_sorted = np.arange(n, dtype=np.int64) - first
        pos = np.empty_like(pos_sorted)
        pos[order] = pos_sorted
        keep = pos < capacity
        dest = np.where(keep, e_flat * capacity + pos, n_experts * capacity)
        return pos, keep, dest
    e_flat = e_flat.long()
    order = xp.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    first = xp.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = xp.arange(n, dtype=xp.int64, device=e_flat.device) - first
    pos = xp.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < capacity
    dest = xp.where(keep, e_flat * capacity + pos,
                    xp.full_like(pos, n_experts * capacity))
    return pos, keep, dest


def scatter_to_slots(dest, values, n_slots: int, fill, xp=np):
    """Scatter ``values[i]`` to slot ``dest[i]`` over an ``n_slots + 1``
    buffer whose last slot absorbs overflow; returns the first
    ``n_slots`` slots.  Output dtype follows ``values``."""
    shape = (n_slots + 1,) + tuple(values.shape[1:])
    if _is_np(xp):
        out = np.full(shape, fill, dtype=values.dtype)
        out[dest] = values
        return out[:n_slots]
    out = xp.full(shape, fill, dtype=values.dtype, device=values.device)
    # kept assignments have distinct slots; only the overflow slot repeats
    out[dest] = values
    return out[:n_slots]


def normalize_gates(gate, xp=np):
    """Top-k gate renormalization (identical formula on both paths)."""
    if _is_np(xp):
        return gate / np.maximum(gate.sum(axis=-1, keepdims=True), 1e-9)
    return gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

"""Mixture-of-Experts FFN with RIR capacity-bundled dispatch.

Port of ``repro.models.moe``: routing is an irregular sparse pattern; we
regularize it into fixed-capacity per-expert bundles (padded, statically
shaped — the RIR discipline), and the expert compute is a dense grouped
GEMM, kernel K5 (``kernels.ops.moe_gemm``) on the card.

Two paths:

* ``moe_ffn`` — the LM's FFN (the reference's in-graph path).  Per batch
  row, the router and the capacity assignment run on the tokens' device
  (``core.routing`` with ``xp=torch``); bundles are gathered, the three
  expert products go through K5 (bundle ``b·E + e`` meets expert ``e``),
  and each token's top-k slot outputs are gathered back and summed over k
  in a fixed order (no scatter-add, whose float sums on the card come in an
  order that changes from run to run).  At decode (s == 1) dispatch runs
  across the batch, as in the reference.  With a runtime installed by
  ``set_host_dispatch_runtime``, a decode step routes its slot
  destinations through the runtime's ``moe_dispatch`` op
  (``_host_plan_dest``: warm per-token plans after the first steps, the
  same integers), as the reference's jitted decode step does through its
  host callback; a prefill stays on the device.
* ``moe_route`` / ``moe_ffn_ep`` — ``moe_ffn`` split for expert
  parallelism over the model axis (``parallel.tensor_parallel``): one
  position routes (the same slot map, dropped assignments and gates as
  ``moe_ffn``, integer for integer) and shares the result; each position
  bundles only its own experts' slots, runs K5 on its slice of the expert
  stacks and forms its float32 partial of the combine (and of the shared
  experts, on its columns), summed over the positions once.  Under
  autograd the router's gradient reaches the routing position through the
  gates' copies and the aux loss ``moe_route`` returns.
* ``moe_ffn_host`` — the eager registry-routed API: ``host_route`` (the
  router's logits to the host, numpy routing), ``ReapRuntime.moe_dispatch``
  (plan-cached bundling), ``expert_swiglu`` through K5, ``plan.combine``.
  It is a serving path.

Training differentiates ``moe_ffn`` on the card: each K5 product under grad
goes through ``kernels.moe_gemm._MoeGemm``, whose backward is K5's backward
kernels (dx and dw, six backward GEMMs a layer); the routing, the gather
and the combine are torch ops and keep their autograd (the router's
gradient comes through the gates and the aux loss).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.rir import ScheduleBundle
from ..core.routing import (expert_assignment, scatter_to_slots,
                            softmax_probs, top_k_experts)
from ..device import resolve_device, to_device
from ..kernels.ops import moe_gemm
from ..parallel.api import constrain
from .layers import dense, dense_partial, swiglu, swiglu_hidden


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    return _round_up(
        max(8, int(n_tokens * top_k * capacity_factor / n_experts)), 8)


def host_route(tokens, router_w, *, top_k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side router: tokens → (expert_ids, gates) as numpy arrays.

    The logits ``tokens @ router_w`` are one plain product on the tokens'
    device (float32); only the (T, E) logits come to the host, where the
    numpy routing math (``core.routing``, the reference's copy) picks the
    experts.  Feed ``expert_ids`` to ``ReapRuntime.moe_dispatch`` (the
    pattern, fingerprinted) and ``gates`` (values) to ``plan.combine``.
    """
    if torch.is_tensor(tokens):
        w = torch.as_tensor(router_w).to(tokens.device, torch.float32)
        logits = (tokens.float() @ w).cpu().numpy()
    else:
        logits = np.asarray(tokens, np.float32) @ np.asarray(router_w,
                                                             np.float32)
    probs = softmax_probs(logits, xp=np)
    expert, gate = top_k_experts(probs, top_k, xp=np)
    return expert.astype(np.int64), gate.astype(np.float32)


def expert_swiglu(x_bundles: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor,
                  bundle_expert=None) -> torch.Tensor:
    """Per-expert SwiGLU. x: (E, cap, d); weights: (E, d, dff)/(E, dff, d).

    The three products are grouped GEMMs through ``kernels.ops.moe_gemm``
    (K5 on the card, its plain version on the host); ``bundle_expert``
    (expert ids, or the dispatch plan's schedule bundle, which keeps their
    device copies) defaults to bundle ``e`` meeting expert ``e``, the
    dispatch plan's schedule.  Weights are cast to x's dtype, as in the
    reference.  Under grad mode the products differentiate: on the card
    through K5's backward kernels.
    """
    if bundle_expert is None:
        bundle_expert = np.arange(x_bundles.shape[0], dtype=np.int32)
    dt = x_bundles.dtype
    d, dff = w_gate.shape[1:]
    # the reference's einsum takes any width; K5's tile arguments must
    # divide theirs, so pass the largest that do
    tiles = dict(bk=math.gcd(d, 512), bf=math.gcd(dff, 512))
    g = torch.nn.functional.silu(moe_gemm(x_bundles, w_gate.to(dt),
                                          bundle_expert, **tiles))
    u = moe_gemm(x_bundles, w_up.to(dt), bundle_expert, **tiles)
    return moe_gemm(g * u, w_down.to(dt), bundle_expert,
                    bk=tiles["bf"], bf=tiles["bk"])


def moe_ffn_host(x: torch.Tensor, p: Mapping[str, torch.Tensor], runtime, *,
                 n_experts: int, top_k: int, capacity_factor: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager MoE FFN with registry-routed dispatch (the serving path).

    x: (B, S, d) on the runtime's device.  Routing runs on the host
    (``host_route``), the assignment pattern goes through
    ``runtime.moe_dispatch`` — plan-cached (and store-persisted, with a
    plan store) like every registered op — and the expert SwiGLU runs on
    the float32 bundles through K5.  ``runtime`` is passed in, where the
    reference's ``_moe_ffn_host`` reads the process-wide one that
    ``set_host_dispatch_runtime`` installs.  Returns ``(out, aux)`` with
    out in x's dtype and aux 0 (the load-balance loss only matters in
    training, on the in-graph path).
    """
    b, s, d = x.shape
    tokens = x.reshape(b * s, d).float()
    expert_ids, gates = host_route(tokens, p["router"], top_k=top_k)
    cap = expert_capacity(b * s, n_experts, top_k, capacity_factor)
    x_bundles, plan, _ = runtime.moe_dispatch(tokens, expert_ids,
                                              n_experts=n_experts,
                                              capacity=cap)
    y = expert_swiglu(x_bundles.float(), p["w_gate"], p["w_up"],
                      p["w_down"], plan.schedule)
    out = plan.combine(y, gates).to(x.dtype).reshape(b, s, d)
    if "shared_gate" in p:                                   # shared experts
        out = out + swiglu(x.reshape(b * s, d), p["shared_gate"],
                           p["shared_up"], p["shared_down"]).reshape(b, s, d)
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


# -- Host-routed dispatch through the op registry ---------------------------
#
# ``launch/serve.py --routing host`` (or ``--host-moe``) installs the
# process's ReapRuntime here.  A decode step's ``moe_ffn`` then hands the
# routing pattern to the registered ``moe_dispatch`` op and takes the warm
# plans' slot destinations back; bundling, the expert products and the
# combine stay on the device.  Prefills stay fully on the device.

_HOST_DISPATCH_RT = None


def set_host_dispatch_runtime(rt) -> None:
    """Install (or with ``None`` remove) the runtime that decode steps of
    ``moe_ffn`` route their dispatch through."""
    global _HOST_DISPATCH_RT
    _HOST_DISPATCH_RT = rt


def _host_plan_dest(expert_ids, *, n_experts: int, capacity: int):
    """Routing *pattern* in, the warm plans' slot destinations out.

    Plans are keyed **per token pattern**: one token's routing choice is one
    of only P(E, k) ordered expert tuples, so a sustained decode stream
    revisits the same fingerprints after a short warmup and every revisit
    is a warm ``moe_dispatch`` hit.  An O(t·E) prefix count merges the
    per-token ranks into the joint capacity assignment, equal to
    ``expert_assignment`` on the whole flattened pattern (stable flattened
    order ⇒ joint rank = count of same-expert entries in earlier tokens +
    within-token rank).  With no runtime installed (or k > capacity) the
    shared assignment math answers, with the same integers and no caching.
    """
    rt = _HOST_DISPATCH_RT
    e = np.asarray(expert_ids, np.int64)
    t, k = e.shape
    n_slots = n_experts * capacity
    if rt is None or k > capacity:
        _, _, dest = expert_assignment(e.reshape(-1), capacity, n_experts,
                                       xp=np)
        return np.asarray(dest, np.int32)
    stub = np.zeros((1, 0), np.float32)          # pattern-only call
    counts = np.zeros(n_experts, np.int64)
    dest = np.empty(t * k, np.int32)
    for i in range(t):
        _, plan, _ = rt.moe_dispatch(stub, e[i:i + 1], n_experts=n_experts,
                                     capacity=capacity)
        ei = e[i]
        r = np.asarray(plan.dest, np.int64) - ei * capacity  # within-token
        pos = counts[ei] + r
        dest[i * k:(i + 1) * k] = np.where(
            pos < capacity, ei * capacity + pos, n_slots)
        np.add.at(counts, ei, 1)
    return dest


# -- The in-graph path -------------------------------------------------------

def _route(tokens: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Router on the tokens' device: (probs (T, E), expert (T, K), gate
    (T, K)), float32, the expert ids int64."""
    logits = dense(tokens.float(), router_w.float())
    probs = softmax_probs(logits, xp=torch)
    expert, gate = top_k_experts(probs, top_k, xp=torch)
    return probs, expert, gate


def _aux_loss(probs: torch.Tensor, e_flat: torch.Tensor, n_experts: int
              ) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e mean prob · assignment share
    (the share counted exactly, by an integer ``scatter_add_``: it reads
    nothing back to the host and takes ``meta`` tensors, where
    ``bincount`` does neither)."""
    me = probs.mean(dim=0)
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=e_flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    ce = counts.to(probs.dtype) / e_flat.numel()
    return n_experts * torch.sum(me * ce)


def _row_slots(tokens: torch.Tensor, router_w: torch.Tensor, *,
               n_experts: int, top_k: int, capacity: int,
               host_cb: bool = False):
    """One batch row's routing and slot map: ``(dest (T·K,), gate (T·K,),
    keep (T·K,), aux, slot_token (E·cap,))``.  ``slot_token[slot]`` is the
    token filling each bundle slot (T = dead).  With ``host_cb`` the slot
    destinations come from the installed runtime's warm plans
    (``_host_plan_dest``); kept entries are exactly those below the
    overflow slot, and the integers equal the device's."""
    t = tokens.shape[0]
    probs, expert, gate = _route(tokens, router_w, top_k)
    e_flat = expert.reshape(-1)
    n_slots = n_experts * capacity
    if host_cb:
        dest = to_device(_host_plan_dest(
            expert.cpu().numpy(), n_experts=n_experts, capacity=capacity),
            tokens.device).long()
        keep = dest < n_slots
    else:
        _, keep, dest = expert_assignment(e_flat, capacity, n_experts,
                                          xp=torch)
    token_idx = torch.arange(t, device=tokens.device).repeat_interleave(
        top_k)
    slot_token = scatter_to_slots(dest, token_idx, n_slots, fill=t,
                                  xp=torch)
    return (dest, gate.reshape(-1), keep,
            _aux_loss(probs, e_flat, n_experts), slot_token)


def _bundles(x: torch.Tensor, router_w: torch.Tensor, *, n_experts: int,
             top_k: int, capacity: int, host_cb: bool = False):
    """x (B, S, d) → ``(x_bundles (B·E, cap, d), dest (B, S·K),
    gate·keep (B, S·K), aux (B,))``: each row's slot map (``_row_slots``),
    then the bundles by gather (dead slots read an appended zero row).
    Bundle ``b·E + e`` meets expert ``e`` (``_bundle_map``)."""
    b, _, d = x.shape
    dest, gate, keep, aux, slot_token = (torch.stack(c) for c in zip(*(
        _row_slots(x[i], router_w, n_experts=n_experts, top_k=top_k,
                   capacity=capacity, host_cb=host_cb) for i in range(b))))
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=x.device)[:, None]
    x_bundles = xpad[rows, slot_token].reshape(b * n_experts, capacity, d)
    return x_bundles, dest, gate * keep, aux


def _combine(y: torch.Tensor, dest: torch.Tensor, weight: torch.Tensor,
             top_k: int) -> torch.Tensor:
    """y (B, n_slots, d) slot outputs; dest, weight (B, T·K) → (B, T, d):
    each token's top-k slot outputs gathered through ``dest`` (the overflow
    slot reads zero), weighted and summed over k in a fixed order."""
    b, _, d = y.shape
    y = torch.cat([y, y.new_zeros((b, 1, d))], dim=1)
    rows = torch.arange(b, device=y.device)[:, None]
    y_rep = y[rows, dest] * weight[..., None].to(y.dtype)
    return y_rep.reshape(b, -1, top_k, d).sum(2)


def route_and_bundle(tokens: torch.Tensor, router_w: torch.Tensor, *,
                     n_experts: int, top_k: int, capacity: int):
    """Router + RIR bundling. tokens: (T, d) → bundles (E, cap, d).

    Returns ``(x_bundles, combine, aux_loss, dropped)``, where ``combine``
    carries the slot destinations and gates ``unbundle`` needs."""
    t, d = tokens.shape
    dest, gate, keep, aux_loss, slot_token = _row_slots(
        tokens, router_w, n_experts=n_experts, top_k=top_k,
        capacity=capacity)
    x_bundles = torch.cat([tokens, tokens.new_zeros((1, d))])[slot_token]
    combine = dict(dest=dest, keep=keep, gate=gate, n_tokens=t,
                   top_k=top_k)
    return (x_bundles.reshape(n_experts, capacity, d), combine, aux_loss,
            1.0 - keep.float().mean())


def unbundle(y_bundles: torch.Tensor, combine, d_out: int) -> torch.Tensor:
    """Gather expert outputs back to token order and mix with gates."""
    e, cap, _ = y_bundles.shape
    return _combine(y_bundles.reshape(1, e * cap, d_out),
                    combine["dest"][None],
                    (combine["gate"] * combine["keep"])[None],
                    combine["top_k"])[0]


def _row_dispatch(tokens: torch.Tensor, router_w: torch.Tensor, *,
                  n_experts: int, top_k: int, capacity: int,
                  host_cb: bool = False):
    """Per-batch-row routing → slot maps: ``slot_token[slot]`` (the token
    filling each bundle slot; T = dead), ``slot_gate[slot]`` and the aux
    loss, as the reference returns them."""
    dest, gate, keep, aux, slot_token = _row_slots(
        tokens, router_w, n_experts=n_experts, top_k=top_k,
        capacity=capacity, host_cb=host_cb)
    slot_gate = scatter_to_slots(dest, (gate * keep).float(),
                                 n_experts * capacity, fill=0.0, xp=torch)
    return slot_token, slot_gate, aux


@functools.lru_cache(maxsize=64)
def _bundle_map(n_rows: int, n_experts: int) -> ScheduleBundle:
    """K5's expert map for ``n_rows`` rows of E bundles (bundle ``b·E + e``
    meets expert ``e``); one object per shape, so K5 keeps its device
    copies on it (the forward's schedule and the backward's CSR walk) and
    uploads each once."""
    return ScheduleBundle("moe_ffn", {"bundle_expert": np.tile(
        np.arange(n_experts, dtype=np.int32), n_rows)})


def moe_ffn(x: torch.Tensor, p: Mapping[str, torch.Tensor], *,
            n_experts: int, top_k: int, capacity_factor: float,
            _host_cb: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MoE FFN. x: (B, S, d). Returns (out in x's dtype, aux_loss).

    Per batch row: routing and bundles by gather (``_bundles``), the expert
    SwiGLU through K5 over all B·E bundles at once, and the combine
    (``_combine``): each token's top-k slot outputs gathered through
    ``dest``, gate-weighted and summed over k.  Decode (s == 1) bundles
    across the batch, routed through the installed runtime if there is one.
    """
    b, s, d = x.shape
    if s == 1:
        host_cb = _HOST_DISPATCH_RT is not None
        if b > 1:
            out, aux = moe_ffn(x.reshape(1, b, d), p, n_experts=n_experts,
                               top_k=top_k, capacity_factor=capacity_factor,
                               _host_cb=host_cb)
            return out.reshape(b, s, d), aux
        _host_cb = host_cb                        # b == 1: no reshape needed
    cap = expert_capacity(s, n_experts, top_k, capacity_factor)
    x_bundles, dest, gate_keep, aux = _bundles(
        x, p["router"], n_experts=n_experts, top_k=top_k, capacity=cap,
        host_cb=_host_cb)
    constrain(x_bundles.reshape(b, n_experts, cap, d), "dp", "experts", None,
              None)
    y = expert_swiglu(x_bundles, p["w_gate"], p["w_up"], p["w_down"],
                      _bundle_map(b, n_experts))
    constrain(y.reshape(b, n_experts, cap, d), "dp", "experts", None, None)
    out = _combine(y.reshape(b, n_experts * cap, d), dest, gate_keep, top_k)
    out = constrain(out, "dp", None, None)
    if "shared_gate" in p:                                   # shared experts
        out = out + swiglu(x.reshape(b * s, d), p["shared_gate"],
                           p["shared_up"], p["shared_down"]).reshape(b, s, d)
    return out, aux.mean()


def moe_route(x: torch.Tensor, router_w: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float):
    """``moe_ffn``'s routing of x (B, S, d), with its rule at decode (s ==
    1: the batch bundled as one row, through the installed runtime if
    there is one): ``(dest (R, T·K), gate·keep (R, T·K), slot_token (R,
    E·cap), aux)`` over its R rows of T tokens (R = 1, T = B at decode),
    the capacity ``slot_token``'s width over E; ``aux`` the load-balance
    loss, the mean of the rows' (``moe_ffn``'s)."""
    b, s, d = x.shape
    host_cb = False
    if s == 1:
        host_cb = _HOST_DISPATCH_RT is not None
        x = x.reshape(1, b, d)
    cap = expert_capacity(x.shape[1], n_experts, top_k, capacity_factor)
    dest, gate, keep, aux, slot_token = (torch.stack(c) for c in zip(*(
        _row_slots(x[i], router_w, n_experts=n_experts, top_k=top_k,
                   capacity=cap, host_cb=host_cb)
        for i in range(x.shape[0]))))
    return dest, gate * keep, slot_token, aux.mean()


def moe_ffn_ep(x: torch.Tensor, p: Mapping[str, torch.Tensor], route,
               experts: Tuple[int, int], *, n_experts: int, top_k: int
               ) -> torch.Tensor:
    """One model position's float32 partial of ``moe_ffn``'s output for x
    (B, S, d): ``p`` its slice of the FFN's params (the experts ``[first,
    end)`` of each stack, its columns of the shared experts), ``route``
    ``moe_route``'s first three results.  Its experts' slots bundled by
    gather (bundle
    ``r·E' + e'`` meets local expert ``e'``, ``_bundle_map(R, E')``), the
    expert SwiGLU through K5 on its slice, each token's top-k slot outputs
    in its range gate-weighted and summed over k in ``_combine``'s order
    (a slot outside its range, or the overflow slot, reads zero), plus the
    shared experts' partial product on its columns."""
    dest, weight, slot_token = route
    n_rows, n_tok = dest.shape[0], dest.shape[1] // top_k
    d = x.shape[-1]
    e0, e1 = experts
    n_local, cap = e1 - e0, slot_token.shape[1] // n_experts
    n_mine = n_local * cap
    rows = x.reshape(n_rows, n_tok, d)
    xpad = torch.cat([rows, rows.new_zeros((n_rows, 1, d))], dim=1)
    idx = torch.arange(n_rows, device=x.device)[:, None]
    x_bundles = xpad[idx, slot_token[:, e0 * cap:e1 * cap]].reshape(
        n_rows * n_local, cap, d)
    y = expert_swiglu(x_bundles, p["w_gate"], p["w_up"], p["w_down"],
                      _bundle_map(n_rows, n_local))
    local = dest - e0 * cap
    local = torch.where((local >= 0) & (local < n_mine), local,
                        torch.full_like(local, n_mine))
    out = _combine(y.reshape(n_rows, n_mine, d).float(), local, weight,
                   top_k).reshape(x.shape)
    if "shared_gate" in p:                                   # shared experts
        out = out + dense_partial(swiglu_hidden(x, p["shared_gate"],
                                                p["shared_up"]),
                                  p["shared_down"])
    return out


_MOE_KEYS = ("router", "w_gate", "w_up", "w_down",
             "shared_gate", "shared_up", "shared_down")


def moe_params_from_numpy(p: Mapping, device="cuda",
                          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A reference MoE parameter dict → tensors on ``device`` in ``dtype``.

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; a CUDA
    device on a machine without a card raises, as every entry point does.

    Keys: ``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, dff), ``w_down``
    (E, dff, d), and the optional ``shared_gate`` / ``shared_up`` /
    ``shared_down``.  Values may be numpy arrays or anything
    ``np.asarray`` reads (a JAX array, a CPU tensor).
    """
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(p[k], np.float32))).to(dev, dtype)
            for k in _MOE_KEYS if k in p}

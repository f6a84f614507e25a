"""Mixture-of-Experts FFN with RIR capacity-bundled dispatch, host-routed.

Port of the host half of ``repro.models.moe``: routing is an irregular
sparse pattern; the ``moe_dispatch`` op regularizes it into fixed-capacity
per-expert bundles (padded, statically shaped — the RIR discipline), and
the expert compute is a dense grouped GEMM, kernel K5
(``kernels.ops.moe_gemm``) on the card.

The path (``moe_ffn_host``), per MoE layer:

  1. ``host_route`` — router logits on the tokens' device, the (T, E)
     logits to the host, softmax / top-k / gate renormalization in numpy
     (``core.routing``), so the expert ids match the reference's;
  2. ``ReapRuntime.moe_dispatch`` — fingerprint the token→expert pattern,
     build or reuse a ``MoeDispatchPlan``, gather the bundles on the card;
  3. ``expert_swiglu`` — three grouped products through K5;
  4. ``plan.combine`` — gate-weighted gather back to token order.

The traced in-graph ``moe_ffn`` of the reference (and its
``route_and_bundle`` / ``unbundle`` / ``_row_dispatch``) belong to the LM
stack and come with it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.routing import softmax_probs, top_k_experts
from ..device import resolve_device
from ..kernels.ops import moe_gemm
from .layers import swiglu


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
    device copy) defaults to bundle ``e`` meeting expert ``e``, the
    dispatch plan's schedule.  Weights are cast to x's dtype, as in the
    reference.
    """
    if bundle_expert is None:
        bundle_expert = np.arange(x_bundles.shape[0], dtype=np.int32)
    dt = x_bundles.dtype
    g = torch.nn.functional.silu(moe_gemm(x_bundles, w_gate.to(dt),
                                          bundle_expert))
    u = moe_gemm(x_bundles, w_up.to(dt), bundle_expert)
    return moe_gemm(g * u, w_down.to(dt), bundle_expert)


def moe_ffn_host(x: torch.Tensor, p: Mapping[str, torch.Tensor], runtime, *,
                 n_experts: int, top_k: int, capacity_factor: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager MoE FFN with registry-routed dispatch (the serving path).

    x: (B, S, d) on the runtime's device.  Routing runs on the host
    (``host_route``), the assignment pattern goes through
    ``runtime.moe_dispatch`` — plan-cached (and store-persisted, with a
    plan store) like every registered op — and the expert SwiGLU runs on
    the float32 bundles through K5.  ``runtime`` replaces the reference's
    process-wide ``set_host_dispatch_runtime``.  Returns ``(out, aux)``
    with out in x's dtype and aux 0 (the load-balance loss only matters in
    training, on the traced path).
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

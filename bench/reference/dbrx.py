"""Plain reference of DBRX (``databricks/dbrx-base``) as the port runs it:
the logits of chosen positions of each prompt after a prefill, in float32.

The model: per layer RMSNorm, grouped-query attention (48 query heads, 8
key/value heads of 128, rotary embeddings at theta 500,000, causal), added
to the residual; RMSNorm and a mixture of 16 SwiGLU experts, each token
routed to the top 4 of a softmax router with its gates renormalised over
the 4, each expert taking at most ``capacity`` tokens of a prompt
(``round_up(max(8, int(S · 4 · 1.25 / 16)), 8)``; the assignments in
token-major order, the later ones past an expert's capacity dropped),
added to the residual; a final RMSNorm and an untied head.  Departures from
the published model, which the port makes too: RMSNorm (eps 1e-6) in place
of LayerNorm, no ``clip_qkv``, and the capacity drops.

Weights are bfloat16 (as the configuration states), made again here from
the run's seed a layer at a time (``bench/weights.py``) and widened to
float32; the prompts go through each layer together, so each layer is made
once, and each expert runs once a layer over its kept tokens of every
prompt.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from bench import weights as W
from bench.reference.common import Rounding, float32_only, mm, rms_norm

ATTN_BLOCK = 512        # query rows a block of the attention's scores


def param_spec(c: Dict) -> List[W.Leaf]:
    """The parameters, by their paths in the port's tree: normal weights at
    1/sqrt(fan-in), the embedding at 1, the router at 0.02, norms at one."""
    d, h, hkv, dh, L, V = (c[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                          "d_head", "n_layers", "vocab_size"))
    e, dffe = c["n_experts"], c["d_ff_expert"]
    dt = c["param_dtype"]
    layer = ("layers", "pos0")

    def leaf(path, shape, init="normal", scale=1.0, stacked=True):
        return W.Leaf(path, shape, init, scale, stacked, dt)

    spec = [leaf(("embed",), (V, d), stacked=False),
            leaf(("final_norm",), (d,), "ones", stacked=False),
            leaf(("unembed",), (V, d), scale=d ** -0.5, stacked=False),
            leaf(layer + ("ln1",), (L, d), "ones"),
            leaf(layer + ("ln2",), (L, d), "ones"),
            leaf(layer + ("attn", "wq"), (L, d, h * dh), scale=d ** -0.5),
            leaf(layer + ("attn", "wk"), (L, d, hkv * dh), scale=d ** -0.5),
            leaf(layer + ("attn", "wv"), (L, d, hkv * dh), scale=d ** -0.5),
            leaf(layer + ("attn", "wo"), (L, h * dh, d),
                 scale=(h * dh) ** -0.5),
            leaf(layer + ("ffn", "router"), (L, d, e), scale=0.02),
            leaf(layer + ("ffn", "w_gate"), (L, e, d, dffe), scale=d ** -0.5),
            leaf(layer + ("ffn", "w_up"), (L, e, d, dffe), scale=d ** -0.5),
            leaf(layer + ("ffn", "w_down"), (L, e, dffe, d),
                 scale=dffe ** -0.5)]
    return sorted(spec, key=lambda lf: lf.path)


def capacity(c: Dict, n_tokens: int) -> int:
    cap = int(n_tokens * c["moe_top_k"] * c["capacity_factor"]
              / c["n_experts"])
    return -(-max(8, cap) // 8) * 8


def rotary(x, theta: float):
    """x (S, heads, D) rotated at positions 0..S-1 (halves split)."""
    s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(c: Dict, q: Rounding, p: Dict, x):
    s = x.shape[0]
    h, hkv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    qh = rotary(mm(q, x, p["wq"]).reshape(s, h, dh), c["rope_theta"])
    kh = rotary(mm(q, x, p["wk"]).reshape(s, hkv, dh), c["rope_theta"])
    vh = mm(q, x, p["wv"]).reshape(s, hkv, dh)
    group = h // hkv
    qh = q(qh).transpose(0, 1)                                 # (H, S, D)
    kh = q(kh).transpose(0, 1).repeat_interleave(group, 0)
    vh = q(vh).transpose(0, 1).repeat_interleave(group, 0)
    out = torch.empty_like(qh)
    pos = torch.arange(s, device=x.device)
    for lo in range(0, s, ATTN_BLOCK):
        hi = min(lo + ATTN_BLOCK, s)
        scores = (qh[:, lo:hi] @ kh[:, :hi].transpose(1, 2)) * dh ** -0.5
        future = pos[None, :hi] > pos[lo:hi, None]
        scores = scores.masked_fill(future, float("-inf"))
        out[:, lo:hi] = q(torch.softmax(scores, dim=-1)) @ vh[:, :hi]
    return mm(q, out.transpose(0, 1).reshape(s, h * dh), p["wo"])


def routed(c: Dict, q: Rounding, p: Dict, x):
    """One prompt's kept assignments: (token, expert, gate) of each
    assignment that its expert's capacity keeps."""
    s, _ = x.shape
    k = c["moe_top_k"]
    probs = torch.softmax(mm(q, x, p["router"]), dim=-1)
    expert = torch.argsort(-probs, dim=-1, stable=True)[:, :k]     # (S, k)
    gate = torch.gather(probs, -1, expert)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = expert.reshape(-1)                     # token-major assignments
    order = torch.argsort(flat, stable=True)
    first = torch.searchsorted(flat[order], flat[order], side="left")
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=x.device) - first
    keep = torch.nonzero(rank < capacity(c, s)).squeeze(-1)
    return keep // k, flat[keep], gate.reshape(-1)[keep]


def moe(c: Dict, q: Rounding, p: Dict, xs: List) -> List:
    """The expert layer on each prompt's tokens (``xs``: (S_i, d) each):
    each prompt routed under its own capacity, then each expert run once
    over its kept tokens of every prompt."""
    sizes = [x.shape[0] for x in xs]
    starts = [0]
    for n in sizes[:-1]:
        starts.append(starts[-1] + n)
    tok, exp, gate = (torch.cat(t) for t in zip(*(
        (r[0] + s0, r[1], r[2]) for s0, r in
        zip(starts, (routed(c, q, p, x) for x in xs)))))
    x_all = torch.cat(xs)
    out = torch.zeros_like(x_all)
    for j in range(c["n_experts"]):
        idx = torch.nonzero(exp == j).squeeze(-1)
        if idx.numel() == 0:
            continue
        rows = tok[idx]
        xt = x_all[rows]
        wg, wu, wd = (p[n][j].float() for n in ("w_gate", "w_up", "w_down"))
        y = mm(q, torch.nn.functional.silu(mm(q, xt, wg)) * mm(q, xt, wu),
               wd)
        out.index_add_(0, rows, y * gate[idx][:, None])
    return list(torch.split(out, sizes))


def logits_at(c: Dict, seed: int, prompts: List, positions: List, device,
              precision: str = "f32") -> List[torch.Tensor]:
    """Each prompt's float32 logits (len(positions[i]), vocab) at its
    ``positions`` after a prefill (prompts: host int32 arrays), from the
    weights of ``seed``."""
    float32_only()
    q = Rounding(precision)
    spec = {leaf.path: leaf for leaf in param_spec(c)}
    with torch.no_grad():
        embed = W.make_leaf(spec[("embed",)], seed, device)
        xs = [q(embed[torch.from_numpy(pr).to(device).long()].float())
              for pr in prompts]
        del embed
        layer_leaves = [path for path in spec if path[0] == "layers"]
        for i in range(c["n_layers"]):
            p: Dict = {}
            for path in layer_leaves:
                t = W.make_leaf(spec[path], seed, device, layer=i)
                W.set_path(p, path[2:], t if path[-1].startswith("w_")
                           else t.float())
            xs = [x + attention(c, q, p["attn"], rms_norm(x, p["ln1"]))
                  for x in xs]
            xs = [x + y for x, y in zip(xs, moe(
                c, q, p["ffn"], [rms_norm(x, p["ln2"]) for x in xs]))]
            del p
        norm = W.make_leaf(spec[("final_norm",)], seed, device).float()
        head = W.make_leaf(spec[("unembed",)], seed, device).float()
        return [mm(q, rms_norm(x[torch.as_tensor(pos, device=device)], norm),
                   head.T) for x, pos in zip(xs, positions)]


def served_gaps(logits: torch.Tensor, served) -> List[float]:
    """How far each served token's reference logit lies below the
    reference's best of its row."""
    tok = torch.as_tensor(list(served), device=logits.device).long()
    best = logits.max(dim=-1).values
    return [float(g) for g in best - logits.gather(1, tok[:, None])[:, 0]]


def rel_errors(got: torch.Tensor, want: torch.Tensor) -> List[float]:
    """Each row's ||got - want|| / ||want||."""
    got = got.to(want.device, torch.float32)
    return [float(e) for e in torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)]

"""Plain reference of RWKV6 ("Finch", arXiv:2404.05892) as the port runs it:
its training loss, gradients and AdamW steps, in float32.

The model: per layer a time mix (token shift by learned mixes, receptance,
key, value, gate and the data-dependent decay w = exp(-exp(x·W_w + b -
0.5)) clamped to [1e-6, 1 - 1e-6], the WKV recurrence with its bonus u,
RMSNorm of the heads' output gated by silu(g), an output projection) and a
channel mix (token shift, sigmoid receptance, squared-ReLU hidden layer),
each after an RMSNorm and added to the residual; a final RMSNorm and an
untied head.  Departures from the published model, which the port makes
too: RMSNorm (eps 1e-6) in place of LayerNorm and GroupNorm, and a decay
from one projection in place of the paper's low-rank one.

The WKV is computed by chunks, every chunk at once: within a chunk the
pairs s < t by their decays ``exp(ecum_t - cum_s)`` (never above 1), the
state entering each chunk as a sum over the earlier chunks weighted by the
decay between them (never above 1), and the bonus ``u`` on the diagonal.
Each row of the batch goes through the layers under
``torch.utils.checkpoint`` and its gradients add up, so the reference fits
beside its own AdamW state.  Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from bench import weights as W
from bench.reference import adamw
from bench.reference.common import Rounding, float32_only, mm, rms_norm

#: the WKV's chunk (the sums are the recurrence's whatever it is)
CHUNK = 64


def param_spec(c: Dict) -> List[W.Leaf]:
    """The parameters, by their paths in the port's tree, with the
    benchmark's initialisation: normal weights at 1/sqrt(fan-in), the
    token-shift mixes uniform in [0, 1), the decay's bias at a unit normal
    (decays from about 0.001 to 0.95), norms at one."""
    d, h, dh, dff, L, V = (c[k] for k in ("d_model", "n_heads", "d_head",
                                          "d_ff", "n_layers", "vocab_size"))
    hd = h * dh
    dt = c["param_dtype"]
    layer = ("layers", "pos0")

    def leaf(path, shape, init="normal", scale=1.0, stacked=True):
        return W.Leaf(path, shape, init, scale, stacked, dt)

    spec = [leaf(("embed",), (V, d), stacked=False),
            leaf(("final_norm",), (d,), "ones", stacked=False),
            leaf(("unembed",), (V, d), scale=d ** -0.5, stacked=False),
            leaf(layer + ("ln1",), (L, d), "ones"),
            leaf(layer + ("ln2",), (L, d), "ones")]
    mix = layer + ("rwkv",)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        spec.append(leaf(mix + (name,), (L, d), "uniform"))
    for name in ("wr", "wk", "wv", "wg"):
        spec.append(leaf(mix + (name,), (L, d, hd), scale=d ** -0.5))
    spec += [leaf(mix + ("ww",), (L, d, hd), scale=0.01),
             leaf(mix + ("w_bias",), (L, hd), scale=1.0),
             leaf(mix + ("u",), (L, h, dh), scale=0.5),
             leaf(mix + ("wo",), (L, hd, d), scale=hd ** -0.5),
             leaf(mix + ("out_norm",), (L, hd), "ones")]
    ffn = layer + ("ffn",)
    spec += [leaf(ffn + ("mu_cm",), (L, d), "uniform"),
             leaf(ffn + ("w_rcm",), (L, d, d), scale=d ** -0.5),
             leaf(ffn + ("w_in",), (L, d, dff), scale=d ** -0.5),
             leaf(ffn + ("w_out",), (L, dff, d), scale=dff ** -0.5)]
    return sorted(spec, key=lambda lf: lf.path)


def wkv(r, k, v, w, u, chunk: int):
    """The WKV output (H, T, V) of one row: r, k, w (H, T, K), v (H, T, V),
    u (H, K); every chunk at once."""
    h, t, kk = r.shape
    vv = v.shape[-1]
    c = min(chunk, t)
    n = t // c
    r, k, w = (x.reshape(h, n, c, kk) for x in (r, k, w))
    v = v.reshape(h, n, c, vv)
    logw = torch.log(w)
    cum = torch.cumsum(logw, dim=2)                 # inclusive, in-chunk
    ecum = cum - logw                               # exclusive
    idx = torch.arange(c, device=r.device)
    lower = (idx[:, None] > idx[None, :])[:, :, None]          # s < t
    # within a chunk: A[t, s] = Σ_k r_t k_s exp(ecum_t - cum_s), s < t
    expo = (ecum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~lower, float("-inf"))
    a = (r[:, :, :, None, :] * k[:, :, None, :, :] * torch.exp(expo)).sum(-1)
    o = a @ v + (r * u[:, None, None, :] * k).sum(-1, keepdim=True) * v
    # between chunks: the state entering chunk m sums chunk j < m's
    # contribution decayed by the chunks in between
    last = cum[:, :, -1, :]                                      # (H, N, K)
    contrib = (k * torch.exp(last[:, :, None, :] - cum)).transpose(-1, -2) @ v
    before = torch.cumsum(last, dim=1) - last       # Σ_{i<m} last_i
    after = before + last                           # Σ_{i<=j} last_i
    jm = torch.arange(n, device=r.device)
    earlier = (jm[None, :] < jm[:, None])[:, :, None]           # (m, j, 1)
    gap = (before[:, :, None, :] - after[:, None, :, :]).masked_fill(
        ~earlier, float("-inf"))                                 # (H,m,j,K)
    state = torch.einsum("hmjk,hjkv->hmkv", torch.exp(gap), contrib)
    o = o + (r * torch.exp(ecum)) @ state
    return o.reshape(h, t, vv)


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _layer(c: Dict, q: Rounding, p: Dict, x):
    """One layer on one row x (T, d)."""
    h, dh = c["n_heads"], c["d_head"]
    t = x.shape[0]
    m = p["rwkv"]
    hn = rms_norm(x, p["ln1"])
    prev = _shift(hn)

    def lerp(mu):
        return hn + (prev - hn) * mu

    r, k, v, g = (mm(q, lerp(m[f"mu_{n}"]), m[f"w{n}"]) for n in "rkvg")
    wraw = mm(q, lerp(m["mu_w"]), m["ww"]) + m["w_bias"]
    w = torch.clamp(torch.exp(-torch.exp(wraw - 0.5)), 1e-6, 1 - 1e-6)

    def heads(z):
        return z.reshape(t, h, dh).transpose(0, 1)

    o = wkv(q(heads(r)), q(heads(k)), q(heads(v)), heads(w), m["u"], CHUNK)
    o = o.transpose(0, 1).reshape(t, h * dh)
    o = rms_norm(o, m["out_norm"]) * torch.nn.functional.silu(g)
    x = x + mm(q, o, m["wo"])
    f = p["ffn"]
    h2 = rms_norm(x, p["ln2"])
    xk = h2 + (_shift(h2) - h2) * f["mu_cm"]
    rgate = torch.sigmoid(mm(q, xk, f["w_rcm"]))
    hidden = torch.square(torch.relu(mm(q, xk, f["w_in"])))
    return x + rgate * mm(q, hidden, f["w_out"])


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """A stacked tree as one tree a layer, every leaf unbound at once (its
    backward stacks the layers' gradients in one pass)."""
    out: List[Dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def row_loss(c: Dict, q: Rounding, params: Dict, tokens, labels):
    """Mean cross-entropy of one row (T,) through every layer."""
    x = q(params["embed"][tokens.long()])
    for layer in _unstack(params["layers"]["pos0"], c["n_layers"]):
        x = torch.utils.checkpoint.checkpoint(
            lambda x_, p_=layer: _layer(c, q, p_, x_), x,
            use_reentrant=False, preserve_rng_state=False)
    xn = rms_norm(x, params["final_norm"])
    logits = mm(q, xn, params["unembed"].T)
    return torch.nn.functional.cross_entropy(logits, labels.long())


def norms(tree: Dict) -> Dict:
    """Each leaf's float32 norm, by path."""
    return {"/".join(p): float(torch.linalg.vector_norm(t.float()))
            for p, t in W.leaves(tree)}


def train_readings(c: Dict, seed: int, batches: List[Dict], opt: Dict,
                   device, precision: str = "f32", rows=None,
                   against: Optional[Dict] = None,
                   keep_first: bool = False) -> Dict:
    """The reference's readings of the program's first steps: from the
    weights of ``seed`` (made again here), ``len(batches)`` steps of loss,
    gradients and AdamW on the given host batches; each step's loss, each
    leaf's first gradient as the optimizer takes it (after clipping) and
    its RMS, and each leaf's change after the last step.  ``rows`` keeps
    those rows of each batch (a fault's reading: a step that leaves half
    of its batch out).  ``against``, first gradients (clipped, on the host)
    of the side judged, gives each leaf's ||theirs - ours|| as well;
    ``keep_first`` returns ours on the host."""
    float32_only()
    q = Rounding(precision)
    spec = param_spec(c)
    params = {}
    for leaf in spec:
        W.set_path(params, leaf.path, W.make_leaf(
            leaf, seed, device).float().requires_grad_(True))
    flat = list(W.leaves(params))
    cfg = adamw.Config(**opt)
    state = adamw.init([p for _, p in flat])
    losses, first, first_rms, diffs, kept = [], {}, {}, {}, {}
    for step, batch in enumerate(batches, start=1):
        tok = torch.from_numpy(batch["tokens"]).to(device)
        lab = torch.from_numpy(batch["labels"]).to(device)
        keep = range(tok.shape[0]) if rows is None else rows
        total = 0.0
        for i in keep:
            loss = row_loss(c, q, params, tok[i], lab[i]) / len(keep)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        grads = [p.grad for _, p in flat]
        scale = adamw.update(cfg, step, [p for _, p in flat], grads, state)
        if step == 1:
            first_scale = scale
            for (path, p), g in zip(flat, grads):
                key = "/".join(path)
                first[key] = float(torch.linalg.vector_norm(g)) * scale
                first_rms[key] = first[key] / math.sqrt(g.numel())
                if against is not None:
                    theirs = against[key].to(device, torch.float32)
                    diffs[key] = float(torch.linalg.vector_norm(
                        theirs - g * scale))
                    del theirs
                if keep_first:
                    kept[key] = (g * scale).cpu()
        for _, p in flat:
            p.grad = None
    change = {}
    with torch.no_grad():
        for leaf in spec:
            p0 = W.make_leaf(leaf, seed, device).float()
            p = dict(flat)[leaf.path]
            change["/".join(leaf.path)] = float(
                torch.linalg.vector_norm(p - p0))
            del p0
    del params, flat, state
    return {"losses": losses, "grad_norms": first, "grad_rms": first_rms,
            "change_norms": change, "grad_diffs": diffs, "first": kept,
            "clip_scale": first_scale}

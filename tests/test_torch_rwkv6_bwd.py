"""Port parity, K6's backward: ``repro_torch`` on the CPU against ``repro``.

* ``rwkv6_bwd_plain`` (the autograd of K6's plain version, which
  ``rwkv6_bwd`` runs on CPU tensors) against ``jax.vjp`` of the reference's
  ``rwkv6_chunked_jnp`` for dr, dk, dv, dw and du: hymba-like heads (K 16,
  V 64, u = 0) and rwkv-like heads (K = V = 64, learned u), one chunk and
  several, with and without a cotangent of the final state, and the extreme
  decays of ``test_extreme_decay_stable``;
* the chunked formulas that ``csrc/rwkv6_scan_bwd.cu`` implements, written
  here in plain torch (``_chunked_backward``), against that autograd;
* ``_Rwkv6``, the autograd Function of the card, driven on CPU tensors with
  its two launch functions replaced by the plain versions, alone and under
  reduced rwkv6-1.6b and hymba-1.5b with remat.

Tolerances.  dr, dk, dv and du: ‖Δ‖ ≤ 2e-4 ‖ref‖ (the forward's 2e-4;
sums in another order).  dw: both packages form it in float32 as a
difference of two suffix sums of r·dr and k·dk over a chunk, divided by w;
the sums are of order one where their difference is of order w, so their
rounding, divided by w, is about 1e-2 of dw in relative norm at random
decays (``test_plain_dw_is_ill_conditioned_in_float32``).  So dw is held as
w·dw, which is well conditioned, at the same 2e-4 in relative norm; at the
extreme decay 1e-6, where w·dw is itself of order w and so below the
rounding of those sums, to within 4 float32 ulps of the largest such chunk
sum.  The kernel's formulas leave w out of every pair instead of dividing
by it; they are held in float32 to the autograd on float64 copies at the
card's limit, 1e-4 in relative norm for all five.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.ssm as RS
import repro_torch.kernels.rwkv6_scan as PK
from repro_torch.models.params import _walk

GRAD_REL = 2e-4
DW_ULPS = 4
KERNEL_REL = 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du")


def _inputs(seed, b, h, t, kk, vv, *, w_val=None, u_zero=False):
    """r, k, v, w, u, do, dstate as float32 numpy arrays; w as the models
    make it, exp(-exp(x - 0.5)) clamped to [1e-6, 1 - 1e-6], or ``w_val``."""
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((b, h, t, kk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, t, vv)).astype(np.float32)
    if w_val is None:
        w = np.exp(-np.exp(rng.standard_normal((b, h, t, kk)) - 0.5))
        w = np.clip(w, 1e-6, 1 - 1e-6).astype(np.float32)
    else:
        w = np.full((b, h, t, kk), w_val, np.float32)
    u = rng.standard_normal((h, kk)).astype(np.float32)
    if u_zero:
        u = np.zeros_like(u)
    do = rng.standard_normal((b, h, t, vv)).astype(np.float32)
    ds = rng.standard_normal((b, h, kk, vv)).astype(np.float32)
    return r, k, v, w, u, do, ds


def _rel(got, want):
    got, want = (torch.as_tensor(np.array(x)).double() for x in (got, want))
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def _reference(args, chunk, with_ds):
    r, k, v, w, u, do, ds = args
    _, vjp = jax.vjp(lambda *a: RS.rwkv6_chunked_jnp(*a, chunk=chunk),
                     *(jnp.asarray(x) for x in (r, k, v, w, u)))
    return vjp((jnp.asarray(do),
                jnp.asarray(ds if with_ds else np.zeros_like(ds))))


def _chunk_scale(r, k, dr, dk, chunk):
    """The largest sum over a chunk of |r dr| + |k dk|: the size of the two
    suffix sums whose difference w dw is."""
    b, h, t, kk = r.shape
    terms = (np.abs(r * dr) + np.abs(k * dk)).reshape(b, h, t // chunk,
                                                        chunk, kk)
    return float(terms.sum(axis=3).max())


# (label, B, H, T, K, V, chunk, u = 0, dstate, w_val)
CASES = [
    ("hymba heads, one chunk", 2, 3, 64, 16, 64, 64, True, True, None),
    ("hymba heads, 4 chunks", 1, 2, 256, 16, 64, 64, True, True, None),
    ("hymba heads, no dstate", 1, 2, 192, 16, 64, 64, True, False, None),
    ("rwkv heads, one chunk", 1, 2, 64, 64, 64, 64, False, True, None),
    ("rwkv heads, 3 chunks", 2, 2, 96, 64, 64, 32, False, True, None),
    ("rwkv heads, no dstate", 1, 2, 128, 64, 64, 32, False, False, None),
    ("extreme decay 1e-6", 1, 1, 32, 4, 4, 16, False, True, 1e-6),
    ("extreme decay 1 - 1e-6", 1, 1, 32, 4, 4, 16, False, True, 1 - 1e-6),
]


@pytest.mark.parametrize("label,b,h,t,kk,vv,chunk,u_zero,with_ds,w_val",
                         CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_vjp(label, b, h, t, kk, vv, chunk,
                                        u_zero, with_ds, w_val):
    args = _inputs(len(label) + t, b, h, t, kk, vv, w_val=w_val,
                   u_zero=u_zero)
    r, k, v, w, u, do, ds = args
    got = PK.rwkv6_bwd(*(torch.from_numpy(x) for x in args[:6]),
                       torch.from_numpy(ds) if with_ds else None,
                       chunk=chunk)
    want = [np.asarray(x) for x in _reference(args, chunk, with_ds)]
    for name, g, x, inp in zip(NAMES, got, want, (r, k, v, w, u)):
        assert g.dtype == torch.float32 and tuple(g.shape) == inp.shape
        assert torch.isfinite(g).all(), name
        if name != "dw":
            assert _rel(g, x) <= GRAD_REL, (name, _rel(g, x))
    wdw, wdw_ref = w * got[3].numpy(), w * want[3]
    if w_val == 1e-6:
        # w dw is of order w here, below the float32 rounding of the two
        # suffix sums it is the difference of: a few ulps of those sums
        scale = _chunk_scale(r, k, want[0], want[1], chunk)
        err = np.abs(wdw - wdw_ref).max()
        assert err <= DW_ULPS * np.finfo(np.float32).eps * scale, (err, scale)
    else:
        assert _rel(wdw, wdw_ref) <= GRAD_REL, ("w dw", _rel(wdw, wdw_ref))


def test_plain_dw_is_ill_conditioned_in_float32():
    """A reading that the tolerance above rests on: at random decays the
    float32 autograd's dw is about 1e-2 off its float64 value in relative
    norm, while w dw is within 1e-5."""
    args = [torch.from_numpy(x) for x in _inputs(5, 1, 2, 256, 16, 64)]
    f32 = PK.rwkv6_bwd_plain(*args, chunk=64)
    f64 = PK.rwkv6_bwd_plain(*(x.double() for x in args), chunk=64)
    w = args[3].double()
    assert _rel(f32[3], f64[3]) > 1e-3
    assert _rel(w * f32[3], w * f64[3]) < 1e-5
    for g, x in zip(f32[:3], f64[:3]):
        assert _rel(g, x) < 1e-5


def test_plain_version_runs_in_float64():
    args = [torch.from_numpy(x) for x in _inputs(6, 1, 2, 96, 8, 12)[:5]]
    o32, s32 = PK.rwkv6_plain(*args, chunk=32)
    o64, s64 = PK.rwkv6_plain(*(x.double() for x in args), chunk=32)
    assert o64.dtype == s64.dtype == torch.float64
    assert o32.dtype == s32.dtype == torch.float32
    torch.testing.assert_close(o64.float(), o32, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s64.float(), s32, rtol=1e-5, atol=1e-5)


def _chunked_backward(r, k, v, w, u, do, dstate, chunk):
    """K6's backward as ``csrc/rwkv6_scan_bwd.cu`` computes it, in plain
    torch (float32, or float64 for float64 inputs), every chunk at once:

    a. chunk-local: cum and ecum in token order, A, dA = do v^T (s < t), db,
       the intra-chunk dr, dk (one exponential per (t, s, k)), dv = A^T do +
       bonus do, each chunk's share of du, Q_c = (r e^{ecum})^T do, U_c =
       (k e^{L - cum})^T v and d_c = e^{L};
    b. the forward's scan (the state entering each chunk) and the reverse
       scan G_{c-1} = d_c G_c + Q_c from G_{NC-1} = dstate (or 0);
    c. inter-chunk: dr += e^{ecum} (do S^T), dk += e^{L - cum} (v G^T),
       dv += (k e^{L - cum}) G;
    d. dw without dividing by w: the intra pairs by the recurrence
       M_{j+1}[t] = w_j M_j[t] + e^{ecum_{j+1} - cum_j} dA_tj k_j, then
       e^{ecum_j} Y_j (later tokens against the entering state, Y backwards)
       and e^{L - cum_j} Z_j (earlier tokens and the entering state against
       later chunks, Z forwards from sum_v S G).
    Also returns dlogw by the identity sum_{t>j} r dr° - sum_{s>=j} k dk° +
    sum_v S_c G_c (dr°, dk° without the bonus; S_c the state leaving the
    chunk), the form the kernel avoids in float32."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    nc = t // chunk
    f = torch.float64 if r.dtype == torch.float64 else torch.float32

    def chunks(x, n):
        return x.to(f).reshape(b, h, nc, chunk, n)

    R, K, W = (chunks(x, kk) for x in (r, k, w))
    V, DO = chunks(v, vv), chunks(do, vv)
    lw = torch.log(W)
    cum = torch.cumsum(lw, dim=3)
    ecum = cum - lw
    last = cum[..., -1:, :]
    idx = torch.arange(chunk)
    low = idx[:, None] > idx[None, :]                       # s < t
    zero = torch.zeros((), dtype=f)
    # a. chunk-local; masked pairs are zero by a condition
    expo = torch.where(low[:, :, None],
                       ecum[..., :, None, :] - cum[..., None, :, :], zero)
    pair = torch.where(low[:, :, None], torch.exp(expo), zero)  # (t, s, K)
    a = (R[..., :, None, :] * K[..., None, :, :] * pair).sum(-1)
    bonus = (R * u.to(f)[None, :, None, None, :] * K).sum(-1)
    da = torch.where(low, DO @ V.transpose(-1, -2), zero)
    db = (DO * V).sum(-1)
    dr_in = (da[..., None] * K[..., None, :, :] * pair).sum(-2)
    dk_in = (da[..., None] * R[..., :, None, :] * pair).sum(-3)
    dv = a.transpose(-1, -2) @ DO + bonus[..., None] * DO
    du = (R * K * db[..., None]).sum(-2).sum(dim=(0, 2))
    q = (R * torch.exp(ecum)).transpose(-1, -2) @ DO
    kd = K * torch.exp(last - cum)
    contrib = kd.transpose(-1, -2) @ V
    decay = torch.exp(last[..., 0, :])                      # (B, H, NC, K)
    # b. the two scans
    s = torch.zeros((b, h, kk, vv), dtype=f)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + contrib[:, :, c]
    s_in = torch.stack(s_in, dim=2)
    s_out = torch.cat([s_in[:, :, 1:], s[:, :, None]], dim=2)
    g = torch.zeros((b, h, kk, vv), dtype=f) if dstate is None \
        else dstate.to(f)
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, :, c, :, None] * g + q[:, :, c]
    gs = torch.stack(gs, dim=2)
    # c. inter-chunk
    iota = DO @ s_in.transpose(-1, -2)                      # do S^T
    sig = V @ gs.transpose(-1, -2)                          # v G^T
    dr0 = dr_in + torch.exp(ecum) * iota
    dk0 = dk_in + torch.exp(last - cum) * sig
    dv = dv + kd @ gs
    ub = u.to(f)[None, :, None, None, :] * db[..., None]
    dr = dr0 + ub * K
    dk = dk0 + ub * R
    # d. dw, w left out of every pair
    dw = torch.zeros_like(R)
    m = torch.zeros_like(R)                                 # M_j[t]
    for j in range(chunk):
        later = (idx > j)[:, None]
        e = torch.exp(torch.where(later, ecum - cum[..., j:j + 1, :], zero))
        dw[..., j, :] = torch.where(later, R * e * m, zero).sum(-2)
        if j + 1 < chunk:
            fj = torch.exp(ecum[..., j + 1, :] - cum[..., j, :])
            m = torch.where(later, W[..., j:j + 1, :] * m
                            + (fj * K[..., j, :])[..., None, :]
                            * da[..., :, j, None], m)
    rio, ksg = R * iota, K * sig
    y = torch.zeros_like(rio[..., 0, :])
    z = (s_in * gs).sum(-1)
    ys, zs = torch.zeros_like(R), torch.zeros_like(R)
    for j in reversed(range(chunk)):
        ys[..., j, :] = y
        if j > 0:
            y = W[..., j, :] * y + torch.exp(
                ecum[..., j, :] - cum[..., j - 1, :]) * rio[..., j, :]
    for j in range(chunk):
        zs[..., j, :] = z
        if j + 1 < chunk:
            z = W[..., j, :] * z + torch.exp(
                ecum[..., j + 1, :] - cum[..., j, :]) * ksg[..., j, :]
    dw = dw + torch.exp(ecum) * ys + torch.exp(last - cum) * zs
    # the dlogw identity
    rdr, kdk = R * dr0, K * dk0
    dlogw = (torch.flip(torch.cumsum(torch.flip(rdr, [3]), 3), [3]) - rdr
             - torch.flip(torch.cumsum(torch.flip(kdk, [3]), 3), [3])
             + (s_out * gs).sum(-1)[..., None, :])

    def whole(x, n):
        return x.reshape(b, h, t, n)

    return (whole(dr, kk), whole(dk, kk), whole(dv, vv), whole(dw, kk),
            du), whole(dlogw, kk)


SUB = 16


def _subchunk_backward(r, k, v, w, u, do, dstate, chunk, exponents=None):
    """K6's backward as the ``"mma"`` route of ``csrc/rwkv6_scan_bwd.cu``
    computes it, in plain torch (float32, or float64 for float64 inputs):
    every pair term of a chunk through the boundaries of sub-chunks of 16
    tokens, so that every exponent is <= 0 and only pairs inside one
    sub-chunk take an exponential each.  With cx the chunk's cumsum of log w
    shifted one row down (cx[t] = ecum_t, cx[t + 1] = cum_t, cx[0] = 0), for
    sub-chunk J (first token J0, cq = cx[J0], ce = cx[J0 + 16]):

    a. Q_c, U_c and d_c as the first design;  b. the two scans;
    c. A inside a sub-chunk one exponential per (t, s, k), across
       sub-chunks Rf Kf^T with Rf = r e^{cx[t] - cx[T0]} and Kf^(T) =
       k e^{cx[T0] - cx[s+1]}; dv = (A^T + diag bonus) do + (k e^{L-cum}) G;
       P^(J) = dA[>= J0, < J0] Kf^(J), B^(J) = dA[> eJ, J]^T Rg^(J) with
       Rg^(J) = r e^{cx[t] - ce};  F' = P^(J) + e^{cq} do S^T on J's rows,
       B' = B^(J) + e^{L - ce} v G^T;  X'_J the pairs that span J, the
       entering state and the leaving gradient included;
    d. per sub-chunk, j in order: M_j[t] = sum_{J0<=s<j} dA_ts k_s
       e^{cx[j]-cx[s+1]}, N_j = sum_{J0<=s<j} k_s e^{cx[j]-cx[s+1]} B'_s and
       rt_f[t] = r_t e^{cx[t]-cx[j+1]} (t in J after j):
         dr_j = e^{cx[j]-cq} F'_j + M_j[j] + u k_j db_j
         dk_j = e^{ce-cx[j+1]} B'_j + sum_t dA_tj rt_f[t] + u r_j db_j
         dw_j = e^{ce-cx[j+1]} N_j                                  (ii)
              + e^{cx[j]-cq} sum_t rt_f[t] F'_t                      (iii)
              + sum_t rt_f[t] M_j[t]                                 (iv)
              + e^{(ce-cx[j+1]) + (cx[j]-cq)} X'_J                   (i)
    w_j is left out of every pair; nothing divides by w.  Every exponent
    evaluated is appended to ``exponents`` (its largest element) when a list
    is given."""
    b, h, t, kk = r.shape
    vv = v.shape[-1]
    nc = t // chunk
    nsb = chunk // SUB
    f = torch.float64 if r.dtype == torch.float64 else torch.float32

    def ex(a):
        if exponents is not None and a.numel():
            exponents.append(a.max().item())
        return torch.exp(a)

    def chunks(x, n):
        return x.to(f).reshape(b, h, nc, chunk, n)

    R, K, W = (chunks(x, kk) for x in (r, k, w))
    V, DO = chunks(v, vv), chunks(do, vv)
    uf = u.to(f)[None, :, None, :]                       # (1, H, 1, K)
    cum = torch.cumsum(torch.log(W), dim=3)
    cx = torch.cat([torch.zeros_like(cum[..., :1, :]), cum], dim=3)
    last = cx[..., chunk, :]
    # a. and b.
    q = (R * ex(cx[..., :chunk, :])).transpose(-1, -2) @ DO
    kd = K * ex(last[..., None, :] - cx[..., 1:, :])
    contrib = kd.transpose(-1, -2) @ V
    decay = ex(last)
    s = torch.zeros((b, h, kk, vv), dtype=f)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + contrib[:, :, c]
    s_in = torch.stack(s_in, dim=2)
    g = torch.zeros((b, h, kk, vv), dtype=f) if dstate is None \
        else dstate.to(f)
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, :, c, :, None] * g + q[:, :, c]
    gs = torch.stack(gs, dim=2)
    # c. A, with the bonus on the diagonal of A^T; dv
    idx = torch.arange(chunk)
    a = torch.zeros((b, h, nc, chunk, chunk), dtype=f)
    low = (idx[:SUB, None] > idx[None, :SUB])[:, :, None]    # s < t
    for jb in range(nsb):
        j0, j1 = jb * SUB, (jb + 1) * SUB
        expo = torch.where(low, cx[..., j0:j1, None, :]
                           - cx[..., None, j0 + 1:j1 + 1, :], 0.0)
        a[..., j0:j1, j0:j1] = torch.where(
            low, R[..., j0:j1, None, :] * K[..., None, j0:j1, :]
            * ex(expo), 0.0).sum(-1)
        if jb:
            rf = R[..., j0:j1, :] * ex(cx[..., j0:j1, :]
                                       - cx[..., j0:j0 + 1, :])
            kf = K[..., :j0, :] * ex(cx[..., j0:j0 + 1, :]
                                     - cx[..., 1:j0 + 1, :])
            a[..., j0:j1, :j0] = rf @ kf.transpose(-1, -2)
    bonus = (R * uf[..., None, :] * K).sum(-1)
    at = a.transpose(-1, -2) + torch.diag_embed(bonus)
    dv = at @ DO + kd @ gs
    du = (R * K * (DO * V).sum(-1)[..., None]).sum(-2).sum(dim=(0, 2))
    da = DO @ V.transpose(-1, -2)
    db = torch.diagonal(da, dim1=-2, dim2=-1)
    dos = DO @ s_in.transpose(-1, -2)                    # do S^T
    vg = V @ gs.transpose(-1, -2)                        # v G^T
    pi = (s_in * gs).sum(-1)
    fp, bp = torch.empty_like(R), torch.empty_like(R)
    xp = []
    for jb in range(nsb):
        j0, j1 = jb * SUB, (jb + 1) * SUB
        cq, ce = cx[..., j0:j0 + 1, :], cx[..., j1:j1 + 1, :]
        kf = K[..., :j0, :] * ex(cq - cx[..., 1:j0 + 1, :])
        rg = R[..., j1:, :] * ex(cx[..., j1:chunk, :] - ce)
        p = da[..., j0:, :j0] @ kf                       # rows t >= J0
        bj = da[..., j1:, j0:j1].transpose(-1, -2) @ rg
        fp[..., j0:j1, :] = p[..., :SUB, :] + ex(cq) * dos[..., j0:j1, :]
        tail = ex(last[..., None, :] - ce)
        bp[..., j0:j1, :] = bj + tail * vg[..., j0:j1, :]
        xp.append((rg * (p[..., SUB:, :] + ex(cq) * dos[..., j1:, :])
                   ).sum(-2, keepdim=True)
                  + tail * ((kf * vg[..., :j0, :]).sum(-2, keepdim=True)
                            + ex(cq) * pi[..., None, :]))
    # d. each sub-chunk, j in order
    dr, dk, dw = (torch.empty_like(R) for _ in range(3))
    for jb in range(nsb):
        j0, j1 = jb * SUB, (jb + 1) * SUB
        cq, ce = cx[..., j0, :], cx[..., j1, :]
        m = torch.zeros_like(R[..., j0:j1, :])
        n = torch.zeros_like(R[..., 0, :])
        for jj in range(SUB):
            j = j0 + jj
            cj, ej = cx[..., j + 1, :], cx[..., j, :]
            lt = slice(j + 1, j1)                        # t in J after j
            rt = R[..., lt, :] * ex(cx[..., lt, :] - cj[..., None, :])
            dat = da[..., lt, j, None]
            bon = uf * db[..., j, None]
            dr[..., j, :] = ex(ej - cq) * fp[..., j, :] + m[..., jj, :] \
                + bon * K[..., j, :]
            dk[..., j, :] = ex(ce - cj) * bp[..., j, :] \
                + (dat * rt).sum(-2) + bon * R[..., j, :]
            dw[..., j, :] = ex(ce - cj) * n \
                + ex(ej - cq) * (rt * fp[..., lt, :]).sum(-2) \
                + (rt * m[..., jj + 1:, :]).sum(-2) \
                + ex((ce - cj) + (ej - cq)) * xp[jb][..., 0, :]
            dec = ex(cj - ej)[..., None, :]
            m[..., jj + 1:, :] = dec * m[..., jj + 1:, :] \
                + dat * K[..., j, None, :]
            n = dec[..., 0, :] * n + K[..., j, :] * bp[..., j, :]

    def whole(x, n):
        return x.reshape(b, h, t, n)

    return (whole(dr, kk), whole(dk, kk), whole(dv, vv), whole(dw, kk),
            du)


def test_subchunk_formulas_match_the_first_design_in_float64():
    """The sub-chunk factorisation is the same sum as the first design's
    formulas, term for term up to float64 rounding."""
    for seed, (b, h, t, kk, vv, chunk, w_val) in enumerate([
            (1, 2, 256, 16, 64, 64, None), (2, 2, 96, 64, 24, 32, None),
            (1, 1, 64, 8, 8, 16, 1 - 1e-6), (1, 2, 128, 8, 16, 64, 1e-3)]):
        args = [torch.from_numpy(x).double() for x in _inputs(
            40 + seed, b, h, t, kk, vv, w_val=w_val)]
        got = _subchunk_backward(*args[:7], chunk)
        want, _ = _chunked_backward(*args[:7], chunk)
        for name, g, x in zip(NAMES, got, want):
            assert _rel(g, x) <= 1e-10, (name, seed, _rel(g, x))


def test_subchunk_exponents_are_never_above_zero():
    """No exponent the route evaluates is above 0, so nothing overflows;
    at w = 1e-6 and C = 64 (|cum| near 884) nothing is inf or NaN."""
    args = [torch.from_numpy(x) for x in _inputs(
        44, 1, 2, 128, 16, 32, w_val=1e-6)]
    seen = []
    got = _subchunk_backward(*args[:7], 64, exponents=seen)
    assert seen and max(seen) <= 0.0
    assert all(torch.isfinite(g).all() for g in got)
    seen.clear()
    args = [torch.from_numpy(x) for x in _inputs(45, 1, 2, 128, 16, 32)]
    _subchunk_backward(*args[:7], 64, exponents=seen)
    assert max(seen) <= 0.0


def test_bwd_route_rule():
    """``"mma"`` for bfloat16 r, k, v with K a multiple of 8 up to 64 and a
    chunk a multiple of 16 up to 64; ``"fma"`` for everything else."""
    bf, f32 = torch.bfloat16, torch.float32
    for kk in (8, 16, 24, 64):
        for chunk in (16, 32, 48, 64):
            assert PK.bwd_route(bf, kk, chunk) == "mma"
            assert PK.bwd_route(f32, kk, chunk) == "fma"
    for kk, chunk in ((4, 64), (12, 64), (16, 12), (16, 40), (72, 64),
                      (64, 80), (16, 8)):
        assert PK.bwd_route(bf, kk, chunk) == "fma", (kk, chunk)


def test_k6_bwd_refuses_a_route_the_shape_does_not_take():
    """``_k6_bwd``'s private ``route``: ``"mma"`` takes bfloat16 r, k, v
    only, and no other name is a route; both raise before any build."""
    r, k, v, w, u, do, _ = (torch.from_numpy(x) for x in _inputs(
        46, 1, 1, 64, 16, 16))
    with pytest.raises(ValueError, match="takes bfloat16"):
        PK._k6_bwd(r, k, v, w, u, do, None, 64, route="mma")
    with pytest.raises(ValueError, match="unknown route"):
        PK._k6_bwd(*(x.to(torch.bfloat16) for x in (r, k, v)), w, u, do,
                   None, 64, route="wgmma")


KERNEL_CASES = [
    ("hymba heads, 4 chunks", 1, 2, 256, 16, 64, 64, True, True, None),
    ("rwkv heads, 3 chunks, no dstate", 1, 2, 96, 64, 64, 32, False, False,
     None),
    ("V tail, K 8", 2, 3, 160, 8, 40, 32, False, True, None),
    ("T < chunk", 1, 2, 12, 16, 8, 12, False, True, None),
    ("extreme decay 1e-6, full chunk", 1, 2, 256, 16, 64, 64, False, True,
     1e-6),
    ("extreme decay 1 - 1e-6", 1, 1, 32, 4, 4, 16, False, True, 1 - 1e-6),
]


@pytest.mark.parametrize("label,b,h,t,kk,vv,chunk,u_zero,with_ds,w_val",
                         KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_kernel_formulas_match_plain_autograd(label, b, h, t, kk, vv, chunk,
                                              u_zero, with_ds, w_val):
    args = [torch.from_numpy(x) for x in _inputs(
        len(label) + 7 * t, b, h, t, kk, vv, w_val=w_val, u_zero=u_zero)]
    ds = args[6] if with_ds else None
    got, dlogw = _chunked_backward(*args[:6], ds, chunk)
    want = PK.rwkv6_bwd_plain(*(x.double() for x in args[:6]),
                              None if ds is None else ds.double(),
                              chunk=chunk)
    for name, g, x in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, x) <= KERNEL_REL, (name, _rel(g, x))
    # the identity, in float64: the chunked sums give w dw exactly
    got64, dlogw64 = _chunked_backward(*(x.double() for x in args[:6]),
                                       None if ds is None else ds.double(),
                                       chunk)
    w64 = args[3].double()
    assert torch.allclose(dlogw64.double(), w64 * want[3], rtol=1e-5,
                          atol=1e-5 * (w64 * want[3]).abs().max().item())
    assert torch.isfinite(dlogw).all()


SUBCHUNK_CASES = [c for c in KERNEL_CASES if c[6] % SUB == 0]


@pytest.mark.parametrize("label,b,h,t,kk,vv,chunk,u_zero,with_ds,w_val",
                         SUBCHUNK_CASES, ids=[c[0] for c in SUBCHUNK_CASES])
def test_subchunk_formulas_match_plain_autograd(label, b, h, t, kk, vv,
                                                chunk, u_zero, with_ds,
                                                w_val):
    """The mma route's formulas in float32 against the plain autograd on
    float64 copies, at the card's float32 limit."""
    args = [torch.from_numpy(x) for x in _inputs(
        len(label) + 7 * t, b, h, t, kk, vv, w_val=w_val, u_zero=u_zero)]
    ds = args[6] if with_ds else None
    got = _subchunk_backward(*args[:6], ds, chunk)
    want = PK.rwkv6_bwd_plain(*(x.double() for x in args[:6]),
                              None if ds is None else ds.double(),
                              chunk=chunk)
    for name, g, x in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert _rel(g, x) <= KERNEL_REL, (name, _rel(g, x))


def _cpu_launches(monkeypatch):
    """``_Rwkv6``'s two launch functions replaced by the plain versions."""
    calls = {"forward": 0, "backward": 0}

    def fwd(r, k, v, w, u, chunk):
        calls["forward"] += 1
        return PK.rwkv6_plain(r, k, v, w, u, chunk=chunk)

    def bwd(r, k, v, w, u, do, dstate, chunk):
        calls["backward"] += 1
        return [g.detach() for g in PK.rwkv6_bwd_plain(
            r, k, v, w, u, do, dstate, chunk=chunk)]

    monkeypatch.setattr(PK, "_k6", fwd)
    monkeypatch.setattr(PK, "_k6_bwd", bwd)
    return calls


def test_autograd_function_routes_gradients(monkeypatch):
    calls = _cpu_launches(monkeypatch)
    r, k, v, w, u, do, ds = (torch.from_numpy(x) for x in _inputs(
        8, 2, 3, 128, 16, 24))
    rb, kb, vb = (x.to(torch.bfloat16).requires_grad_(True)
                  for x in (r, k, v))
    wl, ul = w.clone().requires_grad_(True), u.clone().requires_grad_(True)
    o, state = PK._Rwkv6.apply(rb, kb, vb, wl, ul, 32)
    with torch.no_grad():
        o2, state2 = PK.rwkv6_plain(rb, kb, vb, wl, ul, chunk=32)
    assert torch.equal(o, o2) and torch.equal(state, state2)
    ((o * do).sum() + (state * ds).sum()).backward()
    assert calls == {"forward": 1, "backward": 1}
    want = PK.rwkv6_bwd_plain(rb, kb, vb, wl, ul, do, ds, chunk=32)
    for leaf, x in zip((rb, kb, vb, wl, ul), want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, x)


def test_autograd_function_without_dstate_or_u_grad(monkeypatch):
    calls = _cpu_launches(monkeypatch)
    r, k, v, w, u, do, _ = (torch.from_numpy(x) for x in _inputs(
        9, 1, 2, 64, 16, 64, u_zero=True))
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, w)]
    returned = []
    backward = PK._Rwkv6.backward

    def spy(ctx, *grads):
        returned.append((grads, backward(ctx, *grads)))
        return returned[-1][1]

    monkeypatch.setattr(PK._Rwkv6, "backward", staticmethod(spy))
    o, _ = PK._Rwkv6.apply(*leaves, u, 64)      # hymba: u = 0, no gradient
    (o * do).sum().backward()
    (got_do, got_ds), out = returned[0]
    assert got_ds is None                        # the state was not used
    assert out[4] is None and out[5] is None     # u and chunk
    want = PK.rwkv6_bwd_plain(r, k, v, w, u, do, None, chunk=64)
    for leaf, x in zip(leaves, want):
        assert torch.equal(leaf.grad, x)
    assert calls == {"forward": 1, "backward": 1}


def test_bwd_dispatcher_runs_the_plain_version_on_cpu():
    args = [torch.from_numpy(x) for x in _inputs(10, 1, 2, 64, 8, 8)]
    before = PK.rwkv6_bwd.launches
    got = PK.rwkv6_bwd(*args, chunk=16)
    want = PK.rwkv6_bwd_plain(*args, chunk=16)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert PK.rwkv6_bwd.launches == before
    with pytest.raises(ValueError, match="does not match"):
        PK.rwkv6_bwd(*args[:5], args[5][:, :, :32], chunk=16)
    with pytest.raises(ValueError, match="multiple"):
        PK.rwkv6_bwd(*args[:5], args[5], chunk=48)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_models_reach_the_autograd_function_twice_forward_once_backward(
        monkeypatch, arch):
    """Under remat (a non-reentrant checkpoint per period) each layer's WKV
    runs twice forward and once backward, and what ``rwkv6_chunked`` passes
    reaches the launch functions as the kernels take it: r, k, v contiguous
    in the compute dtype, w float32, u float32 (hymba's u = 0 needs no
    gradient)."""
    import repro_torch.configs as PC
    import repro_torch.kernels.ops as pops
    import repro_torch.models.model as PM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    calls = _cpu_launches(monkeypatch)
    seen = []
    launch = PK._k6

    def k6(r, k, v, w, u, chunk):
        seen.append((r.dtype, k.dtype, v.dtype, w.dtype, u.dtype,
                     all(x.is_contiguous() for x in (r, k, v, w, u))))
        return launch(r, k, v, w, u, chunk)

    monkeypatch.setattr(PK, "_k6", k6)
    monkeypatch.setattr(pops, "rwkv6", lambda r, k, v, w, u, *, chunk: (
        PK._Rwkv6.apply(r, k, v, w, u.to(torch.float32).contiguous(),
                        chunk)))
    cfg = PC.reduced_config(PC.get_config(arch))
    assert cfg.remat
    params = PM.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)).get_batch(
            0).items()}
    leaves = list(_walk(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, _ = PM.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    assert calls == {"forward": 2 * cfg.n_layers, "backward": cfg.n_layers}
    # every leaf but hymba's unused ``wo_s`` (unused in the reference too)
    # gets a finite gradient, the decay and token-mix projections included
    unused = {path for (path, _), g in zip(leaves, grads) if g is None}
    assert unused <= {("layers", "pos0", "ssm", "wo_s")}
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
    cdt = cfg.cdtype
    assert set(seen) == {(cdt, cdt, cdt, torch.float32, torch.float32, True)}

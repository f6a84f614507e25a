"""Kernels K3 and K4: flash attention over block-sparse and over contiguous
kv ranges, and the planned ``block_attention`` op.

Port of ``repro.kernels.flash_attention``.

K3 (``block_sparse_attention``): the plan lowers an arbitrary CSR mask to
per-q-block lists of visible kv blocks, and K3 runs online-softmax
attention of each q block over only the kv blocks its list names, so
invisible kv blocks are never read.  It replaces the Pallas TPU kernel
``block_sparse_attention`` in ``src/repro/kernels/flash_attention.py:274``
(``pl.pallas_call`` at :317).  The CUDA C++ source is
``csrc/block_sparse_attention.cu``.

Bound on an H100: ``4·B·H·n_visible·bs²·D`` FLOP (QKᵀ and PV) against
q, k, v read once and the output written once.  At bs = D = 128 a visible
block does 8.4 MFLOP per head on 128 KiB of fp32 K and V: bound by
operations.  So K3 keeps everything of one (b, h, q block) on chip and runs
both products on the tensor cores, FlashAttention-2's shape: Q stays in
shared memory for the whole kv loop, K and V rows stream through
``cp.async`` in sub-tiles, and the running max, sum and the accumulator
stay in registers.  float32 runs 3xTF32 (each operand split into TF32 big
and small parts, three products, the tensor cores' partial sums carried
into IEEE fp32 sums: the reference holds K3 to 1e-4) with the online
softmax in IEEE fp32: on ``wgmma`` at bs = 128 and D = 64 or 128 (Q's and
P's fragments split in registers as A operands, K and V split once per
block into shared memory, the next sub-tile split while this one's QKᵀ
runs), on ``mma.sync`` at the other shapes.  bfloat16 runs bf16
``mma.sync`` with fp32 accumulation and P rounded to bfloat16, as K4 does.
At D = 256 a grid axis splits the output's columns in two halves (each
block still reduces the scores over the full D).  It takes bs in
{16, 32, 64, 128} and D in ``K4_HEAD_DIMS``.  The planned route
(``block_sparse_attention_plan``, which ``block_attention_execute`` takes)
keeps a range-checked device copy of the plan's ``kv_ids | n_kv`` on the
plan, so a warm call uploads nothing; the array route
(``block_sparse_attention``) checks and uploads its ids on every call.

K4 (``flash_attention``): causal / sliding-window attention over the
contiguous kv range each q tile can see (``attention_block_schedule``'s
closed form, computed inside the kernel), with softcap and GQA.  It
replaces the Pallas TPU kernel ``flash_attention`` in
``src/repro/kernels/flash_attention.py:116`` (``pl.pallas_call`` at :164).
The CUDA C++ source is ``csrc/flash_attention.cu``, two kernels picked by
the input type: bfloat16 on the tensor cores (``mma.sync`` m16n8k16 on
128-row q tiles, 64-row at head dims 128 and 256, K and V through a
2-stage ``cp.async`` ring, the online
softmax in fp32 registers, P rounded to bfloat16 for the PV product, masks
only on boundary tiles), and float32 in IEEE FMAs (64 × 64 tiles, the
FMA loop K3 ran until it moved to the tensor cores, masks per element; the
1e-4 limit rules out one-pass TF32).  Both
take ragged S (kv ≥ S masked, q rows ≥ S never stored) and head dims
``K4_HEAD_DIMS``, every head dim of the port's configs and of
``reduced_config``.  Bound: ``4·D`` FLOP per visible (q, k) pair against
q, k, v read once and the output written once; at hymba-1.5b's prefill
(bfloat16, D = 64, window 1024) it is bound by operations.

K4's backward (``flash_attention_bwd``): ``flash_attention`` on CUDA
tensors under grad mode goes through a ``torch.autograd.Function`` whose
forward launches K4 as above and whose backward launches the kernels of
``csrc/flash_attention_bwd.cu``: a dq pass that rebuilds each row's
logsumexp and ``D = rowsum(dout ∘ out)``, then a dk/dv pass per kv head
over its q heads, float32 sums, no atomics (two runs are bit-identical).
It replaces the XLA autodiff of the reference's ``flash_attention_jnp``,
which the reference's models train through (the reference has no backward
Pallas kernel).  Bound: five S × S × D products per head, half of them
under a causal mask.  Its plain version is ``flash_attention_plain``'s
autograd (``flash_attention_bwd_plain``).  K3 has no backward kernel: a
CUDA call that would need a gradient raises (``_build.refuse_grad``).

Both wrappers dispatch on the tensors' device: CPU tensors run the plain
version (``block_sparse_attention_plain``, ``flash_attention_plain``);
CUDA tensors launch the kernel or raise.  ``block_sparse_attention.launches``,
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
kernel launches,
``block_sparse_attention.uploads`` K3's schedule uploads.  Both are built by
``_build`` and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.formats import CSR, bsr_pattern_from_csr
from ..core.inspector import (PatternFingerprint, fingerprint_pattern,
                              next_pow2)
from ..device import launch_target, resolve_device, to_device
from . import _build, _meta

NEG_INF = -1e30

# head dims K4 is built for (every d_head of configs/ and reduced_config's
# 16); anything else raises on CUDA
K4_HEAD_DIMS = (16, 32, 64, 128, 256)
# (bs, D) pairs K3 is built for: the runtime's blocks (K1 and K2 take the
# same field) and K4's head dims; anything else raises on CUDA
SUPPORTED_SHAPES = tuple((bs, d) for bs in (16, 32, 64, 128)
                         for d in K4_HEAD_DIMS)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Planned block-sparse attention: arbitrary CSR mask → per-q-block kv lists
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class BlockAttentionPlan:
    """Pattern-pure plan for attention under a block-sparse CSR mask.

    Semantics are *block granular*: q block ``qi`` attends kv block ``kj``
    iff the mask has at least one stored element in that ``block x block``
    tile (positions past the unpadded ``seq`` are always masked).  The
    mask's values never enter the plan — only its sparsity pattern — so
    every same-mask call (each decode step / layer sharing a document
    mask) replays a warm plan.

    ``kv_ids[qi, s]`` is the s-th visible kv block of q block ``qi``;
    slots past ``n_kv[qi]`` are padded with block 0 and skipped by both
    executors.  ``nk_cap`` is the pow-2 bucketed max visible count (the
    reference's static-shape discipline; kept so plans stay bit-identical).
    """

    block: int
    seq: int                 # unpadded q/kv sequence length (mask dims)
    n_q_blocks: int
    nk_cap: int              # pow-2 bucketed max visible kv blocks/q block
    kv_ids: np.ndarray       # (n_q_blocks, nk_cap) int32, slot-padded with 0
    n_kv: np.ndarray         # (n_q_blocks,) int32 visible count per q block
    n_visible: int           # total stored mask blocks (schedule size)
    fingerprint: Optional[PatternFingerprint] = None

    def flops(self, batch: int, heads: int, head_dim: int) -> int:
        return 4 * batch * heads * self.n_visible * self.block \
            * self.block * head_dim


def inspect_block_attention(mask: CSR, block: int = 128,
                            fingerprint: Optional[PatternFingerprint] = None
                            ) -> BlockAttentionPlan:
    """Stage-2 plan-build: the mask's BSR structure → visible-kv lists."""
    if mask.n_rows != mask.n_cols:
        raise ValueError(f"attention mask must be square, got "
                         f"{mask.n_rows}x{mask.n_cols}")
    pat = bsr_pattern_from_csr(mask, block)
    n_kv = np.diff(pat.indptr).astype(np.int32)
    nq = pat.n_block_rows
    nk_cap = next_pow2(max(1, int(n_kv.max(initial=0))))
    kv_ids = np.zeros((nq, nk_cap), np.int32)
    slots = np.arange(pat.n_blocks, dtype=np.int64) \
        - np.repeat(pat.indptr[:-1], n_kv)
    kv_ids[pat.block_rows(), slots] = pat.indices
    return BlockAttentionPlan(block, mask.n_rows, nq, nk_cap, kv_ids, n_kv,
                              pat.n_blocks, fingerprint)


# ---------------------------------------------------------------------------
# Kernel K3: plain version and wrapper
# ---------------------------------------------------------------------------

def block_sparse_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, kv_ids: torch.Tensor,
                                 n_kv: torch.Tensor, *, softcap: float,
                                 scale: float, seq: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (the torch twin of the reference's
    ``_block_attention_jnp``): gather the visible kv blocks, masked
    softmax over them, exact zeros for rows that see nothing.  GQA keeps
    the kv heads ungathered: q heads are viewed as (kv head, group)."""
    b, h, s_pad, d = q.shape
    hkv = k.shape[1]
    nq, nk_cap = kv_ids.shape
    bs = s_pad // nq
    group = h // hkv
    ids = kv_ids.long()
    qb = q.float().reshape(b, hkv, group, nq, bs, d)
    kg = k.float().reshape(b, hkv, nq, bs, d)[:, :, ids]  # (b,hkv,nq,cap,bs,d)
    vg = v.float().reshape(b, hkv, nq, bs, d)[:, :, ids]
    s = torch.einsum("bhgqid,bhqsjd->bhgqisj", qb, kg) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    slot = torch.arange(nk_cap, device=q.device)
    live = slot[None, :] < n_kv.to(q.device).long()[:, None]    # (nq, cap)
    kpos = ids[:, :, None] * bs + torch.arange(bs, device=q.device)
    mask = (live[:, :, None] & (kpos < seq))[:, None, :]    # (nq,1,cap,bs)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=(-2, -1), keepdim=True)
    # fully-masked q rows: exp(NEG_INF - NEG_INF) would be 1, so zero the
    # masked probabilities explicitly and divide under an lsum>0 guard
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    lsum = p.sum(dim=(-2, -1))[..., None]                # (b,hkv,g,nq,bs,1)
    out = torch.einsum("bhgqisj,bhqsjd->bhgqid", p, vg)
    out = torch.where(lsum > 0, out / lsum.clamp_min(1e-30),
                      torch.zeros((), device=q.device))
    return out.reshape(b, h, s_pad, d).to(q.dtype)


def _lib() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("block_sparse_attention", "block_sparse_attention",
                       [p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, i, p,
                        i])


def _launch(q, k, v, sched, nq, nk_cap, out, *, softcap, scale, seq) -> None:
    """Launch K3 on the device schedule ``sched`` = ``kv_ids | n_kv``
    (int32, range-checked by the caller)."""
    b, h, s_pad, d = q.shape
    bs = s_pad // nq
    if (bs, d) not in SUPPORTED_SHAPES:
        raise ValueError(f"K3 supports (bs, D) in {SUPPORTED_SHAPES}, got "
                         f"({bs}, {d})")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("K3 takes q, k, v all float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16 \
                or t.device != out.device:
            raise ValueError("K3 operands must be contiguous, 16-byte "
                             "aligned tensors on one device")
    lib = _lib()
    err = lib.block_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sched.data_ptr(),
        sched.data_ptr() + 4 * nq * nk_cap, out.data_ptr(), b, h, k.shape[1],
        nq, nk_cap, bs, d, seq, float(scale), float(softcap),
        _DTYPE_CODE[q.dtype], *launch_target(out.device))
    _build.check_launch(lib, err, "block_sparse_attention")
    block_sparse_attention.launches += 1


def _host_ids(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x)).astype(np.int32, copy=False)


def _check_qkv(q, k, v) -> None:
    b, h = q.shape[:2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:] \
            or h % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _check_ids(ids: np.ndarray, counts: np.ndarray, s_pad: int) -> None:
    nq, nk_cap = ids.shape
    if s_pad % max(nq, 1) or counts.shape != (nq,):
        raise ValueError("kv_ids must be (S_pad // bs, nk_cap) and n_kv "
                         "(S_pad // bs,)")
    if ids.size and (ids.min() < 0 or ids.max() >= nq) \
            or counts.size and (counts.min() < 0 or counts.max() > nk_cap):
        raise ValueError("kv_ids or n_kv out of range")


def _upload(ids: np.ndarray, counts: np.ndarray,
            device: torch.device) -> torch.Tensor:
    sched = to_device(np.concatenate([ids.reshape(-1), counts]), device)
    block_sparse_attention.uploads += 1
    return sched


def plan_schedule(plan: BlockAttentionPlan,
                  device: torch.device) -> torch.Tensor:
    """The plan's ``kv_ids | n_kv`` on ``device`` as one int32 tensor:
    range-checked and uploaded on first use, then memoized on the plan
    outside its dataclass fields (which, with the plan's serialization,
    stay the reference's)."""
    memo = plan.__dict__.setdefault("_device_schedule", {})
    key = str(device)
    if key not in memo:
        ids, counts = _host_ids(plan.kv_ids), _host_ids(plan.n_kv)
        _check_ids(ids, counts, plan.n_q_blocks * plan.block)
        memo[key] = _upload(ids, counts, device)
    return memo[key]


def _run(q, k, v, sched, nq, nk_cap, *, softcap, scale, seq):
    """Plain version on CPU tensors, K3 on CUDA tensors, from a schedule
    already on q's device."""
    if q.device.type == "cpu":
        return block_sparse_attention_plain(
            q, k, v, sched[:nq * nk_cap].view(nq, nk_cap),
            sched[nq * nk_cap:], softcap=softcap, scale=scale, seq=seq)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _build.refuse_grad("K3 (block_sparse_attention)", q, k, v)
    out = torch.empty_like(q)
    if q.numel():
        _launch(q, k, v, sched, nq, nk_cap, out, softcap=softcap,
                scale=scale, seq=seq)
    return out


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_ids, n_kv, *, softcap: float = 0.0,
                           scale: Optional[float] = None,
                           seq: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S_pad, D); k, v: (B, Hkv, S_pad, D); kv_ids:
    (S_pad // bs, nk_cap) visible kv blocks per q block, ``n_kv`` the count
    of live slots.  Returns q's shape and dtype on q's device.

    ``kv_ids``/``n_kv`` are read on the host to check their ranges (a raw
    kernel has no bounds checks) and uploaded on every call: pass numpy or
    CPU tensors.  A plan's memoized copy is ``block_sparse_attention_plan``'s
    route.  CPU tensors run the plain version; CUDA tensors launch K3 or
    raise.
    """
    _check_qkv(q, k, v)
    ids, counts = _host_ids(kv_ids), _host_ids(n_kv)
    s_pad, d = q.shape[2:]
    _check_ids(ids, counts, s_pad)
    scale = float(d ** -0.5) if scale is None else float(scale)
    seq = s_pad if seq is None else int(seq)
    sched = torch.from_numpy(np.concatenate([ids.reshape(-1), counts])) \
        if q.device.type == "cpu" else _upload(ids, counts, q.device)
    return _run(q, k, v, sched, *ids.shape, softcap=softcap, scale=scale,
                seq=seq)


def block_sparse_attention_plan(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, plan: BlockAttentionPlan, *,
                                softcap: float = 0.0,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """``block_sparse_attention`` on a plan's schedule: q (B, H,
    n_q_blocks·block, D), k and v (B, Hkv, n_q_blocks·block, D), positions
    from ``plan.seq`` on masked.  The schedule comes from ``plan_schedule``,
    so only the first call on a device uploads it."""
    _check_qkv(q, k, v)
    s_pad, d = q.shape[2:]
    if s_pad != plan.n_q_blocks * plan.block:
        raise ValueError(f"q has {s_pad} rows, the plan "
                         f"{plan.n_q_blocks * plan.block}")
    scale = float(d ** -0.5) if scale is None else float(scale)
    return _run(q, k, v, plan_schedule(plan, q.device), plan.n_q_blocks,
                plan.nk_cap, softcap=softcap, scale=scale, seq=plan.seq)


block_sparse_attention.launches = 0
block_sparse_attention.uploads = 0


# ---------------------------------------------------------------------------
# Kernel K4: contiguous-range (causal / sliding-window) flash attention
# ---------------------------------------------------------------------------

def attention_block_schedule(seq: int, bq: int, bk: int, *, causal: bool,
                             window: int = 0):
    """Host inspector: per q-block, the [lo, hi) range of visible kv blocks.

    Returns (kv_lo, n_kv, nk_max) — int32 arrays of shape (seq//bq,).  A
    copy of the reference's; K4 computes the same closed form per q tile
    on the card, so nothing uploads it.
    """
    nq = seq // bq
    kv_lo = np.zeros(nq, dtype=np.int32)
    n_kv = np.zeros(nq, dtype=np.int32)
    for qi in range(nq):
        q_first, q_last = qi * bq, qi * bq + bq - 1
        hi = (q_last // bk + 1) if causal else (seq // bk)
        lo = 0
        if window > 0:
            lo = max(0, (q_first - window + 1) // bk)
        kv_lo[qi], n_kv[qi] = lo, hi - lo
    return kv_lo, n_kv, int(n_kv.max())


def attention_mask(seq: int, *, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(seq, seq) boolean: query row i may see key column j (K4's masks)."""
    qpos = torch.arange(seq, device=device)[:, None]
    kpos = torch.arange(seq, device=device)[None, :]
    mask = torch.ones((seq, seq), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: dense masked softmax in float32, GQA as
    q heads viewed (kv head, group), probabilities kept in float32 for the
    PV product (as the Pallas kernel does), rows that see nothing exactly
    0, the result in q's dtype."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, h // hkv, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0.0:
        sc = softcap * torch.tanh(sc / softcap)
    mask = attention_mask(s, causal=causal, window=window, device=q.device)
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros((), device=q.device))
    lsum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = torch.where(lsum > 0, out / lsum.clamp_min(1e-30),
                      torch.zeros((), device=q.device))
    return out.reshape(b, h, s, d).to(q.dtype)


def _k4_lib() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("flash_attention", "flash_attention",
                       [p, p, p, p, i, i, i, i, i, i, i, f, f, i, p, i])


def _check_k4(q, k, v, out) -> None:
    """What K4's kernels take: head dims ``K4_HEAD_DIMS``, q, k, v all
    float32 or all bfloat16, contiguous, 16-byte aligned, on ``out``'s
    device."""
    d = q.shape[3]
    if d not in K4_HEAD_DIMS:
        raise ValueError(f"K4 supports head dims {K4_HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError("K4 takes q, k, v all float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16 \
                or t.device != out.device:
            raise ValueError("K4 operands must be contiguous, 16-byte "
                             "aligned tensors on one device")


def _k4(q, k, v, **kw) -> torch.Tensor:
    """K4's output on the card (a launch unless q is empty)."""
    out = torch.empty_like(q)
    if q.numel():
        _k4_launch(q, k, v, out, **kw)
    return out


def _k4_launch(q, k, v, out, *, causal, window, softcap, scale) -> None:
    b, h, s, d = q.shape
    _check_k4(q, k, v, out)
    lib = _k4_lib()
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        k.shape[1], s, d, int(causal), int(window), float(scale),
        float(softcap), _DTYPE_CODE[q.dtype], *launch_target(out.device))
    _build.check_launch(lib, err, "flash_attention")
    flash_attention.launches += 1


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0,
                              scale: Optional[float] = None):
    """Plain version of K4's backward: ``(dq, dk, dv)`` by autograd through
    ``flash_attention_plain`` (float32 sums, each result in its input's
    dtype).  The CPU path differentiates the plain version itself; this
    is what ``chip_smoke.py`` and the card tests hold the kernel to."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window,
                                    softcap=softcap, scale=scale)
        return torch.autograd.grad(out, leaves, dout)


def _k4_bwd_lib() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.bind("flash_attention_bwd", "flash_attention_bwd",
                       [p] * 10 + [i] * 7 + [f, f, i, p, i])


def _k4_bwd_launch(q, k, v, out, dout, *, causal, window, softcap, scale):
    """K4's backward on the card: ``(dq, dk, dv)`` in the inputs' dtype.
    Scratch: each row's logsumexp and ``rowsum(dout * out)`` in float32,
    which the kernel rebuilds (the forward saves neither)."""
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not q.numel():
        return dq, dk, dv
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _k4_bwd_lib()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), b, h, k.shape[1], s, d,
        int(causal), int(window), float(scale), float(softcap),
        _DTYPE_CODE[q.dtype], *launch_target(q.device))
    _build.check_launch(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        scale: Optional[float] = None):
    """K4's backward: ``(dq, dk, dv)`` of ``flash_attention(q, k, v)`` whose
    output ``out`` met the gradient ``dout``; each in its input's dtype.
    CPU tensors run ``flash_attention_bwd_plain`` (which needs no
    ``out``); CUDA tensors launch the kernel of
    ``csrc/flash_attention_bwd.cu`` or raise.  ``flash_attention``'s
    autograd calls it; ``flash_attention_bwd.launches`` counts the
    launches (one a call: the dq pass, then the dk/dv pass)."""
    b, h, s, d = q.shape
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_k4(q, k, v, out)
    dout = dout.contiguous()
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or out.shape != q.shape or out.dtype != q.dtype \
            or not out.is_contiguous() \
            or any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("K4's backward takes out and dout of q's shape and "
                         "dtype, contiguous and 16-byte aligned")
    return _k4_bwd_launch(q, k, v, out, dout, causal=causal, window=window,
                          softcap=softcap, scale=scale)


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K4 with its backward kernel: the forward launches K4 as it is (its
    outputs bit-identical to a call without grad), the backward launches
    ``flash_attention_bwd``'s kernel.  CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.args = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        out = _k4(q, k, v, **ctx.args)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0 (GQA).

    Attention of each query over the keys it may see: ``kpos <= qpos`` when
    causal, ``kpos > qpos - window`` when ``window > 0``; logits scaled by
    ``scale`` (default ``D**-0.5``) and soft-capped (``softcap > 0``)
    before the masks.  Returns q's shape and dtype on q's device.  Any S is
    taken (the reference's kernel asserts ``S % bq == 0``; its tile
    arguments ``bq`` / ``bk`` are not offered, as K4 picks its own tiles).
    CPU tensors run the plain version (autograd differentiates it); CUDA
    tensors launch K4 or raise, and under grad mode with q, k or v
    requiring grad go through ``_FlashAttention``, whose backward is K4's
    backward kernel.  ``meta`` tensors (the dry run) get a fake result of
    K4's shape and FLOP (``kernels._meta``).
    """
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:] \
            or h % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type == "meta":
        return _meta.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _k4(q, k, v, causal=causal, window=window, softcap=softcap,
               scale=scale)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Executor and oracle
# ---------------------------------------------------------------------------

def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(dev, non_blocking=True).contiguous()


def block_attention_execute(plan: BlockAttentionPlan, q, k, v,
                            use_kernel: bool = True, *,
                            softcap: float = 0.0,
                            scale: Optional[float] = None, device="cuda"):
    """Attention output from a plan + this call's q/k/v values.

    q: (B, H, S, D); k, v: (B, Hkv, S, D) with H % Hkv == 0 (GQA), as
    numpy arrays or torch tensors (torch for bfloat16, which numpy lacks).
    S is zero-padded up to the plan's block multiple; padded kv positions
    are masked and padded q rows are sliced off the result.  Numpy inputs
    give a numpy result (the reference's contract); tensor inputs give a
    tensor on ``device``, with no copy back to the host.
    """
    dev = resolve_device(device)
    as_numpy = not torch.is_tensor(q)
    q, k, v = (_as_tensor(x, dev) for x in (q, k, v))
    b, h, s, d = q.shape
    if s != plan.seq:
        raise ValueError(f"q has seq {s}, plan was built for {plan.seq}")
    s_pad = plan.n_q_blocks * plan.block
    if s_pad != s:
        pad = (0, 0, 0, s_pad - s)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    d_scale = float(d ** -0.5) if scale is None else float(scale)
    if use_kernel:
        out = block_sparse_attention_plan(q, k, v, plan, softcap=softcap,
                                          scale=d_scale)
    else:
        out = block_sparse_attention_plain(
            q, k, v, to_device(plan.kv_ids, dev), to_device(plan.n_kv, dev),
            softcap=softcap, scale=d_scale, seq=plan.seq)
    out = out[:, :, :plan.seq]
    return out.cpu().numpy() if as_numpy else out


def block_attention_ref(q, k, v, mask: CSR, block: int, *,
                        softcap: float = 0.0,
                        scale: float | None = None) -> np.ndarray:
    """Dense numpy oracle with the same block-granular mask semantics."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kf = np.repeat(k, group, axis=1)
    vf = np.repeat(v, group, axis=1)
    blk = mask.to_dense() != 0
    nq, nk = -(-s // block), -(-s // block)
    allowed = np.zeros((s, s), bool)
    for qi in range(nq):
        for kj in range(nk):
            tile = blk[qi * block:(qi + 1) * block,
                       kj * block:(kj + 1) * block]
            if tile.any():
                allowed[qi * block:(qi + 1) * block,
                        kj * block:(kj + 1) * block] = True
    scl = (d ** -0.5) if scale is None else scale
    s_mat = np.einsum("bhid,bhjd->bhij", q, kf) * scl
    if softcap > 0.0:
        s_mat = softcap * np.tanh(s_mat / softcap)
    s_mat = np.where(allowed[None, None], s_mat, -np.inf)
    m = s_mat.max(axis=-1, keepdims=True)
    p = np.where(np.isfinite(s_mat), np.exp(s_mat - np.where(
        np.isfinite(m), m, 0.0)), 0.0)
    lsum = p.sum(axis=-1, keepdims=True)
    out = np.einsum("bhij,bhjd->bhid", p, vf)
    return np.where(lsum > 0, out / np.maximum(lsum, 1e-30), 0.0)


# ---------------------------------------------------------------------------
# Op registry: block-sparse attention admitted as a planned op
# ---------------------------------------------------------------------------

from ..runtime.ops import OpCapabilities, OpSpec, register_op  # noqa: E402


def _fp_block_attention(operands, cfg, *, chunked, **kw):
    mask = operands[3]
    return fingerprint_pattern("block_attention", (mask,), block=cfg.block)


def _inspect_block_attention(operands, cfg, fp, **kw):
    return inspect_block_attention(operands[3], cfg.block, fp)


def _exec_block_attention(plan, operands, cfg, *, overlap, softcap=0.0,
                          scale=None, **kw):
    q, k, v = operands[0], operands[1], operands[2]
    t0 = time.perf_counter()
    o = block_attention_execute(plan, q, k, v, use_kernel=cfg.use_kernel,
                                softcap=softcap, scale=scale,
                                device=cfg.device)
    if torch.is_tensor(o) and o.is_cuda:
        # reaplint: disable=REAP003 deliberate timed drain: execute_s must
        # measure device completion
        torch.cuda.synchronize(o.device)
    exec_s = time.perf_counter() - t0
    b, h, _, d = q.shape
    stats = dict(method="block_attention", execute_s=exec_s, overlap=False,
                 n_visible_blocks=plan.n_visible, nk_cap=plan.nk_cap,
                 flops=plan.flops(b, h, d))
    return o, stats


register_op(OpSpec(
    tag="block_attention",
    fingerprint=_fp_block_attention,
    inspect=_inspect_block_attention,
    execute_sync=_exec_block_attention,
    plan_types={"block_attention": BlockAttentionPlan},
    allowed_kw=("softcap", "scale"),
    capabilities=OpCapabilities(dtypes=("float32", "bfloat16"),
                                routing="host"),
))

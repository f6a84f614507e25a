"""Kernel K2: schedule-driven block-sparse weight × dense activation matmul
(SpMM), and the planned ``spmm`` op.

    Y[:, j-block] = Σ_jobs X[:, k_blk] @ W_tiles[w_id]

over a job schedule sorted by output block-column ``j_blk``; each group (a
run of one ``j_blk``) sums into one output tile column.  The inspector adds
a coverage job for every output block-column with no stored W block, so
every output tile belongs to exactly one group and is written once.

Port of ``repro.kernels.bsr_spmm``.  K2 replaces the Pallas TPU kernel
``bsr_spmm`` in ``src/repro/kernels/bsr_spmm.py:119`` (``pl.pallas_call`` at
:144).  The CUDA C++ source is ``csrc/bsr_spmm.cu``, built by ``_build`` and
bound with ctypes.

Bound on an H100: ``2·T·n_jobs·bs²`` FLOP against X read once, the W
tiles read once and Y written once.  At T = 256, bs = 128 a job does
8.4 MFLOP on 64 KiB of W (128 FLOP/B): bound by operations, so K2 tiles
(a 128-row token tile × one output block-column per thread block) on the
tensor cores in 3xTF32 (``mma.sync`` m16n8k8 on TF32 splits of each fp32
operand: three tensor-core products per product, fp32 accuracy; plain
TF32 would miss the 1e-4 limit), with X panels and W slices through a
3-stage ``cp.async`` ring.  At T = 1 (the solver's matvec) a job does
2·bs² FLOP on 4·bs² bytes: bound by bytes, so K2 switches to a GEMV that
streams each W tile once, coalesced, in IEEE fp32 FMAs.

``bsr_spmm`` dispatches on the tensors' device: CPU tensors run
``bsr_spmm_plain``; CUDA tensors launch the kernel or raise.
``bsr_spmm.launches`` counts kernel launches and ``bsr_spmm.uploads`` the
schedule uploads: a ``K2Schedule`` keeps its device copy per device, so a
warm call with the same schedule copies nothing to the card.

The planned op (``SpmmPlan`` / ``inspect_spmm`` / ``spmm_execute`` and the
``spmm`` registration) keeps the reference's plan and contract.  Two
differences of route, none of result: K2 takes the true token count T (the
reference buckets T to a power of two for XLA's compile shapes; the result
is sliced to ``[:t, :n_cols]`` either way), and the sharded form
(``runtime.shard.sharded_spmm``) runs K2 on each shard's token rows, where
the reference's shard body is its jnp tile math.  K2 picks its variant
(GEMV, 32-row or 128-row tiles) from ``regime_t``, the whole call's token
count, so a shard of a sharded call computes each row as the unsharded
call does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ..core.formats import BsrPattern, CSR, bsr_pattern_from_csr
from ..core.inspector import PatternFingerprint, fingerprint_pattern
from ..core.rir import ScheduleBundle
from ..device import launch_target, resolve_device, to_device
from . import _build

SUPPORTED_BS = (16, 32, 64, 128)


def _sorted_job_schedule(kk: np.ndarray, jj: np.ndarray, carry: np.ndarray,
                         carry_fill, n_k_blocks: int, n_j_blocks: int):
    """Shared RIR job-schedule construction for the SpMM kernels.

    Appends a coverage job for every output block-column with no stored
    block (its tile must still be zeroed; ``carry_fill`` marks the job's
    per-caller payload — a dead/zero operand), sorts jobs by (output
    block, input block), and derives the ``is_first``/``is_last`` group
    flags.  Returns ``(kk, jj, carry, is_first, is_last)``.
    """
    missing = np.setdiff1d(np.arange(n_j_blocks), np.unique(jj))
    if missing.size:
        kk = np.concatenate([kk, np.zeros(missing.size, kk.dtype)])
        jj = np.concatenate([jj, missing])
        carry = np.concatenate(
            [carry, np.full(missing.size, carry_fill, carry.dtype)])
    order = np.argsort(jj * np.int64(max(1, n_k_blocks)) + kk,
                       kind="stable")
    kk, jj, carry = kk[order], jj[order], carry[order]
    n_jobs = int(kk.shape[0])
    is_first = np.ones(n_jobs, bool)
    is_first[1:] = jj[1:] != jj[:-1]
    is_last = np.ones(n_jobs, bool)
    is_last[:-1] = jj[1:] != jj[:-1]
    return kk, jj, carry, is_first, is_last


def inspect_bsr_weight(w_dense: np.ndarray, block: int,
                       keep_fraction: float):
    """Host inspector: magnitude-prune W into BSR blocks + job schedule.

    Returns (blocks (nb, block, block), schedule dict) where the schedule
    has, per job: the weight-block id, its k (input) block and j (output)
    block, sorted by j with first/last group flags — the same RIR bundle
    discipline as the SpGEMM executor.
    """
    d_in, d_out = w_dense.shape
    assert d_in % block == 0 and d_out % block == 0
    nk, nj = d_in // block, d_out // block
    tiles = w_dense.reshape(nk, block, nj, block).transpose(0, 2, 1, 3)
    # reaplint: disable=REAP001 this inspector CREATES the sparsity
    # pattern (magnitude pruning of a dense weight); value-dependence is
    # its purpose. Downstream spmm plans consume only the pattern.
    energy = np.abs(tiles).sum(axis=(2, 3)).reshape(-1)      # (nk*nj,)
    n_keep = max(nj, int(round(keep_fraction * nk * nj)))
    keep_ids = np.argsort(-energy)[:n_keep]
    kk, jj = keep_ids // nj, keep_ids % nj
    # coverage jobs (carry=live False) multiply by a ZERO block
    kk, jj, live, is_first, is_last = _sorted_job_schedule(
        kk, jj, np.ones(kk.shape[0], bool), False, nk, nj)
    blocks = tiles[kk, jj].copy()
    blocks[~live] = 0.0
    n_jobs = kk.shape[0]
    sched = dict(w_id=np.arange(n_jobs, dtype=np.int32),
                 k_blk=kk.astype(np.int32), j_blk=jj.astype(np.int32),
                 is_first=is_first.astype(np.int32),
                 is_last=is_last.astype(np.int32))
    mask = np.zeros((nk, nj), bool)
    mask[kk[live], jj[live]] = True
    return blocks.astype(w_dense.dtype), sched, mask


# ---------------------------------------------------------------------------
# Kernel K2: schedule, plain version, wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class K2Schedule:
    """A validated SpMM job schedule in the kernel's form (host arrays).

    ``ids`` is one int32 array ``w_id | k_blk | j_blk | group_start``,
    uploaded with one copy on the first launch on a device and kept there
    (``device_ids``); group ``g`` is output block-column ``g`` and runs
    over jobs ``group_start[g]:group_start[g + 1]``.  Pattern-pure: callers
    memoize it per plan.
    """

    ids: np.ndarray
    n_jobs: int
    n_j_blocks: int
    w_max: int
    k_max: int

    def device_ids(self, device: torch.device) -> torch.Tensor:
        """``ids`` on ``device``, uploaded on first use and memoized on the
        schedule outside its dataclass fields."""
        memo = self.__dict__.setdefault("_device_ids", {})
        key = str(device)
        if key not in memo:
            memo[key] = to_device(self.ids, device)
            bsr_spmm.uploads += 1
        return memo[key]


def prepare_spmm_schedule(schedule: Union[Mapping, K2Schedule],
                          n_j_blocks: int) -> K2Schedule:
    """Validate a job schedule and derive its groups on the host.

    ``schedule`` maps ``w_id``/``k_blk``/``j_blk`` to host arrays (a plan's
    ``ScheduleBundle`` or ``inspect_bsr_weight``'s dict).  A group is a run
    of one ``j_blk``.  Raises ``ValueError`` unless ``j_blk`` is sorted and
    its runs are exactly the block-columns ``0..n_j_blocks-1`` — each output
    tile then has one thread block, which writes it once (no zero fill, no
    atomics).  No device sync: this is all numpy.
    """
    if isinstance(schedule, K2Schedule):
        if schedule.n_j_blocks != n_j_blocks:
            raise ValueError(f"schedule has {schedule.n_j_blocks} output "
                             f"block-columns, call asks for {n_j_blocks}")
        return schedule
    w_id, k_blk, j_blk = (np.asarray(schedule[k]).astype(np.int32, copy=False)
                          for k in ("w_id", "k_blk", "j_blk"))
    n = w_id.shape[0]
    if not (k_blk.shape[0] == j_blk.shape[0] == n):
        raise ValueError("schedule arrays differ in length")
    if (np.diff(j_blk) < 0).any():
        raise ValueError("schedule must be sorted by j_blk")
    if n and min(w_id.min(), k_blk.min()) < 0:
        raise ValueError("negative tile id in schedule")
    starts = np.flatnonzero(np.diff(j_blk)) + 1
    group_start = np.concatenate([[0] if n else [], starts, [n]])
    if not np.array_equal(j_blk[group_start[:-1].astype(np.int64)],
                          np.arange(n_j_blocks)):
        raise ValueError("schedule must hold one group for every output "
                         f"block-column 0..{n_j_blocks - 1} (coverage jobs)")
    return K2Schedule(
        np.concatenate([w_id, k_blk, j_blk, group_start.astype(np.int32)]),
        n, n_j_blocks, int(w_id.max()) if n else -1,
        int(k_blk.max()) if n else -1)


def bsr_spmm_plain(x: torch.Tensor, w_blocks: torch.Tensor,
                   w_id: torch.Tensor, k_blk: torch.Tensor,
                   j_blk: torch.Tensor, *, n_j_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (the torch twin of the reference's
    ``_spmm_math``): gather X and W tiles, ``einsum``, ``index_add_`` over
    ``j_blk``.  ``x`` is (T, n_k·bs); returns (T, n_j_blocks·bs) in x's
    dtype."""
    t, bs = x.shape[0], w_blocks.shape[-1]
    x_tiles = x.reshape(t, x.shape[1] // bs, bs).transpose(0, 1)
    prods = torch.einsum("tij,tjk->tik", x_tiles[k_blk.long()],
                         w_blocks[w_id.long()])
    out = x.new_zeros((n_j_blocks, t, bs)).index_add_(0, j_blk.long(), prods)
    return out.transpose(0, 1).reshape(t, n_j_blocks * bs)


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("bsr_spmm", "bsr_spmm_f32",
                       [p, p, p, p, p, p, i, i, i, i, i, i, p, p, i])


def _launch(sched: K2Schedule, x: torch.Tensor, w_blocks: torch.Tensor,
            out: torch.Tensor, regime_t: int) -> None:
    for t in (x, w_blocks):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16 or t.device != out.device:
            raise ValueError("K2 operands must be contiguous, 16-byte "
                             "aligned float32 tensors on the output's device")
    ids = sched.device_ids(out.device)
    n, lib = sched.n_jobs, _lib()
    base, step = ids.data_ptr(), 4 * n
    err = lib.bsr_spmm_f32(
        x.data_ptr(), w_blocks.data_ptr(), base, base + step,
        base + 2 * step, base + 3 * step, sched.n_j_blocks, x.shape[0],
        regime_t, x.shape[1], out.shape[1], w_blocks.shape[-1],
        out.data_ptr(),
        *launch_target(out.device))
    _build.check_launch(lib, err, "bsr_spmm")
    bsr_spmm.launches += 1


def bsr_spmm(x: torch.Tensor, w_blocks: torch.Tensor, schedule, *,
             n_j_blocks: int, regime_t: Optional[int] = None
             ) -> torch.Tensor:
    """``out = x @ W_bsr`` from a job schedule (dict or ``K2Schedule``).

    ``x`` (T, d_in) with ``d_in`` a multiple of the block; ``w_blocks``
    (n_tiles, bs, bs).  Returns (T, n_j_blocks·bs) in x's dtype on x's
    device.  CPU tensors run the plain version; CUDA tensors launch K2
    (float32, bs in ``SUPPORTED_BS``) or raise.  ``regime_t`` (default T)
    is the token count K2 picks its variant from: a shard of a larger call
    passes the call's T.
    """
    sched = prepare_spmm_schedule(schedule, n_j_blocks)
    bs = w_blocks.shape[-1]
    if x.dim() != 2 or x.shape[1] % bs:
        raise ValueError(f"x must be (T, d_in) with d_in a multiple of {bs}")
    if sched.w_max >= w_blocks.shape[0] or sched.k_max >= x.shape[1] // bs:
        raise ValueError("schedule indexes past the W tiles or x's blocks")
    if x.device.type == "cpu":
        ids = torch.from_numpy(sched.ids)
        n = sched.n_jobs
        return bsr_spmm_plain(x, w_blocks, ids[:n], ids[n:2 * n],
                              ids[2 * n:3 * n], n_j_blocks=n_j_blocks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if bs not in SUPPORTED_BS:
        raise ValueError(f"K2 supports bs in {SUPPORTED_BS}, got {bs}")
    out = torch.empty((x.shape[0], n_j_blocks * bs), dtype=torch.float32,
                      device=x.device)
    regime_t = x.shape[0] if regime_t is None else int(regime_t)
    if regime_t < 1:
        raise ValueError(f"regime_t must be positive, got {regime_t}")
    if x.shape[0] and n_j_blocks:
        _launch(sched, x, w_blocks, out, regime_t)
    return out


bsr_spmm.launches = 0
bsr_spmm.uploads = 0


# ---------------------------------------------------------------------------
# Planned SpMM: Y = X @ W with a sparse CSR W (pattern-pure plan)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class SpmmPlan:
    """Pattern-pure plan for ``Y = X @ W`` with W sparse (CSR → BSR tiles).

    The job schedule has one entry per stored W block (plus zero-tile
    coverage jobs for all-pruned output block-columns, so every output
    tile is written), sorted by output block-column with
    ``is_first``/``is_last`` group flags — the same RIR schedule
    discipline as the SpGEMM block path.  ``w_id == pat.n_blocks`` marks a
    coverage job; :meth:`scatter` appends the zero tile it multiplies.

    Only W's sparsity pattern (and ``block``) enters the fingerprint: the
    dense activations X are values, so every same-weight-pattern call —
    each microbatch through a frozen sparse layer — replays a warm plan.
    """

    block: int
    n_rows: int                      # W rows (d_in), unpadded
    n_cols: int                      # W cols (d_out), unpadded
    pat: BsrPattern                  # W's block structure + value scatter
    w_id: np.ndarray                 # (n_jobs,) W tile per job
    k_blk: np.ndarray                # (n_jobs,) X block-column per job
    j_blk: np.ndarray                # (n_jobs,) output block-column per job
    is_first: np.ndarray             # (n_jobs,) first job of its j group
    is_last: np.ndarray              # (n_jobs,) last job of its j group
    n_jobs: int
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def n_j_blocks(self) -> int:
        return self.pat.n_block_cols

    @property
    def n_k_blocks(self) -> int:
        return self.pat.n_block_rows

    @property
    def schedule(self) -> ScheduleBundle:
        return ScheduleBundle("spmm", {
            "w_id": self.w_id.astype(np.int32),
            "k_blk": self.k_blk.astype(np.int32),
            "j_blk": self.j_blk.astype(np.int32),
            "is_first": self.is_first.astype(np.int32),
            "is_last": self.is_last.astype(np.int32)})

    def scatter(self, w_data: np.ndarray, dtype=np.float32) -> np.ndarray:
        """Value pass: W's CSR values → (n_blocks + 1, bs, bs) tiles (the
        trailing tile is the zero operand of coverage jobs)."""
        tiles = self.pat.scatter(w_data, dtype=dtype)
        return np.concatenate(
            [tiles, np.zeros((1, self.block, self.block), tiles.dtype)])

    def flops(self, n_tokens: int) -> int:
        return 2 * n_tokens * self.n_jobs * self.block * self.block


def inspect_spmm(w: CSR, block: int = 128,
                 fingerprint: Optional[PatternFingerprint] = None
                 ) -> SpmmPlan:
    """Stage-2 plan-build for SpMM: W's block schedule, sorted by output."""
    pat = bsr_pattern_from_csr(w, block)
    # coverage jobs (carry=wid n_blocks) multiply the appended zero tile
    kk, jj, wid, is_first, is_last = _sorted_job_schedule(
        pat.block_rows(), pat.indices.copy(),
        np.arange(pat.n_blocks, dtype=np.int64), pat.n_blocks,
        pat.n_block_rows, pat.n_block_cols)
    return SpmmPlan(block, w.n_rows, w.n_cols, pat, wid,
                    kk.astype(np.int64), jj.astype(np.int64),
                    is_first, is_last, int(kk.shape[0]), fingerprint)


def _k2_schedule(plan: SpmmPlan) -> K2Schedule:
    """The plan's schedule in K2's form, memoized as a plain attribute
    (pattern-pure; serialization skips it)."""
    cached = getattr(plan, "_k2_schedule", None)
    if cached is None:
        cached = prepare_spmm_schedule(plan.schedule, plan.n_j_blocks)
        plan._k2_schedule = cached
    return cached


def spmm_execute(plan: SpmmPlan, x: np.ndarray, w_data: np.ndarray,
                 use_kernel: bool = True, dtype=np.float32,
                 device="cuda") -> np.ndarray:
    """Y = X @ W from a plan + this call's values.  Returns (T, d_out).

    X is zero-padded to W's padded row count; T is not bucketed (K2 and
    the torch ops take any T).  ``dtype`` picks the value dtype of the
    whole pass (plans are value-free, so it never touches the
    fingerprint).  ``use_kernel`` picks K2 for float32; wider dtypes (the
    planned solver's float64 matvecs) run the plain version on every
    device, as the reference sends them to its jnp executor.
    """
    dev = resolve_device(device)
    dtype = np.dtype(dtype)
    x = np.asarray(x, dtype)
    t, d_in = x.shape
    if d_in != plan.n_rows:
        raise ValueError(f"x has {d_in} features, W has {plan.n_rows} rows")
    xp = np.zeros((t, plan.pat.n_rows), dtype)
    xp[:, :d_in] = x
    x_t = to_device(xp, dev)
    w_t = to_device(plan.scatter(w_data, dtype=dtype), dev)
    if use_kernel and dtype == np.float32:
        # reaplint: disable=REAP004 no per-shape compile: K2 and the torch
        # ops take any shape, so plan-static shapes cost nothing
        out = bsr_spmm(x_t, w_t, _k2_schedule(plan), n_j_blocks=plan.n_j_blocks)
    else:
        out = bsr_spmm_plain(
            x_t, w_t, to_device(plan.w_id, dev), to_device(plan.k_blk, dev),
            to_device(plan.j_blk, dev),
            # reaplint: disable=REAP004 no per-shape compile (as above)
            n_j_blocks=plan.n_j_blocks)
    return out[:, :plan.n_cols].cpu().numpy()


def spmm_ref_numpy(x: np.ndarray, w: CSR) -> np.ndarray:
    """Dense-product oracle for tests/benchmarks."""
    return np.asarray(x, np.float32) @ w.to_dense().astype(np.float32)


# ---------------------------------------------------------------------------
# Op registry: SpMM admitted as a planned op — this block is the *entire*
# integration with the runtime and the plan cache.
# ---------------------------------------------------------------------------

from ..runtime.ops import OpCapabilities, OpSpec, register_op  # noqa: E402


def _fp_spmm(operands, cfg, *, chunked, **kw):
    _, w = operands
    return fingerprint_pattern("spmm", (w,), block=cfg.block)


def _inspect_spmm(operands, cfg, fp, **kw):
    return inspect_spmm(operands[1], cfg.block, fp)


def _exec_spmm(plan, operands, cfg, *, overlap, dtype=np.float32, **kw):
    x, w = operands
    t0 = time.perf_counter()
    y = spmm_execute(plan, x, w.data, use_kernel=cfg.use_kernel, dtype=dtype,
                     device=cfg.device)
    exec_s = time.perf_counter() - t0
    stats = dict(method="spmm", execute_s=exec_s, overlap=False,
                 n_jobs=plan.n_jobs, fill=plan.pat.fill,
                 flops=plan.flops(np.asarray(x).shape[0]))
    return y, stats


def _shard_spmm(cached, operands, cfg, *, mesh, dtype=np.float32, **kw):
    from ..runtime.shard import sharded_spmm
    x, w = operands
    return sharded_spmm(x, w, mesh, cfg.block, plan=cached, dtype=dtype,
                        use_kernel=cfg.use_kernel)


register_op(OpSpec(
    tag="spmm",
    fingerprint=_fp_spmm,
    inspect=_inspect_spmm,
    execute_sync=_exec_spmm,
    shard_plan=_shard_spmm,
    plan_types={"spmm": SpmmPlan, "bsr_pattern": BsrPattern},
    allowed_kw=("dtype",),
    capabilities=OpCapabilities(dtypes=("float32", "float64"),
                                routing="host", shardable=True),
))

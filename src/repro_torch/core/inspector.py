"""The REAP inspector: the paper's CPU pass (copy of
``repro.core.inspector``; MoE dispatch bundles and combines torch tensors
on their device as well as numpy arrays).

The inspector consumes standard sparse formats and produces *plans*: RIR
bundles + schedule bundles that make the executor's data access completely
regular.  It performs every irregular task of the computation —

  * index matching     (paper: CAM match units)      → precomputed gather ids
  * sorting partials   (paper: shift-register sorter) → plan orders partials
  * merge scheduling   (paper: merge queues)          → precomputed segment ids
  * row splitting      (paper: bundle capacity)       → padded tiles
  * symbolic analysis  (paper: Cholesky etree pass)   → see core.etree

so the device-side executor is a straight stream of FLOPs.

Inspection is split into three stages (runtime.plan_cache exploits this):

  1. **fingerprint** — ``fingerprint_pattern`` digests the sparsity pattern
     (shape, nnz, indptr/indices bytes, capacity/block params) into a
     hashable cache key.  Values are excluded on purpose.
  2. **plan-build** — ``inspect_*`` builds a *pure* plan: only pattern-derived
     index arrays, no numeric values, no timing.  Same pattern ⇒ bit-identical
     plan, so plans are cacheable and serializable artifacts.
  3. **bundle-emit** — ``plan.schedule`` (and the per-level emitters in
     core.cholesky) turn the plan into the schedule bundles the executor
     streams.  This is the cheap per-call stage that the overlapped runtime
     performs on a worker thread while the device executes.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from .formats import BsrPattern, CSR, bsr_pattern_from_csr  # noqa: F401
from .rir import ScheduleBundle
from .routing import expert_assignment, scatter_to_slots


def next_pow2(n: int) -> int:
    """Next power of two ≥ n (shape bucketing: bounds the distinct launch
    shapes to O(log max) across the executors)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, s+c) for s, c in zip(starts, counts)]`` fast."""
    nz = counts > 0
    starts, counts = np.asarray(starts)[nz], np.asarray(counts)[nz]
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    excl = np.cumsum(counts) - counts
    out[excl[1:]] = starts[1:] - (starts[:-1] + counts[:-1]) + 1
    return np.cumsum(out)


# ---------------------------------------------------------------------------
# Stage 1: pattern fingerprints (cache keys)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PatternFingerprint:
    """Hashable identity of a sparse *pattern* + inspection parameters.

    Two calls with the same fingerprint are guaranteed to build bit-identical
    plans: the digest covers indptr/indices (not values), so same-pattern-
    different-values workloads collide on purpose — that is the cache hit
    REAP amortizes its one-time CPU pass over.
    """

    op: str
    shapes: Tuple[Tuple[int, int], ...]
    nnz: Tuple[int, ...]
    digest: str
    params: Tuple[Tuple[str, object], ...]


def csr_pattern_digest(a: CSR) -> str:
    """Digest of one matrix's sparsity pattern (shape + indptr + indices)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64([a.n_rows, a.n_cols]).tobytes())
    h.update(np.ascontiguousarray(a.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indices, dtype=np.int64).tobytes())
    return h.hexdigest()


def fingerprint_pattern(op: str, mats, digests: Optional[Tuple[str, ...]] = None,
                        **params) -> PatternFingerprint:
    """Stage-1 inspection: fingerprint the patterns of ``mats`` under ``op``.

    ``params`` must include every knob that changes the built plan
    (tile / block / capacity / chunking) — a miss on any component rebuilds.

    ``digests`` optionally supplies precomputed ``csr_pattern_digest`` values
    (one per matrix, same order) so callers that key several fingerprints off
    the same operands — e.g. a routing decision plus a plan key in
    ``method="auto"`` — hash each pattern exactly once.
    """
    if digests is None:
        digests = tuple(csr_pattern_digest(m) for m in mats)
    h = hashlib.blake2b(digest_size=16)
    for d in digests:
        h.update(d.encode())
    return PatternFingerprint(
        op=op,
        shapes=tuple((m.n_rows, m.n_cols) for m in mats),
        nnz=tuple(m.nnz for m in mats),
        digest=h.hexdigest(),
        params=tuple(sorted(params.items())))


# ---------------------------------------------------------------------------
# SpGEMM — element (gather) plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class SpGemmGatherPlan:
    """Element-level plan for C = A @ B (row-by-row Gustavson).

    Every partial product t is ``A.data[a_idx[t]] * B.data[b_idx[t]]`` and
    accumulates into output slot ``out_idx[t]``.  Partials are sorted by
    output slot (the paper's sort unit, done once on the host) so the
    device-side merge is a contiguous segment reduction.

    The arrays are padded to a multiple of ``tile`` with a dummy slot
    ``c_nnz`` so the executor shape is static (RIR padding discipline).

    The plan is *pure*: it depends only on the operands' sparsity patterns,
    never their values — same pattern ⇒ bit-identical plan (cacheable).
    """

    n_rows: int
    n_cols: int
    c_nnz: int
    c_indptr: np.ndarray
    c_indices: np.ndarray
    a_idx: np.ndarray
    b_idx: np.ndarray
    out_idx: np.ndarray
    n_pp: int            # live partial products (before padding)
    tile: int = 1024
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def schedule(self) -> ScheduleBundle:
        return ScheduleBundle("spgemm_gather", {
            "a_idx": self.a_idx, "b_idx": self.b_idx, "out_idx": self.out_idx})

    def flops(self) -> int:
        return 2 * self.n_pp


def inspect_spgemm_gather(a: CSR, b: CSR, tile: int = 1024,
                          fingerprint: Optional[PatternFingerprint] = None
                          ) -> SpGemmGatherPlan:
    """Stage-2 plan-build for the gather path (Algorithm 1, lines 2-16 symbolic)."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.n_cols} vs {b.n_rows}")
    b_row_len = b.row_lengths
    k = a.indices                     # match feature: col of A == row of B
    counts = b_row_len[k]             # B-row length per A nnz
    a_idx = np.repeat(np.arange(a.nnz, dtype=np.int64), counts)
    b_idx = _ranges(b.indptr[k], counts)
    out_row = np.repeat(a.nnz_rows(), counts)
    out_col = b.indices[b_idx]
    n_pp = int(a_idx.shape[0])

    # symbolic output pattern: unique (row, col), CSR-ordered
    key = out_row * np.int64(b.n_cols) + out_col
    uniq, inv = np.unique(key, return_inverse=True)
    c_nnz = int(uniq.shape[0])
    c_rows = (uniq // b.n_cols).astype(np.int64)
    c_indices = (uniq % b.n_cols).astype(np.int64)
    c_indptr = np.zeros(a.n_rows + 1, dtype=np.int64)
    np.add.at(c_indptr, c_rows + 1, 1)
    np.cumsum(c_indptr, out=c_indptr)

    # host-side sort of partials by output slot (paper's sort unit)
    order = np.argsort(inv, kind="stable")
    a_idx, b_idx, out_idx = a_idx[order], b_idx[order], inv[order].astype(np.int64)

    # pad to tile with dummy slot c_nnz (value contribution lands off-output)
    pad = (-n_pp) % tile
    if pad or n_pp == 0:
        pad = pad if n_pp else tile
        a_idx = np.concatenate([a_idx, np.zeros(pad, np.int64)])
        b_idx = np.concatenate([b_idx, np.zeros(pad, np.int64)])
        out_idx = np.concatenate([out_idx, np.full(pad, c_nnz, np.int64)])
    return SpGemmGatherPlan(a.n_rows, b.n_cols, c_nnz, c_indptr, c_indices,
                            a_idx, b_idx, out_idx, n_pp, tile, fingerprint)


# ---------------------------------------------------------------------------
# SpGEMM — block (BSR) plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class SpGemmBlockPlan:
    """Block-level plan for C = A @ B on the block (tile) path.

    The schedule is a flat list of block-pair jobs sorted by output block:
      pair t: C_blocks[out_id[t]] += A_blocks[a_id[t]] @ B_blocks[b_id[t]]
    ``is_first[t]`` marks the first pair of each output group, so a streaming
    kernel can zero its accumulator there and write the block out on the
    last pair (``is_last``).  This ordering is the paper's pipeline schedule:
    one output tile in flight per grid lane, operands streamed.

    Like the gather plan, this is pattern-pure: the operand tiles are
    re-materialized per call via ``a_pat.scatter(a.data)``.
    """

    block: int
    a_pat: BsrPattern
    b_pat: BsrPattern
    n_out_blocks: int
    out_brow: np.ndarray
    out_bcol: np.ndarray
    a_id: np.ndarray
    b_id: np.ndarray
    out_id: np.ndarray
    is_first: np.ndarray
    is_last: np.ndarray
    n_pairs: int
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def schedule(self) -> ScheduleBundle:
        return ScheduleBundle("spgemm_block", {
            "a_id": self.a_id.astype(np.int32),
            "b_id": self.b_id.astype(np.int32),
            "out_id": self.out_id.astype(np.int32),
            "is_first": self.is_first.astype(np.int32),
            "is_last": self.is_last.astype(np.int32)})

    def flops(self) -> int:
        return 2 * self.n_pairs * self.block ** 3

    def useful_flops(self) -> int:
        """FLOPs a perfectly element-sparse executor would do (fill metric)."""
        return int(2 * self.a_pat.src_nnz * self.block)

    def out_entry_order(self):
        """Row-major global ordering of every stored output-tile entry.

        Returns ``(perm, rows, cols)``: ``c_blocks.reshape(-1)[perm]`` lists
        the output entries in CSR (row, col) order with global coordinates
        ``rows``/``cols``.  Pattern-pure, so the sort is paid once per plan
        lifetime and the per-call CSR extraction is a gather + mask (see
        ``spgemm.block_result_to_csr``).  Memoized as a plain attribute —
        not a dataclass field, so serialization skips it.
        """
        cached = getattr(self, "_entry_order", None)
        if cached is None:
            bs = self.block
            t = np.repeat(np.arange(self.n_out_blocks), bs * bs)
            rr = np.tile(np.repeat(np.arange(bs), bs), self.n_out_blocks)
            cc = np.tile(np.arange(bs), self.n_out_blocks * bs)
            rows = self.out_brow[t] * bs + rr
            cols = self.out_bcol[t] * bs + cc
            perm = np.lexsort((cols, rows))
            cached = (perm, rows[perm], cols[perm])
            self._entry_order = cached
        return cached


def inspect_spgemm_block(a: CSR, b: CSR, block: int = 128,
                         fingerprint: Optional[PatternFingerprint] = None
                         ) -> SpGemmBlockPlan:
    """Stage-2 plan-build for the block path: block Gustavson schedule."""
    a_pat = bsr_pattern_from_csr(a, block)
    b_pat = bsr_pattern_from_csr(b, block)
    # block-level Gustavson expansion over (a-block, matching b-block-row)
    ab_rows = a_pat.block_rows()                    # block-row of each A block
    k = a_pat.indices                                # block-col == B block-row
    b_row_len = np.diff(b_pat.indptr)
    counts = b_row_len[k]
    a_id = np.repeat(np.arange(a_pat.n_blocks, dtype=np.int64), counts)
    b_id = _ranges(b_pat.indptr[k], counts)
    out_brow = np.repeat(ab_rows, counts)
    out_bcol = b_pat.indices[b_id]

    key = out_brow * np.int64(b_pat.n_block_cols) + out_bcol
    uniq, inv = np.unique(key, return_inverse=True)
    n_out = int(uniq.shape[0])
    order = np.argsort(inv, kind="stable")
    a_id, b_id, out_id = a_id[order], b_id[order], inv[order].astype(np.int64)
    n_pairs = int(a_id.shape[0])
    if n_pairs:
        is_first = np.empty(n_pairs, dtype=bool)
        is_first[0] = True
        is_first[1:] = out_id[1:] != out_id[:-1]
        is_last = np.empty(n_pairs, dtype=bool)
        is_last[-1] = True
        is_last[:-1] = out_id[1:] != out_id[:-1]
    else:
        is_first = np.zeros(0, dtype=bool)
        is_last = np.zeros(0, dtype=bool)
    return SpGemmBlockPlan(block, a_pat, b_pat, n_out,
                           (uniq // b_pat.n_block_cols).astype(np.int64),
                           (uniq % b_pat.n_block_cols).astype(np.int64),
                           a_id, b_id, out_id, is_first, is_last, n_pairs,
                           fingerprint)


# ---------------------------------------------------------------------------
# MoE dispatch — expert-routing plan (same machinery, distinct op tag)
# ---------------------------------------------------------------------------

def routing_csr(expert_ids: np.ndarray, n_experts: int) -> CSR:
    """Token→expert assignment as a CSR pattern for the fingerprint machinery.

    ``expert_ids`` is the (n_tokens, top_k) router output.  The CSR keeps the
    per-token top-k *order* (indices are not column-sorted): two routings
    that pick the same expert sets in a different k-order bundle differently,
    so they must not collide in the plan cache.
    """
    t, k = expert_ids.shape
    ids = np.ascontiguousarray(expert_ids.reshape(-1), dtype=np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n_experts):
        # negative ids would wrap into another expert's slots downstream;
        # masked assignments must be handled by the router, not smuggled in
        raise ValueError(f"expert ids must be in [0, {n_experts}); got "
                         f"range [{ids.min()}, {ids.max()}]")
    return CSR(t, n_experts,
               np.arange(0, t * k + 1, k, dtype=np.int64),
               ids, np.ones(t * k, dtype=np.float32))


@dataclasses.dataclass(eq=False)
class MoeDispatchPlan:
    """Capacity-bundled dispatch plan for one expert-routing pattern.

    The irregular half of MoE dispatch — which token lands in which bundle
    slot, which assignments overflow — depends only on the (token, expert)
    assignment pattern, never on gate values or activations.  The plan fixes:

      * ``dest[i]``       — bundle slot of flat assignment i (row-major over
                            the (n_tokens, top_k) routing); ``n_slots`` marks
                            a dropped (overflow) assignment.
      * ``slot_token[s]`` — token filling bundle slot s (``n_tokens`` = dead
                            padding slot, the RIR discipline).

    Executing a warm plan is two gathers: ``bundle`` packs tokens into
    (n_experts, capacity, d) RIR bundles for the grouped expert GEMM
    (kernels.moe_gemm), ``combine`` gate-mixes expert outputs back to token
    order.  Gates are *values* and are passed at combine time.

    Both take numpy arrays (and return numpy, as the reference does) or
    torch tensors (and gather on the tensor's device, returning a tensor
    there).  For tensors the index arrays are uploaded once per device and
    memoized on the plan, outside its dataclass fields, so payloads stay
    the reference's.
    """

    n_tokens: int
    n_experts: int
    top_k: int
    capacity: int
    dest: np.ndarray          # (n_tokens * top_k,)
    slot_token: np.ndarray    # (n_experts * capacity,)
    fingerprint: Optional[PatternFingerprint] = None

    @property
    def n_slots(self) -> int:
        return self.n_experts * self.capacity

    @property
    def keep(self) -> np.ndarray:
        return self.dest < self.n_slots

    @property
    def dropped_frac(self) -> float:
        """Fraction of assignments lost to capacity overflow (pattern-pure)."""
        return 1.0 - float(self.keep.mean()) if self.dest.size else 0.0

    @property
    def schedule(self) -> ScheduleBundle:
        """The plan's schedule bundle, made on first read and memoized on
        the plan outside its dataclass fields: one object per plan, so a
        device copy kept on it (K5's expert map) serves every warm call."""
        sched = self.__dict__.get("_schedule")
        if sched is None:
            sched = self.__dict__["_schedule"] = ScheduleBundle(
                "moe_dispatch", {
                    "slot_token": self.slot_token.astype(np.int32),
                    "bundle_expert": np.arange(self.n_experts,
                                               dtype=np.int32)})
        return sched

    def device_indices(self, device: torch.device):
        """``(slot_token, dest, keep)`` as tensors on ``device`` (int64,
        int64, bool), uploaded on first use and memoized on the plan."""
        memo = self.__dict__.setdefault("_device_indices", {})
        key = str(device)
        if key not in memo:
            memo[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.slot_token.astype(np.int64),
                          self.dest.astype(np.int64), self.keep))
        return memo[key]

    def bundle(self, tokens):
        """Value pass: (n_tokens, d) → (n_experts, capacity, d) bundles."""
        d = tokens.shape[-1]
        if torch.is_tensor(tokens):
            slot_token, _, _ = self.device_indices(tokens.device)
            pad = torch.cat([tokens, tokens.new_zeros((1, d))])
            return pad.index_select(0, slot_token).reshape(
                self.n_experts, self.capacity, d)
        pad = np.concatenate([tokens, np.zeros((1, d), tokens.dtype)])
        return pad[self.slot_token].reshape(self.n_experts, self.capacity, d)

    def combine(self, y_bundles, gates):
        """Un-bundle expert outputs to token order, mixing with gates.

        ``y_bundles``: (n_experts, capacity, d_out); ``gates``: the
        (n_tokens, top_k) router weights for *this* call's values (numpy or
        a tensor; with tensor bundles they move to the bundles' device).
        """
        d_out = y_bundles.shape[-1]
        if torch.is_tensor(y_bundles):
            _, dest, keep = self.device_indices(y_bundles.device)
            g = gates if torch.is_tensor(gates) else torch.from_numpy(
                np.ascontiguousarray(gates))
            g = g.to(y_bundles.device, non_blocking=True).reshape(-1)
            flat = y_bundles.reshape(self.n_slots, d_out)
            flat = torch.cat([flat, flat.new_zeros((1, d_out))])
            y_rep = flat.index_select(0, dest) * (g * keep).to(
                flat.dtype)[:, None]
            return y_rep.reshape(self.n_tokens, self.top_k, d_out).sum(dim=1)
        flat = y_bundles.reshape(self.n_slots, d_out)
        flat = np.concatenate([flat, np.zeros((1, d_out), flat.dtype)])
        y_rep = flat[self.dest] * (gates.reshape(-1) * self.keep)[:, None]
        return y_rep.reshape(self.n_tokens, self.top_k, d_out).sum(axis=1)


def inspect_moe_dispatch(routing: CSR, capacity: int,
                         fingerprint: Optional[PatternFingerprint] = None
                         ) -> MoeDispatchPlan:
    """Stage-2 plan-build for MoE dispatch (host replica of the router's
    bundling, minus everything value-dependent).

    ``routing`` comes from ``routing_csr``; assignments beyond ``capacity``
    per expert are dropped in stable flat order.
    """
    t, n_experts = routing.n_rows, routing.n_cols
    top_k = int(routing.nnz // max(1, t))
    # the assignment math is shared with the tensor path — core.routing is
    # the single source of truth for both
    _, _, dest = expert_assignment(routing.indices, capacity, n_experts,
                                   xp=np)
    dest = dest.astype(np.int64)
    n_slots = n_experts * capacity
    slot_token = scatter_to_slots(
        dest, np.repeat(np.arange(t, dtype=np.int64), top_k), n_slots,
        fill=t, xp=np)
    return MoeDispatchPlan(t, n_experts, top_k, capacity, dest,
                           slot_token, fingerprint)


def choose_spgemm_path(a: CSR, b: CSR, block: int = 128,
                       fill_threshold: float = 0.02) -> str:
    """Inspector heuristic: pick blocking only when tiles are dense
    enough to beat the gather path (paper: 'CPU has information about the
    FPGA design and uses it to layout the data').

    The block path does 2*block^3 flops per pair regardless of fill; the
    gather path does 2 flops per true partial product at ~1/100 the peak
    rate.  Blocking wins when block fill > ~ (gather rate / tile rate) ≈
    1-2%.  The threshold is the reference's, so both packages route alike.
    """
    a_pat = bsr_pattern_from_csr(a, block)
    return "block" if a_pat.fill >= fill_threshold else "gather"


# ---------------------------------------------------------------------------
# Op registry: MoE dispatch as a planned op (runtime.ops protocol)
# ---------------------------------------------------------------------------
#
# Operands are ``(tokens, expert_ids)``; only the routing *pattern* (the
# token→expert assignment as a CSR) and the capacity enter the fingerprint —
# tokens and gates are values.  A warm plan turns dispatch into two gathers.

from ..runtime.ops import (OpCapabilities, OpSpec,  # noqa: E402
                           register_op)


def _host_ids(expert_ids) -> np.ndarray:
    """The (n_tokens, top_k) routing as a host array (tensors are copied
    back: the pattern is inspected on the host)."""
    if torch.is_tensor(expert_ids):
        return expert_ids.detach().cpu().numpy()
    return np.asarray(expert_ids)


def _prepare_moe_dispatch(operands, cfg, *, n_experts: int, capacity=None,
                          **kw):
    """Derive the routing CSR and resolved capacity once per dispatch —
    shared by the fingerprint and (on a miss) the inspect hook."""
    expert_ids = _host_ids(operands[1])
    if capacity is None:
        from ..models.moe import expert_capacity
        t, k = expert_ids.shape
        capacity = expert_capacity(t, n_experts, k, cfg.moe_capacity_factor)
    return dict(kw, n_experts=n_experts, capacity=int(capacity),
                routing=routing_csr(expert_ids, n_experts))


def _fp_moe_dispatch(operands, cfg, *, chunked, routing, capacity, **kw):
    return fingerprint_pattern("moe_dispatch", (routing,), capacity=capacity)


def _inspect_moe_dispatch(operands, cfg, fp, *, routing, capacity, **kw):
    return inspect_moe_dispatch(routing, capacity, fp)


def _exec_moe_dispatch(plan: MoeDispatchPlan, operands, cfg, *, overlap,
                       **kw):
    import time

    from ..device import resolve_device
    tokens = operands[0]
    t0 = time.perf_counter()
    if torch.is_tensor(tokens):
        # tensors in give bundles on the runtime's device
        x_bundles = plan.bundle(tokens.to(resolve_device(cfg.device),
                                          non_blocking=True))
        if x_bundles.is_cuda:
            # deliberate timed drain: bundle_s measures device completion
            torch.cuda.synchronize(x_bundles.device)
    else:
        x_bundles = plan.bundle(np.asarray(tokens))
    bundle_s = time.perf_counter() - t0
    stats = dict(method="moe_dispatch", bundle_s=bundle_s,
                 capacity=plan.capacity, dropped=plan.dropped_frac)
    return (x_bundles, plan), stats


register_op(OpSpec(
    tag="moe_dispatch",
    prepare=_prepare_moe_dispatch,
    fingerprint=_fp_moe_dispatch,
    inspect=_inspect_moe_dispatch,
    execute_sync=_exec_moe_dispatch,
    plan_types={"moe_dispatch": MoeDispatchPlan},
    allowed_kw=("n_experts", "capacity"),
    # host routing only: the reference's traced in-graph twin comes with
    # the LM stack (ROADMAP queue 1 item 10) and its shard hook with
    # sharding (item 9), so the op is not shardable yet
    capabilities=OpCapabilities(routing="host"),
))

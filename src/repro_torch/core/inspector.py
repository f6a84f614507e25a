"""The REAP inspector: the paper's CPU pass (SpGEMM half of
``repro.core.inspector``, copied; MoE dispatch comes with its own slice).

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

from .formats import BsrPattern, CSR, bsr_pattern_from_csr  # noqa: F401
from .rir import ScheduleBundle


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

"""Elimination tree + symbolic Cholesky factorization (host side).

This is the paper's "CPU performs the symbolic analysis based on the
construction of the elimination tree" (§III-B).  Outputs:

  * ``parent``      — elimination tree (Liu's algorithm, path compression)
  * ``L`` pattern   — CSC sparsity of the factor, including fill-in
  * ``levels``      — etree height level sets: columns within a level have no
                      mutual dependency and factor in parallel (the paper's
                      pipeline-parallel columns)
  * update triples  — for every cmod(k, j) term, precomputed flat positions
                      (src1, src2, dst) into L's value array, grouped by
                      level.  These are REAP's metadata-only RIR bundles: the
                      device never does symbolic work.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .formats import CSR
from .inspector import PatternFingerprint, _ranges


def etree(a_lower: CSR) -> np.ndarray:
    """Liu's elimination-tree algorithm on the lower-triangular pattern."""
    n = a_lower.n_rows
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    indptr, indices = a_lower.indptr, a_lower.indices
    for i in range(n):
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = int(k)
            while ancestor[j] != -1 and ancestor[j] != i:
                nxt = ancestor[j]
                ancestor[j] = i          # path compression
                j = int(nxt)
            if ancestor[j] == -1:
                ancestor[j] = i
                parent[j] = i
    return parent


def symbolic(a_lower: CSR, parent: np.ndarray):
    """Row-subtree traversal → per-row pattern of L → CSC pattern.

    Returns (col_ptr, row_idx): CSC pattern of L with sorted rows per column,
    diagonal always present.
    """
    n = a_lower.n_rows
    indptr, indices = a_lower.indptr, a_lower.indices
    flag = np.full(n, -1, dtype=np.int64)
    rows_out: List[int] = []
    cols_out: List[int] = []
    for i in range(n):
        flag[i] = i
        rows_out.append(i)
        cols_out.append(i)               # diagonal
        for k in indices[indptr[i]:indptr[i + 1]]:
            j = int(k)
            while j != -1 and j < i and flag[j] != i:
                flag[j] = i
                rows_out.append(i)
                cols_out.append(j)       # L(i, j) != 0
                j = int(parent[j])
    rows = np.asarray(rows_out, dtype=np.int64)
    cols = np.asarray(cols_out, dtype=np.int64)
    order = np.lexsort((rows, cols))     # CSC: sort by (col, row)
    rows, cols = rows[order], cols[order]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr, cols + 1, 1)
    np.cumsum(col_ptr, out=col_ptr)
    return col_ptr, rows


def etree_levels(parent: np.ndarray) -> np.ndarray:
    """Height of each node above the leaves; equal heights ⇒ independent."""
    n = parent.shape[0]
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):                   # parent[j] > j ⇒ single pass works
        p = parent[j]
        if p != -1 and level[p] < level[j] + 1:
            level[p] = level[j] + 1
    return level


@dataclasses.dataclass(eq=False)
class CholeskyPlan:
    """Everything the numeric executor needs, fully precomputed.

    Value array layout: L values in CSC order, length ``nnz``; slot ``nnz``
    is a scratch slot absorbing padded (dead) operations.

    The plan is pattern-pure (no values of A, no timing): the numeric
    executor takes ``a_vals`` separately (see ``cholesky_values``), so one
    plan amortizes over any number of same-pattern factorizations.
    """

    n: int
    nnz: int
    col_ptr: np.ndarray           # (n+1,)
    row_idx: np.ndarray           # (nnz,)
    diag_pos: np.ndarray          # (n,)   position of L(k,k)
    a_scatter_pos: np.ndarray     # (nnz_A_lower,) slot of each A entry
    a_lower_sel: np.ndarray       # (nnz_A_lower,) index into A.data per entry
    levels: np.ndarray            # (n,)   level of each column
    n_levels: int
    # per-level update triples and column lists (lists of numpy arrays)
    upd_src1: List[np.ndarray]
    upd_src2: List[np.ndarray]
    upd_dst: List[np.ndarray]
    cols_per_level: List[np.ndarray]
    fingerprint: Optional[PatternFingerprint] = None

    def flops(self) -> int:
        mulsub = sum(2 * s.shape[0] for s in self.upd_src1)
        return mulsub + int(self.nnz) + self.n  # + div per offdiag + sqrt

    def a_values(self, a: CSR) -> np.ndarray:
        """Warm-path value pass: gather A's lower-triangle values through the
        plan's precomputed selection (O(nnz), no re-sort — unlike the
        plan-less ``cholesky_values``)."""
        return a.data[self.a_lower_sel].astype(np.float64, copy=False)

    def col_of_slot(self) -> np.ndarray:
        """Column of every L slot, memoized — pattern-pure, so computed once
        per plan lifetime (not per factorization).  Plain attribute, not a
        dataclass field: serialization ignores it."""
        cached = getattr(self, "_col_of_slot", None)
        if cached is None:
            cached = np.repeat(np.arange(self.n), np.diff(self.col_ptr))
            self._col_of_slot = cached
        return cached


def cholesky_values(a: CSR) -> np.ndarray:
    """Per-call value pass: A's lower-triangle values in the CSR order that
    ``plan.a_scatter_pos`` indexes (same pattern ⇒ same order)."""
    return a.lower_triangle().data.astype(np.float64, copy=True)


def inspect_cholesky(a: CSR,
                     fingerprint: Optional[PatternFingerprint] = None
                     ) -> CholeskyPlan:
    """Full host pass: etree → symbolic → level-grouped update schedule."""
    n = a.n_rows
    a_low = a.lower_triangle()
    parent = etree(a_low)
    col_ptr, row_idx = symbolic(a_low, parent)
    nnz = int(row_idx.shape[0])
    level = etree_levels(parent)
    n_levels = int(level.max()) + 1 if n else 0

    # diagonal position: first entry of each column (rows sorted, diag min)
    diag_pos = col_ptr[:-1].copy()
    assert np.array_equal(row_idx[diag_pos], np.arange(n)), "diag missing"

    # scatter positions of A's lower entries into L slots
    col_of_slot = np.repeat(np.arange(n), np.diff(col_ptr))
    key_l = col_of_slot * np.int64(n) + row_idx     # sorted ascending
    a_coo = a_low.to_coo()
    key_a = a_coo.col * np.int64(n) + a_coo.row
    a_pos = np.searchsorted(key_l, key_a)
    assert np.array_equal(key_l[a_pos], key_a), "A pattern ⊄ L pattern"

    # selection of A's lower entries directly in A.data order: canonical CSR
    # keeps lower_triangle() order-stable, so this gather replaces the
    # per-call rebuild+sort on the warm path (plan.a_values)
    a_rows = a.nnz_rows()
    a_lower_sel = np.nonzero(a_rows >= a.indices)[0]
    # canonicality check on (row, col) keys, not values: the gather's
    # coordinate sequence must equal the canonicalized lower triangle's,
    # keeping the plan build pattern-pure (reaplint REAP001)
    key_sel = a_rows[a_lower_sel] * np.int64(n) + a.indices[a_lower_sel]
    assert np.array_equal(key_sel, a_coo.row * np.int64(n) + a_coo.col), \
        "CSR not canonical (cols unsorted within rows)"

    # --- update triples: for column j, ordered pairs (p <= q) of off-diag
    # entries; cmod target column k = row[p], target row r = row[q].
    offd_mask = row_idx != col_of_slot
    offd_slots = np.nonzero(offd_mask)[0]
    offd_col = col_of_slot[offd_slots]
    # per (column j, local p): number of q's = (#offdiag in j) - p
    cj = np.diff(col_ptr) - 1                        # off-diag count per col
    p_local = np.arange(offd_slots.shape[0]) - np.repeat(
        np.cumsum(cj) - cj, cj)
    counts = np.repeat(cj, cj) - p_local             # q count per p-entry
    src2 = np.repeat(offd_slots, counts)             # L(k, j) slot
    src1 = _ranges(offd_slots, counts)               # L(r, j) slot (r >= k)
    dst_col = row_idx[src2]                          # k
    dst_row = row_idx[src1]                          # r
    dst = np.searchsorted(key_l, dst_col * np.int64(n) + dst_row)
    assert np.array_equal(key_l[dst], dst_col * np.int64(n) + dst_row), \
        "fill-in theorem violated (symbolic bug)"

    # group triples + columns by level of the *destination* column
    dlev = level[dst_col]
    upd_src1, upd_src2, upd_dst, cols_per_level = [], [], [], []
    order = np.argsort(dlev, kind="stable")
    src1, src2, dst, dlev = src1[order], src2[order], dst[order], dlev[order]
    bounds = np.searchsorted(dlev, np.arange(n_levels + 1))
    col_order = np.argsort(level, kind="stable")
    col_bounds = np.searchsorted(level[col_order], np.arange(n_levels + 1))
    for ell in range(n_levels):
        s, e = bounds[ell], bounds[ell + 1]
        # sort this level's triples by dst for segment locality
        seg = np.argsort(dst[s:e], kind="stable")
        upd_src1.append(src1[s:e][seg])
        upd_src2.append(src2[s:e][seg])
        upd_dst.append(dst[s:e][seg])
        cols_per_level.append(col_order[col_bounds[ell]:col_bounds[ell + 1]])
    return CholeskyPlan(n, nnz, col_ptr, row_idx, diag_pos, a_pos,
                        a_lower_sel, level, n_levels,
                        upd_src1, upd_src2, upd_dst, cols_per_level,
                        fingerprint)

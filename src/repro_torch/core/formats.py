"""Host-side sparse matrix containers (numpy).

These are the *standard formats* of the paper (CSR/CSC/COO) plus BSR, the
block format the block executor (kernel K1) consumes.  Everything here runs
on the host as part of REAP's CPU pass; no torch is imported.

A copy of ``repro.core.formats``: the generators produce bit-identical
matrices from the same seed, which the parity tests rely on.  Conversions
are vectorized numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class COO:
    """Coordinate format: parallel (row, col, val) arrays."""

    n_rows: int
    n_cols: int
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def to_csr(self) -> "CSR":
        return CSR.from_coo(self)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.val.dtype)
        np.add.at(out, (self.row, self.col), self.val)
        return out


@dataclasses.dataclass
class CSR:
    """Compressed sparse row. ``indptr`` has length n_rows+1."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def density(self) -> float:
        denom = max(1, self.n_rows * self.n_cols)
        return self.nnz / denom

    def nnz_rows(self) -> np.ndarray:
        """Row index of every stored element (COO expansion of indptr)."""
        return np.repeat(np.arange(self.n_rows), self.row_lengths)

    @staticmethod
    def from_coo(coo: COO, sum_duplicates: bool = True) -> "CSR":
        order = np.lexsort((coo.col, coo.row))
        row, col, val = coo.row[order], coo.col[order], coo.val[order]
        if sum_duplicates and row.size:
            key_new = np.empty(row.size, dtype=bool)
            key_new[0] = True
            key_new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
            group = np.cumsum(key_new) - 1
            n_unique = int(group[-1]) + 1
            uval = np.zeros(n_unique, dtype=val.dtype)
            np.add.at(uval, group, val)
            row, col, val = row[key_new], col[key_new], uval
        indptr = np.zeros(coo.n_rows + 1, dtype=np.int64)
        np.add.at(indptr, row + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSR(coo.n_rows, coo.n_cols, indptr, col.astype(np.int64), val)

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSR":
        r, c = np.nonzero(a)
        return CSR.from_coo(COO(a.shape[0], a.shape[1], r, c, a[r, c]))

    def to_coo(self) -> COO:
        return COO(self.n_rows, self.n_cols, self.nnz_rows(), self.indices.copy(), self.data.copy())

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def transpose(self) -> "CSR":
        """CSR of A^T (equivalently: the CSC view of A)."""
        coo = self.to_coo()
        return CSR.from_coo(COO(self.n_cols, self.n_rows, coo.col, coo.row, coo.val),
                            sum_duplicates=False)

    def row_slice(self, r0: int, r1: int) -> "CSR":
        """Zero-copy CSR view of rows [r0, r1) (chunked inspection)."""
        s, e = int(self.indptr[r0]), int(self.indptr[r1])
        return CSR(r1 - r0, self.n_cols, self.indptr[r0:r1 + 1] - s,
                   self.indices[s:e], self.data[s:e])

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.data[s:e]

    def lower_triangle(self, strict: bool = False) -> "CSR":
        coo = self.to_coo()
        keep = coo.row > coo.col if strict else coo.row >= coo.col
        return CSR.from_coo(
            COO(self.n_rows, self.n_cols, coo.row[keep], coo.col[keep], coo.val[keep]),
            sum_duplicates=False)


@dataclasses.dataclass
class BSR:
    """Block sparse row: dense ``block x block`` tiles at block coordinates.

    This is the block RIR bundle layout — each stored block is one tile of
    the block executor; ``indptr``/``indices`` address *block* rows/cols.
    """

    n_rows: int      # element rows (padded to a multiple of block)
    n_cols: int
    block: int
    indptr: np.ndarray   # (n_block_rows + 1,)
    indices: np.ndarray  # (n_blocks,) block-column of each block
    blocks: np.ndarray   # (n_blocks, block, block)

    @property
    def n_block_rows(self) -> int:
        return self.n_rows // self.block

    @property
    def n_block_cols(self) -> int:
        return self.n_cols // self.block

    @property
    def n_blocks(self) -> int:
        return int(self.indices.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of stored block entries that are structurally nonzero."""
        if self.n_blocks == 0:
            return 0.0
        return float(np.count_nonzero(self.blocks)) / self.blocks.size

    def block_rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_block_rows), np.diff(self.indptr))

    @staticmethod
    def from_csr(a: CSR, block: int) -> "BSR":
        pat = bsr_pattern_from_csr(a, block)
        blocks = np.zeros((pat.n_blocks, block, block), dtype=a.data.dtype)
        np.add.at(blocks, (pat.elem_block, pat.elem_row, pat.elem_col), a.data)
        return BSR(pat.n_rows, pat.n_cols, block, pat.indptr, pat.indices,
                   blocks)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.blocks.dtype)
        br = self.block_rows()
        for t in range(self.n_blocks):
            r0, c0 = br[t] * self.block, self.indices[t] * self.block
            out[r0:r0 + self.block, c0:c0 + self.block] += self.blocks[t]
        return out


@dataclasses.dataclass(eq=False)
class BsrPattern:
    """Block-sparse structure + element scatter map, with no values.

    The value-free half of ``BSR``: ``BSR.from_csr`` is this pattern plus a
    value scatter, and the inspector caches it inside pattern-pure plans.
    ``scatter(data)`` re-materializes the dense (n_blocks, block, block)
    tiles from a CSR value array in the source matrix's element order — the
    O(nnz) per-call cost that remains after a plan is cached.
    """

    n_rows: int      # element rows, padded to a multiple of block
    n_cols: int
    src_n_rows: int  # unpadded source dims
    src_n_cols: int
    block: int
    indptr: np.ndarray     # (n_block_rows + 1,)
    indices: np.ndarray    # (n_blocks,) block-col of each block
    elem_block: np.ndarray  # (src_nnz,) destination block of each CSR element
    elem_row: np.ndarray    # (src_nnz,) local row within the block
    elem_col: np.ndarray    # (src_nnz,) local col within the block

    @property
    def n_block_rows(self) -> int:
        return self.n_rows // self.block

    @property
    def n_block_cols(self) -> int:
        return self.n_cols // self.block

    @property
    def n_blocks(self) -> int:
        return int(self.indices.shape[0])

    @property
    def src_nnz(self) -> int:
        return int(self.elem_block.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of stored block entries that are structurally nonzero."""
        denom = self.n_blocks * self.block * self.block
        return self.src_nnz / denom if denom else 0.0

    def block_rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_block_rows), np.diff(self.indptr))

    def scatter(self, data: np.ndarray, dtype=np.float32) -> np.ndarray:
        """Value pass: CSR data (element order) → dense block tiles."""
        blocks = np.zeros((self.n_blocks, self.block, self.block), dtype=dtype)
        blocks[self.elem_block, self.elem_row, self.elem_col] = data
        return blocks


def bsr_pattern_from_csr(a: CSR, block: int) -> BsrPattern:
    """Structure-only block decomposition (no value traffic)."""
    nr = -(-a.n_rows // block) * block
    nc = -(-a.n_cols // block) * block
    rows, cols = a.nnz_rows(), a.indices
    brow, bcol = rows // block, cols // block
    nbc = nc // block
    key = brow * np.int64(nbc) + bcol
    uniq = np.unique(key)
    inv = np.searchsorted(uniq, key)
    ubrow, ubcol = uniq // nbc, uniq % nbc
    indptr = np.zeros(nr // block + 1, dtype=np.int64)
    np.add.at(indptr, ubrow + 1, 1)
    np.cumsum(indptr, out=indptr)
    return BsrPattern(nr, nc, a.n_rows, a.n_cols, block, indptr,
                      ubcol.astype(np.int64), inv.astype(np.int64),
                      (rows % block).astype(np.int64),
                      (cols % block).astype(np.int64))


# ---------------------------------------------------------------------------
# Synthetic matrix generators (SuiteSparse stand-ins for the offline container)
# ---------------------------------------------------------------------------

def random_csr(n_rows: int, n_cols: int, density: float, rng: np.random.Generator,
               pattern: str = "uniform", dtype=np.float32) -> CSR:
    """Random sparse matrix with a controllable structure.

    ``pattern``:
      * ``uniform``  — iid positions (models e.g. cage12)
      * ``powerlaw`` — skewed row lengths (models web/graph matrices)
      * ``banded``   — diagonal band (models PDE meshes: offshore, filter3D)
      * ``blocky``   — clustered dense-ish blocks (models FEM: cant, consph)
    """
    target = max(n_rows, int(density * n_rows * n_cols))
    if pattern == "uniform":
        row = rng.integers(0, n_rows, target)
        col = rng.integers(0, n_cols, target)
    elif pattern == "powerlaw":
        w = 1.0 / np.arange(1, n_rows + 1) ** 0.8
        row = rng.choice(n_rows, size=target, p=w / w.sum())
        col = rng.integers(0, n_cols, target)
    elif pattern == "banded":
        bw = max(2, int(density * n_cols * 4))
        row = rng.integers(0, n_rows, target)
        off = rng.integers(-bw, bw + 1, target)
        col = np.clip(row * n_cols // max(1, n_rows) + off, 0, n_cols - 1)
    elif pattern == "blocky":
        nb = max(1, n_rows // 64)
        b = rng.integers(0, nb, target)
        row = np.clip(b * 64 + rng.integers(0, 64, target), 0, n_rows - 1)
        col = np.clip(b * 64 * n_cols // max(1, n_rows) + rng.integers(0, 64, target),
                      0, n_cols - 1)
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    val = rng.standard_normal(target).astype(dtype)
    return CSR.from_coo(COO(n_rows, n_cols, row, col, val))


def random_spd_csr(n: int, density: float, rng: np.random.Generator,
                   pattern: str = "banded", dtype=np.float64) -> CSR:
    """Sparse symmetric positive-definite matrix (for Cholesky).

    Built as ``B + B^T + diag(shift)`` with a diagonal shift that guarantees
    strict diagonal dominance → SPD.
    """
    b = random_csr(n, n, density / 2, rng, pattern, dtype)
    coo = b.to_coo()
    row = np.concatenate([coo.row, coo.col])
    col = np.concatenate([coo.col, coo.row])
    val = np.concatenate([coo.val, coo.val])
    sym = CSR.from_coo(COO(n, n, row, col, val))
    # diagonal dominance: diag = 1 + sum |off-diag| per row
    rowsum = np.zeros(n, dtype=np.float64)
    np.add.at(rowsum, sym.nnz_rows(), np.abs(sym.data))
    drow = np.arange(n)
    coo2 = sym.to_coo()
    row = np.concatenate([coo2.row, drow])
    col = np.concatenate([coo2.col, drow])
    val = np.concatenate([coo2.val, rowsum + 1.0])
    return CSR.from_coo(COO(n, n, row, col, val.astype(dtype)))

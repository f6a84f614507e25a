"""RIR — REAP Intermediate Representation (copy of ``repro.core.rir``).

The paper's RIR bundle co-locates a *shared feature* (e.g. row id), the
*distinct features* (e.g. column indices), the values, and metadata (element
count, end-of-row flag).  Bundles linearize a sparse structure so the
accelerator streams memory instead of chasing indirections, and metadata-only
bundles carry pure scheduling information.

The bundle kinds:

* **Element bundles** — fixed-capacity padded rows for the gather path.
  The paper uses capacity 32 (CAM-size bound); the default here is 128.
  Rows longer than the capacity are split across bundles exactly like the
  paper ("CPU breaks the whole row into multiple bundles"), with a
  continuation flag instead of an end-of-row marker.

* **Block bundles** — dense ``(block, block)`` tiles (BSR layout) for the
  block path.  The shared feature is the (block-row, block-col) coordinate.

* **Schedule bundles** — metadata-only arrays (group offsets, operand block
  ids) that drive the executor's data movement.  The block kernel (K1)
  reads them as int32 device arrays: each thread block looks up its own
  operand tiles, the analogue of REAP's input controller routing bundles
  to pipelines.

Everything in this file is host-side numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR

# Default element-bundle capacity: one VPU lane row. The paper's 32 was a CAM
# frequency bound; ours is the TPU lane width.
DEFAULT_CAPACITY = 128


@dataclasses.dataclass
class ElementBundles:
    """Padded element bundles for one sparse matrix.

    shape invariants:
      shared:  (nb,)        int64  — shared feature (row id)
      count:   (nb,)        int64  — live elements in the bundle (<= capacity)
      index:   (nb, cap)    int64  — distinct feature (col ids), padded with -1
      value:   (nb, cap)    f32/64 — values, padded with 0
      is_cont: (nb,)        bool   — True if this bundle continues the
                                     previous bundle's row (paper: split rows)
    """

    capacity: int
    n_rows: int
    n_cols: int
    shared: np.ndarray
    count: np.ndarray
    index: np.ndarray
    value: np.ndarray
    is_cont: np.ndarray

    @property
    def n_bundles(self) -> int:
        return int(self.shared.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.count.sum())

    @property
    def pad_fraction(self) -> float:
        total = self.n_bundles * self.capacity
        return 1.0 - self.nnz / total if total else 0.0


def pack_csr(a: CSR, capacity: int = DEFAULT_CAPACITY) -> ElementBundles:
    """CPU pass: repack CSR rows into fixed-capacity RIR element bundles."""
    lens = a.row_lengths
    # bundles per row (ceil, at least 0; empty rows produce no bundle)
    nb_per_row = -(-lens // capacity)
    nb = int(nb_per_row.sum())
    shared = np.repeat(np.arange(a.n_rows), nb_per_row).astype(np.int64)
    # index of each bundle within its row -> is_cont + live count
    bundle_pos = np.arange(nb) - np.repeat(
        np.cumsum(nb_per_row) - nb_per_row, nb_per_row)
    is_cont = bundle_pos > 0
    remaining = np.repeat(lens, nb_per_row) - bundle_pos * capacity
    count = np.minimum(remaining, capacity).astype(np.int64)
    index = np.full((nb, capacity), -1, dtype=np.int64)
    value = np.zeros((nb, capacity), dtype=a.data.dtype)
    if a.nnz:
        # destination of every nnz: (bundle, slot)
        first_bundle_of_row = np.cumsum(nb_per_row) - nb_per_row
        pos_in_row = np.arange(a.nnz) - np.repeat(a.indptr[:-1], lens)
        dst_bundle = np.repeat(first_bundle_of_row, lens) + pos_in_row // capacity
        dst_slot = pos_in_row % capacity
        index[dst_bundle, dst_slot] = a.indices
        value[dst_bundle, dst_slot] = a.data
    return ElementBundles(capacity, a.n_rows, a.n_cols, shared, count, index,
                          value, is_cont)


def unpack_to_csr(b: ElementBundles) -> CSR:
    """Decompress routine (paper §II): RIR → CSR."""
    slot = np.arange(b.capacity)[None, :]
    live = slot < b.count[:, None]
    rows = np.repeat(b.shared, b.count)
    cols = b.index[live]
    vals = b.value[live]
    from .formats import COO
    return CSR.from_coo(COO(b.n_rows, b.n_cols, rows, cols, vals),
                        sum_duplicates=False)


@dataclasses.dataclass
class ScheduleBundle:
    """Metadata-only RIR bundle: pure scheduling information.

    ``arrays`` maps names to int32 numpy arrays. Executors copy these to the
    device as plain int32 tensors; nothing here holds numeric data.
    """

    name: str
    arrays: dict

    def __getitem__(self, key: str) -> np.ndarray:
        return self.arrays[key]

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.arrays.values()))

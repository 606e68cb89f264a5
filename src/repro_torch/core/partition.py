"""Partitioning sparse matrices across mesh shards (host numpy).

The paper's 61 cores pull rows dynamically off a shared queue; a mesh of
devices needs a static partition:

* ``rows_balanced`` — contiguous row ranges with about equal nnz (the 1-D
  row-parallel decomposition; x is all-gathered or rotated).
* ``grid_2d`` — an (R x C) block partition: shard (i, j) owns a row slab x
  column slab, with slab-local column indices.

``stack_csr_shards`` / ``stack_grid_shards`` pad the shards to a common
row count and nnz and stack them, so every shard's arrays have one shape.
Every array equals the JAX package's ``core/partition.py`` output for the
same matrix, dtype and byte for byte; ``grid_2d`` gets there with one
vectorised pass over ``indices`` per column slab instead of a Python loop
over rows (the loop takes seconds at Table 1 sizes).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSRMatrix, nnz_row_ids

__all__ = ["rows_balanced", "RowPartition", "grid_2d", "stack_csr_shards",
           "stack_grid_shards"]


@dataclasses.dataclass
class RowPartition:
    bounds: np.ndarray  # (n_shards + 1,) row boundaries
    shards: list[CSRMatrix]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def nnz_imbalance(self) -> float:
        nnzs = np.array([s.nnz for s in self.shards], dtype=np.float64)
        return float(nnzs.max() / max(nnzs.mean(), 1e-9))


def rows_balanced(a: CSRMatrix, n_shards: int) -> RowPartition:
    """Contiguous row ranges with approximately equal nnz per shard."""
    m, n = a.shape
    target = np.linspace(0, a.nnz, n_shards + 1)
    bounds = np.searchsorted(a.indptr, target, side="left")
    bounds[0], bounds[-1] = 0, m
    bounds = np.maximum.accumulate(bounds)  # keep monotone
    shards = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        ip = (a.indptr[lo : hi + 1] - a.indptr[lo]).astype(a.indptr.dtype)
        sl = slice(a.indptr[lo], a.indptr[hi])
        shards.append(CSRMatrix((hi - lo, n), ip, a.indices[sl].copy(), a.data[sl].copy()))
    return RowPartition(bounds.astype(np.int64), shards)


def grid_2d(a: CSRMatrix, grid: tuple[int, int]) -> list[list[CSRMatrix]]:
    """(R x C) block partition: shard (i, j) owns row slab i x column slab j,
    its column indices rebased to the slab (it multiplies its x slab).

    Per column slab, one pass over ``indices`` marks the entries inside it
    and a prefix count of the marks gives every row's entry count; each row
    slab is then a slice.  Entries keep their stored order."""
    R, C = grid
    m, n = a.shape
    rb = np.linspace(0, m, R + 1).astype(np.int64)
    cb = np.linspace(0, n, C + 1).astype(np.int64)
    indptr = np.asarray(a.indptr, dtype=np.int64)
    out: list[list[CSRMatrix]] = [[] for _ in range(R)]
    for j in range(C):
        cl, ch = cb[j], cb[j + 1]
        inside = (a.indices >= cl) & (a.indices < ch)
        marks = np.zeros(a.nnz + 1, dtype=np.int64)
        np.cumsum(inside, out=marks[1:])
        at_row = marks[indptr]  # entries inside the slab before each row
        for i in range(R):
            lo, hi = rb[i], rb[i + 1]
            s, e = indptr[lo], indptr[hi]
            sel = inside[s:e]
            out[i].append(
                CSRMatrix(
                    (int(hi - lo), int(ch - cl)),
                    (at_row[lo : hi + 1] - at_row[lo]).astype(a.indptr.dtype),
                    (a.indices[s:e][sel] - cl).astype(a.indices.dtype),
                    a.data[s:e][sel],
                )
            )
    return out


def _padded_row_map(indptr: np.ndarray, nnz: int, max_nnz: int,
                    max_rows: int) -> np.ndarray:
    """Per-nnz row ids, padded with ``max_rows`` (out of segment range, so
    padding entries drop out of a segment sum)."""
    rows = np.full(max_nnz, max_rows, dtype=np.int32)
    rows[:nnz] = nnz_row_ids(indptr)
    return rows


def stack_csr_shards(shards: list[CSRMatrix]) -> dict[str, np.ndarray]:
    """Pad shards to a common (rows, nnz) and stack them.

    Padding rows are empty; padding nnz entries point at column 0 with value
    0.0 and lie past each shard's ``indptr[-1]``.  ``rows`` is the per-nnz
    row map the JAX package's segment sum reads; ``n_rows`` the valid rows
    per shard."""
    max_rows = max(s.shape[0] for s in shards)
    max_nnz = max(s.nnz for s in shards)
    P = len(shards)
    indptr = np.zeros((P, max_rows + 1), dtype=shards[0].indptr.dtype)
    indices = np.zeros((P, max_nnz), dtype=shards[0].indices.dtype)
    data = np.zeros((P, max_nnz), dtype=shards[0].data.dtype)
    rows = np.zeros((P, max_nnz), dtype=np.int32)
    n_rows = np.zeros((P,), dtype=np.int32)
    for p, s in enumerate(shards):
        r = s.shape[0]
        indptr[p, : r + 1] = s.indptr
        indptr[p, r + 1 :] = s.indptr[-1]
        indices[p, : s.nnz] = s.indices
        data[p, : s.nnz] = s.data
        rows[p] = _padded_row_map(s.indptr, s.nnz, max_nnz, max_rows)
        n_rows[p] = r
    return {"indptr": indptr, "indices": indices, "data": data, "rows": rows,
            "n_rows": n_rows}


def stack_grid_shards(grid: list[list[CSRMatrix]]) -> dict[str, np.ndarray]:
    """Pad an (R x C) CSR grid to a common (rows, nnz) and stack to
    (R, C, ...): the ring schedule's operand.  Every cell is padded to the
    largest cell's nnz, as in the JAX package, so an off-diagonal cell of a
    banded matrix stores as many entries as a diagonal one.  ``n_rows`` is
    the valid row count per row slab."""
    R, C = len(grid), len(grid[0])
    cells = [c for row in grid for c in row]
    max_rows = max(c.shape[0] for c in cells)
    max_nnz = max(c.nnz for c in cells)
    proto = cells[0]
    indptr = np.zeros((R, C, max_rows + 1), dtype=proto.indptr.dtype)
    indices = np.zeros((R, C, max_nnz), dtype=proto.indices.dtype)
    data = np.zeros((R, C, max_nnz), dtype=proto.data.dtype)
    rows = np.zeros((R, C, max_nnz), dtype=np.int32)
    n_rows = np.zeros((R,), dtype=np.int32)
    for i, row in enumerate(grid):
        n_rows[i] = row[0].shape[0]
        for j, cell in enumerate(row):
            r = cell.shape[0]
            indptr[i, j, : r + 1] = cell.indptr
            indptr[i, j, r + 1 :] = cell.indptr[-1]
            indices[i, j, : cell.nnz] = cell.indices
            data[i, j, : cell.nnz] = cell.data
            rows[i, j] = _padded_row_map(cell.indptr, cell.nnz, max_nnz, max_rows)
    return {"indptr": indptr, "indices": indices, "data": data, "rows": rows,
            "n_rows": n_rows}

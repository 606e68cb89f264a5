"""The paper's structural and bandwidth metrics: the tuner's, and the
bandwidth and intensity models of its figures.

UCLD (useful cacheline density, paper §4.1/Fig 5): per row, the ratio of the
row's nnz to the number of x-vector *elements* covered by the cachelines that
row touches; averaged over rows.  A cacheline holds ``line_width`` elements
(8 for the paper's f64/64B lines).  Range [1/line_width, 1].

UTD (useful tile density): the denominator is a (tile_rows, tile_cols) tile
instead of the cacheline, evaluated over the 2-D pattern.

Bandwidth models (paper §4.2, Fig 6):
  naive_bytes  = tau * (val_bytes + idx_bytes)
  app_bytes    = 2*n*val_bytes + (n+1)*idx_bytes + tau*(val_bytes+idx_bytes)
  spmm variants scale the vector terms by k.

Host numpy only; every value equals the JAX package's for the same matrix.
"""
from __future__ import annotations

import numpy as np

from .formats import BCSRMatrix, CSRMatrix

__all__ = [
    "ucld",
    "ucld_per_row",
    "utd",
    "block_fill_histogram",
    "spmv_naive_bytes",
    "spmv_app_bytes",
    "spmm_app_bytes",
    "flop_to_byte_spmv",
    "flop_to_byte_spmm",
    "matrix_bandwidth",
    "sorted_unique",
]


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` through one sort.  From numpy 2.3 on, ``np.unique``
    takes a hash-table path that is far slower than a sort on millions of
    distinct int64 keys (seconds against tens of milliseconds)."""
    s = np.sort(keys, axis=None)
    if s.size == 0:
        return s
    keep = np.empty(s.size, dtype=bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def ucld_per_row(a: CSRMatrix, line_width: int = 8) -> np.ndarray:
    """Paper's UCLD for each row: nnz_row / (lines_touched * line_width)."""
    m, n = a.shape
    lengths = np.diff(a.indptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    n_lines_per_col = -(-n // line_width)
    key = rows * n_lines_per_col + a.indices // line_width
    uniq_rows = sorted_unique(key) // n_lines_per_col  # one entry per (row, line)
    lines_touched = np.bincount(uniq_rows.astype(np.int64), minlength=m)
    out = np.ones(m, dtype=np.float64)  # empty rows count as perfectly dense
    nz = lengths > 0
    out[nz] = lengths[nz] / (lines_touched[nz] * line_width)
    return out


def ucld(a: CSRMatrix, line_width: int = 8) -> float:
    """Average UCLD (paper Fig 5 x-axis). Worst 1/line_width, best 1.0."""
    per_row = ucld_per_row(a, line_width)
    if per_row.size == 0:  # a zero-row matrix must not yield a NaN feature
        return 1.0
    return float(per_row.mean())


def utd(a: CSRMatrix, tile: tuple[int, int] = (8, 128)) -> float:
    """Useful tile density: nnz / (touched_tiles * tile_elems)."""
    tr, tc = tile
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    tiles = (rows // tr).astype(np.int64) * (
        -(-a.shape[1] // tc)
    ) + a.indices // tc
    n_tiles = sorted_unique(tiles).shape[0]
    if n_tiles == 0:
        return 1.0
    return a.nnz / (n_tiles * tr * tc)


def block_fill_histogram(a: BCSRMatrix, bins: int = 10) -> np.ndarray:
    """Histogram of per-block density — drives the paper's Table 2 analysis."""
    dens = (a.blocks != 0).reshape(a.n_blocks, -1).mean(axis=1)
    hist, _ = np.histogram(dens, bins=bins, range=(0.0, 1.0))
    return hist


def spmv_naive_bytes(nnz: int, val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Paper's naive model: only the nonzeros move (12B/nnz at f64+i32)."""
    return nnz * (val_bytes + idx_bytes)


def spmv_app_bytes(
    n_rows: int, n_cols: int, nnz: int, val_bytes: int = 4, idx_bytes: int = 4
) -> int:
    """Paper's application bytes: 2n*val + (n+1)*idx + tau*(val+idx)."""
    return (
        (n_rows + n_cols) * val_bytes
        + (n_rows + 1) * idx_bytes
        + nnz * (val_bytes + idx_bytes)
    )


def spmm_app_bytes(
    n_rows: int,
    n_cols: int,
    nnz: int,
    k: int,
    val_bytes: int = 4,
    idx_bytes: int = 4,
) -> int:
    """Paper §5: 8mk + 8nk + 4(n+1) + 12tau, parameterized by dtype sizes."""
    return (
        (n_rows + n_cols) * k * val_bytes
        + (n_rows + 1) * idx_bytes
        + nnz * (val_bytes + idx_bytes)
    )


def flop_to_byte_spmv(val_bytes: int = 4, idx_bytes: int = 4) -> float:
    """2 flops per nnz over (val+idx) bytes: paper's 2/12 at f64."""
    return 2.0 / (val_bytes + idx_bytes)


def flop_to_byte_spmm(
    n_rows: int, n_cols: int, nnz: int, k: int, val_bytes: int = 4, idx_bytes: int = 4
) -> float:
    return (2.0 * nnz * k) / spmm_app_bytes(
        n_rows, n_cols, nnz, k, val_bytes, idx_bytes
    )


def matrix_bandwidth(a: CSRMatrix) -> int:
    """Graph-theoretic bandwidth max|i-j| over nonzeros (RCM's objective)."""
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    if rows.size == 0:
        return 0
    return int(np.abs(rows - a.indices).max())

"""Sparse matrix storage formats: host construction in numpy, torch on device.

The paper (Saule, Kaya, Catalyurek, 2013) uses CRS (a.k.a. CSR) as the
baseline format, 8x{1..8} register-blocked dense blocks (BCSR-like) for its
register blocking study (Table 2), and OpenMP ``dynamic,64`` scheduling for
load balance.  The formats here keep CSR as the reference/oracle format and
add:

* BCSR with dense (bm, bk) blocks — the register-blocking study;
* SELL-C-sigma: rows sorted by length inside windows of ``sigma`` rows,
  packed into chunks of ``C = 8`` rows — the ``vgatherd`` packing, and on a
  GPU one warp per chunk (8 rows x 4 lanes);
* the SELL sorting window doubles as the load-balancing unit.

All construction happens in numpy on the host and is byte-identical to the
JAX package's; ``.to_device(device)`` returns a dict of torch tensors, and
``.device(device="cuda")`` the dict the port's tiers and kernels read (the
JAX package's ``.device()`` keys, and what the port adds to them).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .device import resolve

Array = np.ndarray

__all__ = [
    "CSRMatrix",
    "BCSRMatrix",
    "SELLMatrix",
    "csr_from_dense",
    "csr_from_coo",
    "bcsr_from_csr",
    "sell_from_csr",
    "csr_to_dense",
    "bcsr_to_dense",
    "sell_to_dense",
    "nnz_row_ids",
]


def _tensors(arrays: dict[str, Array], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def nnz_row_ids(indptr: "Array", dtype=np.int32) -> "Array":
    """Per-nonzero row ids from a CSR indptr (host numpy, O(nnz)).

    The one shared derivation behind the column-slab splits of
    kernels.ops.
    """
    indptr = np.asarray(indptr)
    return np.repeat(
        np.arange(indptr.shape[0] - 1, dtype=dtype), np.diff(indptr)
    )


# ---------------------------------------------------------------------------
# CSR (the paper's CRS) — reference format
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row; mirrors the paper's CRS arrays.

    ``indptr``  == paper's ``rptrs`` (m+1, int32)
    ``indices`` == paper's ``cids``  (nnz, int32)
    ``data``    == paper's ``val``   (nnz, dtype)
    """

    shape: Tuple[int, int]
    indptr: Array
    indices: Array
    data: Array

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz_per_row(self) -> Array:
        return np.diff(self.indptr)

    def to_device(self, device) -> dict[str, torch.Tensor]:
        return _tensors(
            {"indptr": self.indptr, "indices": self.indices, "data": self.data},
            device,
        )

    def device(self, device="cuda") -> dict[str, torch.Tensor]:
        """``indptr``, ``indices`` and ``data`` on ``device``, and the int64
        row ``offsets`` that ``core.spmv.spmv_csr`` sums over
        (``core.spmv.csr_prepare``).

        The JAX package's ``device()`` takes no argument, since JAX puts
        arrays on its default device.  The port's names the device, as
        every entry point of the port does: ``"cuda"`` by default, raising
        without a card, ``"cpu"`` for the plain versions on the host."""
        from .spmv import csr_prepare

        return csr_prepare(self, resolve(device))

    def validate(self) -> None:
        m, n = self.shape
        assert self.indptr.shape == (m + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0), "indptr must be monotone"
        if self.nnz:
            assert self.indices.min() >= 0 and self.indices.max() < n
        assert self.data.shape == (self.nnz,)

    def permuted(self, row_perm: Array, col_perm: Array | None = None) -> "CSRMatrix":
        """P A Q^T: row ``i`` of the result is row ``row_perm[i]`` of A, and
        column ``j`` is column ``col_perm[j]`` (both new -> old; ``col_perm``
        defaults to ``row_perm``).  Each row's columns come out ascending,
        ties in stored order — the JAX package's result, without its loop
        over rows."""
        m, n = self.shape
        row_perm = np.asarray(row_perm, dtype=np.int64)
        col_perm = row_perm if col_perm is None else np.asarray(col_perm, np.int64)
        inv_col = np.empty(n, dtype=np.int64)
        inv_col[col_perm] = np.arange(n)
        lengths = np.diff(self.indptr)[row_perm]
        new_indptr = np.zeros(m + 1, dtype=self.indptr.dtype)
        np.cumsum(lengths, out=new_indptr[1:])
        # Source position of every entry of the result, row by row.
        new_row = np.repeat(np.arange(m, dtype=np.int64), lengths)
        first = np.asarray(self.indptr, dtype=np.int64)[row_perm]
        src = first[new_row] + (
            np.arange(new_row.size, dtype=np.int64)
            - np.asarray(new_indptr[:-1], dtype=np.int64)[new_row]
        )
        cols = inv_col[self.indices[src]]
        order = np.lexsort((cols, new_row))  # stable: ties keep stored order
        return CSRMatrix(
            (m, n), new_indptr, cols[order].astype(self.indices.dtype),
            self.data[src[order]],
        )


def csr_from_dense(dense: Array, dtype=np.float32, index_dtype=np.int32) -> CSRMatrix:
    dense = np.asarray(dense)
    m, n = dense.shape
    rows, cols = np.nonzero(dense)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(m + 1, dtype=index_dtype)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(index_dtype)
    return CSRMatrix(
        (m, n), indptr, cols.astype(index_dtype), dense[rows, cols].astype(dtype)
    )


def csr_from_coo(
    shape: Tuple[int, int],
    rows: Array,
    cols: Array,
    vals: Array | None = None,
    dtype=np.float32,
    index_dtype=np.int32,
    sum_duplicates: bool = True,
) -> CSRMatrix:
    m, n = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if vals is None:
        vals = np.ones(rows.shape[0], dtype=dtype)
    vals = np.asarray(vals, dtype=dtype)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key = rows * n + cols
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(summed, inv, vals.astype(np.float64))
        rows, cols = uniq // n, uniq % n
        vals = summed.astype(dtype)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(
        (m, n),
        indptr.astype(index_dtype),
        cols.astype(index_dtype),
        vals.astype(dtype),
    )


def csr_to_dense(a: CSRMatrix) -> Array:
    m, n = a.shape
    out = np.zeros((m, n), dtype=a.data.dtype)
    for r in range(m):
        s, e = a.indptr[r], a.indptr[r + 1]
        out[r, a.indices[s:e]] = a.data[s:e]
    return out


# ---------------------------------------------------------------------------
# BCSR — the paper's register blocking (Table 2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class BCSRMatrix:
    """Block CSR with dense (bm, bk) blocks.

    Fill-in zeros are stored explicitly, like the paper — the fill *ratio*
    economics (Table 2's >=70% break-even) are computed by core.metrics.
    Blocks are stored sorted by (block_row, block_col); ``block_rows`` is the
    per-stored-block row index and ``indptr`` the per-block-row pointer the
    CUDA kernel walks (one thread block per block row).
    """

    shape: Tuple[int, int]  # logical (unpadded) shape
    block_shape: Tuple[int, int]
    indptr: Array  # (n_block_rows + 1,)
    block_cols: Array  # (n_blocks,)
    block_rows: Array  # (n_blocks,) — row id per stored block
    blocks: Array  # (n_blocks, bm, bk) dense, fill-in zeros included

    @property
    def n_blocks(self) -> int:
        return int(self.block_cols.shape[0])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        bm, bk = self.block_shape
        m, n = self.shape
        return (-(-m // bm) * bm, -(-n // bk) * bk)

    @property
    def grid_shape(self) -> Tuple[int, int]:
        pm, pn = self.padded_shape
        return (pm // self.block_shape[0], pn // self.block_shape[1])

    @property
    def stored_bytes(self) -> int:
        return int(
            self.blocks.nbytes + self.block_cols.nbytes + self.indptr.nbytes
        )

    def to_device(self, device) -> dict[str, torch.Tensor]:
        return _tensors(
            {
                "indptr": self.indptr,
                "block_cols": self.block_cols,
                "block_rows": self.block_rows,
                "blocks": self.blocks,
            },
            device,
        )

    def device(self, device="cuda") -> dict[str, torch.Tensor]:
        """``kernels.ops.bcsr_prepare``'s dict on ``device``: the JAX
        package's ``indptr``, ``block_cols``, ``block_rows`` and ``blocks``,
        with one explicit zero block at column 0 in each block row that
        stores none (the fill-in both packages' kernel paths give), and the
        static ``grid_shape``, ``block_shape`` and ``shape`` that
        ``kernels.ops.bcsr_spmm`` reads.  The device argument is the
        port's, as in :meth:`CSRMatrix.device`."""
        from repro_torch.kernels.ops import bcsr_prepare

        return bcsr_prepare(self, resolve(device))

    def fill_ratio(self) -> float:
        """nnz / stored values — the paper's block-density metric."""
        nnz = int(np.count_nonzero(self.blocks))
        stored = int(self.blocks.size)
        return nnz / max(stored, 1)


def bcsr_from_csr(a: CSRMatrix, block_shape: Tuple[int, int]) -> BCSRMatrix:
    bm, bk = block_shape
    m, n = a.shape
    gm, gn = -(-m // bm), -(-n // bk)
    # Identify occupied blocks (vectorized scatter — no python-per-nnz loop).
    rows = np.repeat(np.arange(m), np.diff(a.indptr))
    brows = (rows // bm).astype(np.int64)
    bcols = (a.indices // bk).astype(np.int64)
    key = brows * gn + bcols
    uniq, inv = np.unique(key, return_inverse=True)
    block_rows = (uniq // gn).astype(np.int32)
    block_cols = (uniq % gn).astype(np.int32)
    blocks = np.zeros((uniq.shape[0], bm, bk), dtype=a.data.dtype)
    flat = inv * (bm * bk) + (rows % bm) * bk + (a.indices % bk)
    blocks.reshape(-1)[flat] = a.data
    indptr = np.zeros(gm + 1, dtype=np.int32)
    np.add.at(indptr, block_rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return BCSRMatrix((m, n), (bm, bk), indptr, block_cols, block_rows, blocks)


def bcsr_to_dense(a: BCSRMatrix) -> Array:
    pm, pn = a.padded_shape
    bm, bk = a.block_shape
    out = np.zeros((pm, pn), dtype=a.blocks.dtype)
    for t in range(a.n_blocks):
        r, c = int(a.block_rows[t]), int(a.block_cols[t])
        out[r * bm : (r + 1) * bm, c * bk : (c + 1) * bk] = a.blocks[t]
    return out[: a.shape[0], : a.shape[1]]


# ---------------------------------------------------------------------------
# SELL-C-sigma — the vgatherd-friendly packing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SELLMatrix:
    """Sliced ELLPACK with sorting window sigma and chunk height C.

    Rows are sorted by descending nnz within windows of ``sigma`` rows, then
    packed into chunks of ``C`` consecutive (sorted) rows.  Every chunk is
    padded to its own max row length, and all chunks are then padded to the
    global max chunk width so the device arrays are rectangular:

      cols  (n_chunks, C, W) int32   gather offsets into x (padding -> 0)
      vals  (n_chunks, C, W) dtype   values (padding -> 0.0)
      row_perm (n_chunks * C,)       sorted-row -> original-row map
      chunk_width (n_chunks,)        true width per chunk (for traffic models)

    C = 8 matches the paper's SIMD height (8 f64 lanes) and, on the card,
    one warp per chunk (8 rows x 4 lanes); W is rounded up to a multiple of
    ``width_align``.
    """

    shape: Tuple[int, int]
    C: int
    sigma: int
    cols: Array
    vals: Array
    row_perm: Array
    chunk_width: Array

    @property
    def n_chunks(self) -> int:
        return int(self.cols.shape[0])

    @property
    def padded_rows(self) -> int:
        return self.n_chunks * self.C

    @property
    def stored_bytes(self) -> int:
        return int(self.cols.nbytes + self.vals.nbytes)

    def to_device(self, device) -> dict[str, torch.Tensor]:
        return _tensors(
            {"cols": self.cols, "vals": self.vals, "row_perm": self.row_perm},
            device,
        )

    def device(self, device="cuda") -> dict[str, torch.Tensor]:
        """``kernels.ops.sell_prepare``'s dict on ``device``: the JAX
        package's ``cols``, ``vals`` and ``row_perm``, the chunk count padded
        with empty chunks (``row_perm`` -1) to a multiple of ``chunk_tile``
        (8), ``cols`` and ``vals`` held as the logical (n_chunks, C, W)
        views of slot-major (n_chunks, W, C) storage, because the SELL
        kernel refuses a row-major operand; beside them ``chunk_w``, each
        chunk's width, and the static ``shape`` and ``chunk_tile``.  The
        device argument is the port's, as in :meth:`CSRMatrix.device`."""
        from repro_torch.kernels.ops import sell_prepare

        return sell_prepare(self, device=resolve(device))


def sell_from_csr(
    a: CSRMatrix, C: int = 8, sigma: int = 64, width_align: int = 1
) -> SELLMatrix:
    m, n = a.shape
    lengths = np.diff(a.indptr)
    # Sort rows by descending length within windows of sigma rows.
    perm = np.arange(m)
    for s in range(0, m, sigma):
        e = min(s + sigma, m)
        window = perm[s:e]
        order = np.argsort(-lengths[window], kind="stable")
        perm[s:e] = window[order]
    n_chunks = -(-m // C)
    padded_rows = n_chunks * C
    sorted_len = np.zeros(padded_rows, dtype=np.int64)
    sorted_len[:m] = lengths[perm]
    chunk_width = sorted_len.reshape(n_chunks, C).max(axis=1)
    W = int(max(chunk_width.max(initial=1), 1))
    if width_align > 1:
        W = -(-W // width_align) * width_align
    cols = np.zeros((n_chunks, C, W), dtype=np.int32)
    vals = np.zeros((n_chunks, C, W), dtype=a.data.dtype)
    # Vectorized packing: nnz t of original row r lands at sorted row
    # inv_perm[r], slot (t - indptr[r]).
    inv_perm = np.empty(m, dtype=np.int64)
    inv_perm[perm] = np.arange(m)
    rows_of_nnz = np.repeat(np.arange(m), lengths)
    sorted_row = inv_perm[rows_of_nnz]
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], lengths)
    cols[sorted_row // C, sorted_row % C, slot] = a.indices
    vals[sorted_row // C, sorted_row % C, slot] = a.data
    row_perm = np.full(padded_rows, -1, dtype=np.int32)
    row_perm[:m] = perm
    return SELLMatrix(
        (m, n), C, sigma, cols, vals, row_perm, chunk_width.astype(np.int32)
    )


def sell_to_dense(a: SELLMatrix) -> Array:
    m, n = a.shape
    out = np.zeros((m, n), dtype=a.vals.dtype)
    for i in range(a.padded_rows):
        orig = int(a.row_perm[i])
        if orig < 0:
            continue
        chunk, lane = i // a.C, i % a.C
        # Padding entries have val == 0; adding them to column 0 is harmless
        # only if no real nonzero shares the slot, so accumulate instead.
        np.add.at(out[orig], a.cols[chunk, lane], a.vals[chunk, lane])
    return out

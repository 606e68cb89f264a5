"""SpMV / SpMM plain torch tiers: the search's references and the oracles.

* ``spmv_csr``/``spmm_csr`` — the paper's "-O3" tier: a gather on x, then a
  per-row sum.  The row sum is ``torch.segment_reduce`` over the CSR
  offsets (made int64 once, by :func:`csr_prepare`): a fixed-order
  reduction per row, so repeated calls are bitwise-identical on the card
  (``index_add_`` on CUDA uses float atomics and is not), which the
  serving engine's async == sync guarantee needs.
* ``spmv_sell``/``spmm_sell`` — SELL-C-sigma chunk-local gathers, one sum
  over the slot axis, then the un-permute by ``row_perm`` (a permutation of
  the valid rows, so no accumulation is needed).
* ``spmm_bcsr_dense`` — one dense (bm, bk) x (bk, k) product per stored
  block, summed per block row.  On the card the product runs in cuBLAS;
  float32 stays float32 unless the caller enabled TF32 globally.
* ``spmv_csr_scalar`` — the paper's "-O1" tier: every row adds its terms
  one at a time, in stored order, from 0.  The reference runs one loop
  step per nonzero; here one step per *slot*: step j adds term j of every
  row longer than j, so the step count is the longest row, not nnz.
* ``symmetrize``/``spd_shift`` — host constructors of the solver
  workloads: (A + A^T)/2, and a diagonally dominant SPD shift of it.

The hand-written CUDA kernels live in :mod:`repro_torch.kernels`; these
tiers share no code with them.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "csr_prepare",
    "csr_scalar_prepare",
    "csr_bind",
    "spmv_csr",
    "spmm_csr",
    "spmv_csr_scalar",
    "symmetrize",
    "spd_shift",
    "spmv_sell",
    "spmm_sell",
    "spmm_bcsr_dense",
    "unpermute",
]


# ---------------------------------------------------------------------------
# CSR — gather + per-row sum ("-O3" tier)
# ---------------------------------------------------------------------------
def csr_prepare(a, device) -> dict[str, Any]:
    """Device CSR dict plus the int64 row offsets the row sum reads."""
    dev = a.to_device(device)
    dev["offsets"] = dev["indptr"].to(torch.int64)
    return dev


def _row_sum(prod: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(
        prod, "sum", offsets=offsets, axis=0, unsafe=True
    )


def spmv_csr(csr: dict[str, Any], x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """y = A @ x with A in CSR. 2 flops/nnz, gather on x (vgatherd analogue)."""
    del n_rows  # the offsets fix the row count
    return _row_sum(csr["data"] * x[csr["indices"]], csr["offsets"])


def spmm_csr(csr: dict[str, Any], x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Y = A @ X, X (n, k) — the paper's §5 SpMM with k simultaneous vectors."""
    del n_rows
    return _row_sum(csr["data"][:, None] * x[csr["indices"], :], csr["offsets"])


def csr_bind(dev: dict[str, Any], *, n_rows: int, k: int = 1) -> Callable:
    """Close a prepared CSR dict over → ``fn(x)``; ``k=1`` binds SpMV
    (x is ``(n,)``), ``k>1`` SpMM (x is ``(n, k)``)."""
    fn = spmv_csr if k == 1 else spmm_csr
    return lambda x: fn(dev, x, n_rows=n_rows)


# ---------------------------------------------------------------------------
# CSR scalar — one term per row per step ("-O1" tier)
# ---------------------------------------------------------------------------
def csr_scalar_prepare(a, device) -> dict[str, Any]:
    """:func:`csr_prepare` plus the slot schedule of :func:`spmv_csr_scalar`:
    rows sorted by descending length (stable), their first nonzero, and per
    slot j the number of rows longer than j (a host list)."""
    dev = csr_prepare(a, device)
    indptr = np.asarray(a.indptr, dtype=np.int64)
    lengths = np.diff(indptr)
    order = np.argsort(-lengths, kind="stable")
    neg_sorted = -lengths[order]  # ascending
    max_len = int(-neg_sorted[0]) if lengths.size else 0
    active = np.searchsorted(neg_sorted, -np.arange(max_len), side="left")
    dev["order"] = torch.as_tensor(order, device=device)
    dev["start_sorted"] = torch.as_tensor(indptr[:-1][order], device=device)
    dev["active"] = [int(c) for c in active]
    return dev


def spmv_csr_scalar(csr: dict[str, Any], x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """y = A @ x one term at a time per row, from 0, in stored order — the
    same additions, in the same order, as the reference's loop over
    nonzeros.  ``csr`` comes from :func:`csr_scalar_prepare`."""
    order, start = csr["order"], csr["start_sorted"]
    indices, data = csr["indices"], csr["data"]
    acc = torch.zeros(n_rows, dtype=x.dtype, device=x.device)  # sorted rows
    for j, c in enumerate(csr["active"]):
        t = start[:c] + j
        acc[:c] += data[t] * x[indices[t]]
    y = torch.empty_like(acc)
    y[order] = acc
    return y


# ---------------------------------------------------------------------------
# SELL-C-sigma — vectorized reference (kernel lives in kernels/sell_spmv)
# ---------------------------------------------------------------------------
def unpermute(sums: torch.Tensor, row_perm: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Scatter sorted-row sums to original rows; ``row_perm`` -1 = padding.

    ``row_perm`` is a permutation of the valid rows, so each row receives
    exactly one sum and the scatter is a plain store.  Padding sums land
    in one extra row that is dropped: no size depends on the data, so the
    host never waits for the device and the tier can be captured in a CUDA
    graph."""
    dest = torch.where(row_perm >= 0, row_perm, n_rows).long()
    y = torch.zeros((n_rows + 1,) + sums.shape[1:], dtype=sums.dtype, device=sums.device)
    y[dest] = sums
    return y[:n_rows]


def spmv_sell(sell: dict[str, Any], x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """y = A @ x with A in SELL-C-sigma (gathers are chunk-local and dense)."""
    cols, vals = sell["cols"], sell["vals"]
    sums = (vals * x[cols.long()]).sum(dim=-1).reshape(-1)  # (n_chunks*C,)
    return unpermute(sums, sell["row_perm"], n_rows)


def spmm_sell(sell: dict[str, Any], x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Y = A @ X with A in SELL-C-sigma and a stacked RHS X (n, k)."""
    cols, vals = sell["cols"], sell["vals"]
    k = x.shape[-1]
    # (..., W) slots gather (..., W, k) rows of X; reduce the W axis.
    sums = (vals[..., None] * x[cols.long()]).sum(dim=-2).reshape(-1, k)
    return unpermute(sums, sell["row_perm"], n_rows)


# ---------------------------------------------------------------------------
# BCSR — dense-block reference (kernel lives in kernels/bcsr_spmm)
# ---------------------------------------------------------------------------
def spmm_bcsr_dense(
    bcsr: dict[str, Any], x_blocked: torch.Tensor, *, n_block_rows: int
) -> torch.Tensor:
    """Y = A @ X with A in BCSR and X pre-blocked to (n_col_blocks, bk, k).

    Returns (n_block_rows, bm, k): one (bm,bk)x(bk,k) product per stored
    block, summed per block row over the row-sorted block stream (the
    prepared ``indptr`` holds the n_block_rows + 1 block-row offsets).
    """
    if bcsr["indptr"].shape[0] != n_block_rows + 1:
        raise ValueError(
            f"indptr has {bcsr['indptr'].shape[0]} entries for "
            f"{n_block_rows} block rows"
        )
    gathered = x_blocked[bcsr["block_cols"].long()]  # (n_blocks, bk, k)
    prods = torch.bmm(bcsr["blocks"].to(gathered.dtype), gathered)
    return _row_sum(prods, bcsr["indptr"].to(torch.int64))


# ---------------------------------------------------------------------------
# Solver workloads (host construction)
# ---------------------------------------------------------------------------
def symmetrize(a):
    """(A + A^T) / 2 as a new CSRMatrix (host construction, duplicate-summed)."""
    from .formats import csr_from_coo

    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    r = np.concatenate([rows, a.indices])
    c = np.concatenate([a.indices, rows])
    v = np.concatenate([a.data, a.data]) * 0.5
    return csr_from_coo(a.shape, r, c, v)


def spd_shift(a, margin: float = 1.0):
    """A symmetric positive-definite operator with ``a``'s pattern:
    symmetrize, then add ``(max off-diagonal |row sum| + margin) * I`` —
    strictly diagonally dominant with a positive diagonal, hence SPD
    (Gershgorin)."""
    from .formats import csr_from_coo

    s = symmetrize(a)
    rows = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
    off = rows != s.indices
    row_abs = np.zeros(s.shape[0], s.data.dtype)
    np.add.at(row_abs, rows[off], np.abs(s.data[off]))
    shift = np.float32(row_abs.max(initial=0.0) + margin)
    r = np.concatenate([rows, np.arange(s.shape[0])])
    c = np.concatenate([s.indices, np.arange(s.shape[0])])
    v = np.concatenate(
        [np.where(off, s.data, np.abs(s.data)), np.full(s.shape[0], shift, s.data.dtype)]
    )
    return csr_from_coo(s.shape, r, c, v)

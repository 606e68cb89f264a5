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

The hand-written CUDA kernels live in :mod:`repro_torch.kernels`; these
tiers share no code with them.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "csr_prepare",
    "csr_bind",
    "spmv_csr",
    "spmm_csr",
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
# SELL-C-sigma — vectorized reference (kernel lives in kernels/sell_spmv)
# ---------------------------------------------------------------------------
def unpermute(sums: torch.Tensor, row_perm: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Scatter sorted-row sums to original rows; ``row_perm`` -1 = padding.

    ``row_perm`` is a permutation of the valid rows, so each row receives
    exactly one sum and the scatter is a plain store."""
    valid = row_perm >= 0
    y = torch.zeros((n_rows,) + sums.shape[1:], dtype=sums.dtype, device=sums.device)
    y[row_perm[valid].long()] = sums[valid]
    return y


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

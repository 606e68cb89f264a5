"""The plain reference of y = A @ x for a CSR matrix, and the comparison
that decides ``correct``.

Plain torch, on whatever device the operands are on, from the CSR arrays
and the x vectors the harness made.  It imports nothing of the program
and takes nothing the program prepared: no format, plan or result of it
but the y under judgement.

The configurations state float32.  Each row's answer is judged against a
float64 product, relative to the row's own magnitude (|A| |x|)_i:

    err = max over rows and requests of |y_i - y64_i| / (|A| |x|)_i.

A float32 sum of a row's k_i products in any order is within about
k_i * 2**-24 of it, and the rows here hold at most 49 values.  The control
is this reference computed one precision lower (A and x rounded to
bfloat16, products summed in float32), the step a faster path would be
tempted to take: on the card it reads some sixty times the limit (PERF.md).
"""
from __future__ import annotations

import torch

# Set from the program's readings and the control's (PERF.md, section 2).
MAX_REL_ERR = 1e-4

_BLOCK_ELEMS = 1 << 28  # products held at once: 2 GiB in float64


def _row_ids(indptr: torch.Tensor) -> torch.Tensor:
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=indptr.device), counts)


def _columns(nnz: int, s: int) -> int:
    return max(1, min(s, _BLOCK_ELEMS // max(nnz, 1)))


def product(indptr: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
            X: torch.Tensor, dtype=torch.float64, acc=torch.float64
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(A @ X, |A| @ |X|)`` for X of shape (n, s), each (m, s) in
    ``acc``: A and X rounded to ``dtype`` first, products formed and summed
    in ``acc``; in blocks of columns so that the products fit."""
    m = indptr.numel() - 1
    rows = _row_ids(indptr)
    cols = indices.long()
    a = values.to(dtype).to(acc)[:, None]
    Y = torch.zeros((m, X.shape[1]), dtype=acc, device=X.device)
    AX = torch.zeros_like(Y)
    step = _columns(indices.numel(), X.shape[1])
    for j in range(0, X.shape[1], step):
        p = a * X[cols, j:j + step].to(dtype).to(acc)
        Y[:, j:j + step].index_add_(0, rows, p)
        AX[:, j:j + step].index_add_(0, rows, p.abs_())
        del p
    return Y, AX


def reference(indptr, indices, values, X) -> tuple[torch.Tensor, torch.Tensor]:
    """The float64 product and the rows' magnitudes."""
    return product(indptr, indices, values, X)


def control(indptr, indices, values, X) -> torch.Tensor:
    """The reference one precision below float32: bfloat16 operands,
    float32 sums."""
    return product(indptr, indices, values, X, dtype=torch.bfloat16,
                   acc=torch.float32)[0]


def rel_err(Y: torch.Tensor, Y64: torch.Tensor, AX: torch.Tensor) -> float:
    """Worst |y - y64| / (|A| |x|) over every row of every column; a NaN
    or an infinity reads as infinity, and a wrong value in a row whose
    magnitude is zero reads as huge."""
    err = (Y.to(torch.float64) - Y64).abs_() / AX.clamp(min=torch.finfo(torch.float64).tiny)
    err = torch.nan_to_num(err, nan=float("inf"))
    return float(err.max()) if err.numel() else 0.0

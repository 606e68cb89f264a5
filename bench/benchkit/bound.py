"""The yardstick's peaks and the format-free bound of one dispatched batch.

A batch of ``b`` real requests against an m x n matrix with ``nnz`` stored
values needs at least each value of A read once, each x read once and
each y written once, all float32:

    bytes = 4 * nnz + 4 * (n + m) * b,   flops = 2 * nnz * b,
    bound = max(bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S).

Indices, padding columns and whatever a format stores beyond the values
are not counted, so no plan or kernel can take less time than the bound
and a share of it stays at or under 100 %.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, and float32 on
# the CUDA cores (the sparse tiers do not use the tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def batch_bytes(nnz: int, m: int, n: int, b: int) -> int:
    return 4 * int(nnz) + 4 * (int(n) + int(m)) * int(b)


def batch_flops(nnz: int, b: int) -> int:
    return 2 * int(nnz) * int(b)


def batch_bound_s(nnz: int, m: int, n: int, b: int) -> float:
    """Least seconds one batch of ``b`` real requests can take on the card."""
    return max(batch_bytes(nnz, m, n, b) / HBM_BYTES_PER_S,
               batch_flops(nnz, b) / FP32_FLOPS_PER_S)

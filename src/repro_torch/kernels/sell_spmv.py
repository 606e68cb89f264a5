"""SELL-C-sigma SpMV: the two CUDA kernels and their plain torch versions.

* :func:`sell_spmv` (``csrc/sell_spmv.cu``) replaces the TPU kernel
  ``repro.kernels.sell_spmv.sell_spmv_pallas``;
* :func:`sell_spmv_blocked` (``csrc/sell_spmv_blocked.cu``) replaces
  ``repro.kernels.sell_spmv.sell_spmv_blocked_pallas``.

The TPU kernels return per-sorted-row sums and leave the un-permute by
``row_perm`` to their caller; here the kernels fuse it (``row_perm`` is a
permutation of the valid rows, so the store needs no atomics), and both
wrappers take ``row_perm`` and return y in original row order.

A wrapper runs the plain version only because its operand lies on the CPU;
for a CUDA tensor it launches its kernel or raises.  The source notes in
``csrc/`` say what bounds each kernel and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spmv import spmv_sell, unpermute

from . import _build

__all__ = [
    "MAX_SMEM_BYTES",
    "sell_spmv",
    "sell_spmv_plain",
    "sell_spmv_blocked",
    "sell_spmv_blocked_plain",
    "stages_x_in_smem",
]

# Dynamic shared memory one block may use on an H100 (227 KB): the blocked
# kernel stages an x slab there, beside the running sums of at least one
# chunk of 8 rows per warp of its 1024-thread block, when both fit; it
# gathers x from global memory otherwise.
MAX_SMEM_BYTES = 232_448
_STAGED_SUMS_BYTES = 32 * 8 * 4

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# SELL, x resident
# ---------------------------------------------------------------------------
def sell_spmv_plain(cols, vals, x, row_perm, n_rows: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: chunk-local gathers, one sum
    over the slot axis, then the un-permute."""
    return spmv_sell({"cols": cols, "vals": vals, "row_perm": row_perm}, x,
                     n_rows=n_rows)


def sell_spmv(
    cols: torch.Tensor,  # (n_chunks, 8, W) int32
    vals: torch.Tensor,  # (n_chunks, 8, W) float32
    x: torch.Tensor,  # (n,) float32
    row_perm: torch.Tensor,  # (n_chunks * 8,) int32, -1 = padding
    *,
    n_rows: int,
    chunk_tile: int = 8,
) -> torch.Tensor:
    """y = A @ x for A in SELL-C-sigma (C = 8); returns (n_rows,)."""
    if x.device.type == "cpu":
        return sell_spmv_plain(cols, vals, x, row_perm, n_rows)
    dev = x.device
    _build.expect(cols, "cols", torch.int32, dev, 3)
    _build.expect(vals, "vals", torch.float32, dev, 3)
    _build.expect(x, "x", torch.float32, dev, 1)
    _build.expect(row_perm, "row_perm", torch.int32, dev, 1)
    n_chunks, C, W = cols.shape
    if C != 8 or vals.shape != cols.shape or row_perm.shape[0] != n_chunks * C:
        raise ValueError(
            f"SELL shapes cols {tuple(cols.shape)} vals {tuple(vals.shape)} "
            f"row_perm {tuple(row_perm.shape)}: need C = 8 and matching shapes"
        )
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return y.zero_()
    fn = _build.function(
        "sell_spmv", "sell_spmv_launch", [_P, _P, _P, _P, _P, _LL, _I, _I, _P]
    )
    with torch.cuda.device(dev):
        code = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                  row_perm.data_ptr(), y.data_ptr(), n_chunks, W,
                  int(chunk_tile), _build.stream(dev))
    _build.check("sell_spmv", code, "sell_spmv launch")
    _build.LAUNCHES["sell_spmv"] += 1
    return y


# ---------------------------------------------------------------------------
# Column-slab SELL over one shared row permutation
# ---------------------------------------------------------------------------
def stages_x_in_smem(slab_n: int) -> bool:
    """Whether the blocked kernel stages each x slab in shared memory."""
    return int(slab_n) * 4 + _STAGED_SUMS_BYTES <= MAX_SMEM_BYTES


def sell_spmv_blocked_plain(cols, vals, x, row_perm, n_rows: int,
                            slab_n: int) -> torch.Tensor:
    """Per-slab chunk-local gathers summed in slab order 0, 1, ..., then
    the un-permute — the kernel's arithmetic in plain torch."""
    n_slabs, n_chunks, C, _ = cols.shape
    sums = torch.zeros(n_chunks * C, dtype=x.dtype, device=x.device)
    for s in range(n_slabs):
        xs = x[s * slab_n : (s + 1) * slab_n]
        sums = sums + (vals[s] * xs[cols[s].long()]).sum(dim=-1).reshape(-1)
    return unpermute(sums, row_perm, n_rows)


def sell_spmv_blocked(
    cols: torch.Tensor,  # (n_slabs, n_chunks, 8, W) int32, slab-local columns
    vals: torch.Tensor,  # (n_slabs, n_chunks, 8, W) float32
    x: torch.Tensor,  # (n_slabs * slab_n,) float32, zero-padded
    row_perm: torch.Tensor,  # (n_chunks * 8,) int32, -1 = padding
    *,
    n_rows: int,
    slab_n: int,
) -> torch.Tensor:
    """y = A @ x over column slabs sharing one row permutation."""
    n_slabs, n_chunks, C, W = cols.shape
    if x.shape[0] != n_slabs * slab_n:
        raise ValueError(
            f"x has {x.shape[0]} entries, expected n_slabs * slab_n = "
            f"{n_slabs * slab_n}"
        )
    if x.device.type == "cpu":
        return sell_spmv_blocked_plain(cols, vals, x, row_perm, n_rows, slab_n)
    dev = x.device
    _build.expect(cols, "cols", torch.int32, dev, 4)
    _build.expect(vals, "vals", torch.float32, dev, 4)
    _build.expect(x, "x", torch.float32, dev, 1)
    _build.expect(row_perm, "row_perm", torch.int32, dev, 1)
    if C != 8 or vals.shape != cols.shape or row_perm.shape[0] != n_chunks * C:
        raise ValueError(
            f"blocked SELL shapes cols {tuple(cols.shape)} vals "
            f"{tuple(vals.shape)} row_perm {tuple(row_perm.shape)}"
        )
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_chunks == 0 or n_slabs == 0:
        return y.zero_()
    stage = stages_x_in_smem(slab_n)
    fn = _build.function(
        "sell_spmv_blocked", "sell_spmv_blocked_launch",
        [_P, _P, _P, _P, _P, _I, _LL, _I, _LL, _I, _P],
    )
    with torch.cuda.device(dev):
        code = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                  row_perm.data_ptr(), y.data_ptr(),
                  n_slabs, n_chunks, W, int(slab_n), int(stage), _build.stream(dev))
    _build.check("sell_spmv_blocked", code, "sell_spmv_blocked launch")
    _build.LAUNCHES["sell_spmv_blocked"] += 1
    _build.LAUNCHES["sell_spmv_blocked.smem" if stage else "sell_spmv_blocked.global"] += 1
    return y

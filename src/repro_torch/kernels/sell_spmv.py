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
for a CUDA tensor it launches its kernel or raises.  Under grad, with an
operand that requires grad, it raises on either device
(``_build.refuse_autograd``): no kernel has a backward.  The source notes in
``csrc/`` say what bounds each kernel and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spmv import spmv_sell, unpermute

from . import _build

__all__ = [
    "sell_spmv",
    "sell_spmv_plain",
    "sell_spmv_blocked",
    "sell_spmv_blocked_plain",
]

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
    cols: torch.Tensor,  # (n_chunks, 8, W) int32, the slot-major view
    vals: torch.Tensor,  # (n_chunks, 8, W) float32, the slot-major view
    x: torch.Tensor,  # (n,) float32
    row_perm: torch.Tensor,  # (n_chunks * 8,) int32, -1 = padding
    *,
    n_rows: int,
    chunk_w: torch.Tensor,  # (n_chunks,) int32
    chunk_tile: int = 8,
) -> torch.Tensor:
    """y = A @ x for A in SELL-C-sigma (C = 8); returns (n_rows,).

    ``cols`` and ``vals`` are the views :func:`~repro_torch.kernels.ops.
    sell_prepare` makes: (n_chunks, 8, W) over slot-major storage, (n_chunks,
    W, 8) in memory.  A row-major tensor is refused, not copied.  The kernel
    reads each chunk's slots w < ``chunk_w[chunk]`` (clamped to [0, W]);
    past its width a chunk holds padding (column 0, value 0.0), which the
    plain version adds and the kernel skips: the two differ only where x at
    column 0 is inf or NaN."""
    for t, name in ((cols, "cols"), (vals, "vals")):
        if t.dim() != 3 or not t.transpose(1, 2).is_contiguous():
            raise ValueError(
                f"{name} of shape {tuple(t.shape)} and strides {t.stride()} is "
                "not the slot-major SELL view: pass the dict of "
                "ops.sell_prepare (or ops.from_arrays), whose cols/vals are "
                "(n_chunks, W, 8) in memory seen as (n_chunks, 8, W); a "
                "row-major tensor is not copied here"
            )
    n_chunks, C, W = cols.shape
    if (C != 8 or vals.shape != cols.shape or row_perm.shape[0] != n_chunks * C
            or tuple(chunk_w.shape) != (n_chunks,)):
        raise ValueError(
            f"SELL shapes cols {tuple(cols.shape)} vals {tuple(vals.shape)} "
            f"row_perm {tuple(row_perm.shape)} chunk_w {tuple(chunk_w.shape)}: "
            "need C = 8, matching shapes and one width per chunk"
        )
    _build.refuse_autograd("sell_spmv", vals, x)
    if x.device.type == "cpu":
        return sell_spmv_plain(cols, vals, x, row_perm, n_rows)
    dev = x.device
    _build.expect(cols.transpose(1, 2), "cols", torch.int32, dev, 3)
    _build.expect(vals.transpose(1, 2), "vals", torch.float32, dev, 3)
    _build.expect(chunk_w, "chunk_w", torch.int32, dev, 1)
    _build.expect(x, "x", torch.float32, dev, 1)
    _build.expect(row_perm, "row_perm", torch.int32, dev, 1)
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_chunks == 0:
        return y.zero_()
    fn = _build.function(
        "sell_spmv", "sell_spmv_launch", [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P]
    )
    with torch.cuda.device(dev):
        code = fn(cols.data_ptr(), vals.data_ptr(), chunk_w.data_ptr(),
                  x.data_ptr(), row_perm.data_ptr(), y.data_ptr(), n_chunks, W,
                  int(chunk_tile), _build.stream(dev))
    _build.check("sell_spmv", code, "sell_spmv launch")
    _build.count("sell_spmv")
    return y


# ---------------------------------------------------------------------------
# Column-slab SELL over one shared row permutation
# ---------------------------------------------------------------------------
def sell_spmv_blocked_plain(cols, vals, x, row_perm, n_rows: int, slab_n: int,
                            chunk_w) -> torch.Tensor:
    """Per-slab chunk-local gathers summed in slab order 0, 1, ..., then
    the un-permute — the kernel's arithmetic in plain torch.

    Like the kernel, a chunk of slab s reads only its slots w <
    ``chunk_w[s, chunk]``, the width rounded up to a multiple of 4 and
    clamped to [0, W] (the prepare gives such widths, so this changes none
    of them).  Past that width every slot is padding (column
    0, value 0.0), which adds nothing unless x at the slab's first column
    is inf or NaN.  In that case the padding a row still reads below its
    chunk's width already turns the row to NaN, as every padded slot did
    before the widths existed: skipping the rest changes no finite answer.
    """
    n_slabs, n_chunks, C, W = cols.shape
    slot = torch.arange(W, device=x.device)
    sums = torch.zeros(n_chunks * C, dtype=x.dtype, device=x.device)
    for s in range(n_slabs):
        xs = x[s * slab_n : (s + 1) * slab_n]
        held = slot < ((chunk_w[s].to(slot.dtype) + 3) // 4 * 4)[:, None, None]
        prod = torch.where(held, vals[s] * xs[cols[s].long()], 0.0)
        sums = sums + prod.sum(dim=-1).reshape(-1)
    return unpermute(sums, row_perm, n_rows)


def sell_spmv_blocked(
    cols: torch.Tensor,  # (n_slabs, n_chunks, 8, W) int32, slab-local columns
    vals: torch.Tensor,  # (n_slabs, n_chunks, 8, W) float32
    x: torch.Tensor,  # (n_slabs * slab_n,) float32, zero-padded
    row_perm: torch.Tensor,  # (n_chunks * 8,) int32, -1 = padding
    *,
    n_rows: int,
    slab_n: int,
    chunk_w: torch.Tensor,  # (n_slabs, n_chunks) int32
) -> torch.Tensor:
    """y = A @ x over column slabs sharing one row permutation, each chunk
    of each slab read up to its own width ``chunk_w``.

    The kernel reads slots w < ``chunk_w[s, chunk]`` with the width
    rounded up to a multiple of 4 and clamped to [0, W], as the plain
    version's mask does, so no width reads past its row; the prepare gives
    multiples of 4.  ``cols`` and ``vals`` are read in 16-byte vectors and
    must start on a 16-byte boundary."""
    n_slabs, n_chunks, C, W = cols.shape
    if x.shape[0] != n_slabs * slab_n:
        raise ValueError(
            f"x has {x.shape[0]} entries, expected n_slabs * slab_n = "
            f"{n_slabs * slab_n}"
        )
    if tuple(chunk_w.shape) != (n_slabs, n_chunks):
        raise ValueError(
            f"chunk_w has shape {tuple(chunk_w.shape)}, expected "
            f"(n_slabs, n_chunks) = {(n_slabs, n_chunks)}"
        )
    _build.refuse_autograd("sell_spmv_blocked", vals, x)
    if x.device.type == "cpu":
        return sell_spmv_blocked_plain(cols, vals, x, row_perm, n_rows, slab_n,
                                       chunk_w)
    dev = x.device
    _build.expect(cols, "cols", torch.int32, dev, 4, align=16)
    _build.expect(vals, "vals", torch.float32, dev, 4, align=16)
    _build.expect(chunk_w, "chunk_w", torch.int32, dev, 2)
    _build.expect(x, "x", torch.float32, dev, 1)
    _build.expect(row_perm, "row_perm", torch.int32, dev, 1)
    if (C != 8 or W % 4 != 0 or vals.shape != cols.shape
            or row_perm.shape[0] != n_chunks * C):
        raise ValueError(
            f"blocked SELL shapes cols {tuple(cols.shape)} vals "
            f"{tuple(vals.shape)} row_perm {tuple(row_perm.shape)}: need C = 8, "
            "W a multiple of 4 and matching shapes"
        )
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_chunks == 0 or n_slabs == 0:
        return y.zero_()
    fn = _build.function(
        "sell_spmv_blocked", "sell_spmv_blocked_launch",
        [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _LL, _P],
    )
    with torch.cuda.device(dev):
        code = fn(cols.data_ptr(), vals.data_ptr(), chunk_w.data_ptr(),
                  x.data_ptr(), row_perm.data_ptr(), y.data_ptr(),
                  n_slabs, n_chunks, W, int(slab_n), _build.stream(dev))
    _build.check("sell_spmv_blocked", code, "sell_spmv_blocked launch")
    _build.count("sell_spmv_blocked")
    return y

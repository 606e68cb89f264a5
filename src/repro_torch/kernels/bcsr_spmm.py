"""BCSR SpMM: the CUDA kernel and its plain torch version.

:func:`bcsr_spmm` (``csrc/bcsr_spmm.cu``) replaces the TPU kernel
``repro.kernels.bcsr_spmm.bcsr_spmm_pallas``.  Where the TPU kernel walks a
row-sorted block stream against a VMEM-resident output strip, the CUDA
kernel walks a block-row pointer (``indptr``, built by ``ops.bcsr_prepare``)
so that each output element has one owning thread.  The TPU kernel's
zero-block padding to ``block_tile`` and its VMEM clamp on the N tile do not
apply here.

A wrapper runs the plain version only because its operand lies on the CPU;
for a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spmv import spmm_bcsr_dense

from . import _build

__all__ = ["bcsr_spmm", "bcsr_spmm_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def bcsr_spmm_plain(blocks, block_cols, indptr, x_blocked) -> torch.Tensor:
    """One dense (bm, bk) x (bk, k) product per stored block, summed per
    block row over ``indptr`` — the kernel's arithmetic in plain torch."""
    return spmm_bcsr_dense(
        {"blocks": blocks, "block_cols": block_cols, "indptr": indptr},
        x_blocked,
        n_block_rows=indptr.shape[0] - 1,
    )


def bcsr_spmm(
    blocks: torch.Tensor,  # (n_blocks, bm, bk) float32, sorted by block row
    block_cols: torch.Tensor,  # (n_blocks,) int32
    indptr: torch.Tensor,  # (n_block_rows + 1,) int32 block-row pointer
    x_blocked: torch.Tensor,  # (n_col_blocks, bk, k) float32
) -> torch.Tensor:
    """Y = A @ X for A in BCSR; returns (n_block_rows, bm, k) float32."""
    if x_blocked.device.type == "cpu":
        return bcsr_spmm_plain(blocks, block_cols, indptr, x_blocked)
    dev = x_blocked.device
    _build.expect(blocks, "blocks", torch.float32, dev, 3)
    _build.expect(block_cols, "block_cols", torch.int32, dev, 1)
    _build.expect(indptr, "indptr", torch.int32, dev, 1)
    _build.expect(x_blocked, "x_blocked", torch.float32, dev, 3)
    n_blocks, bm, bk = blocks.shape
    _, bk2, k = x_blocked.shape
    gm = indptr.shape[0] - 1
    if bk2 != bk or block_cols.shape[0] != n_blocks or gm < 0:
        raise ValueError(
            f"BCSR shapes blocks {tuple(blocks.shape)} block_cols "
            f"{tuple(block_cols.shape)} x_blocked {tuple(x_blocked.shape)}"
        )
    if bm * min(k, 64) > 1024:
        raise ValueError(f"block height {bm} too tall for one thread block")
    y = torch.empty((gm, bm, k), dtype=torch.float32, device=dev)
    if gm == 0 or k == 0:
        return y
    fn = _build.function(
        "bcsr_spmm", "bcsr_spmm_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    )
    with torch.cuda.device(dev):
        code = fn(indptr.data_ptr(), block_cols.data_ptr(), blocks.data_ptr(),
                  x_blocked.data_ptr(), y.data_ptr(), gm, bm, bk, k,
                  _build.stream(dev))
    _build.check("bcsr_spmm", code, "bcsr_spmm launch")
    _build.LAUNCHES["bcsr_spmm"] += 1
    return y

"""BCSR SpMM: the CUDA kernel and its plain torch version.

:func:`bcsr_spmm` (``csrc/bcsr_spmm.cu``) replaces the TPU kernel
``repro.kernels.bcsr_spmm.bcsr_spmm_pallas``.  Where the TPU kernel walks a
row-sorted block stream against a VMEM-resident output strip, the CUDA
kernel walks a block-row pointer (``indptr``, built by ``ops.bcsr_prepare``):
one warp owns a block row's 8-row group and an N tile and keeps its outputs
in registers.  At k = 1 and 4 the warp's lanes split the stored values
instead.  The source note says which path serves which shape; every block
shape and every k is taken.  ``blocks`` and ``x_blocked`` are read in
16-byte vectors, so each must start on a 16-byte boundary (any tensor torch
allocates does; an offset view may not, and is refused).  The TPU kernel's zero-block padding to
``block_tile`` and its VMEM clamp on the N tile do not apply here.

The wrapper dispatches on ``blocks.dtype``.  float32 operands take the
kernels above.  bf16 operands (the sparse FFN's weights and activations)
take kernels of their own in the same source, with float32 sums and a
float32 Y, as the TPU kernel accumulates with ``preferred_element_type``.
Blocks with bm % 16 == 0 and bk % 16 == 0 (the FFN's (128, 128)) run on the
bf16 tensor cores (``bcsr_bf16_mma``: ``mma.sync`` with float32
accumulators); the other shapes on CUDA cores (``bcsr_bf16``).
:func:`bf16_tensor_core_path` is the launcher's rule.  Every bf16 launch
counts under ``bcsr_spmm_bf16``, a tensor-core launch under
``bcsr_spmm_bf16_mma`` as well.  bk must be in {8, 16, 32, 64, 128, 256};
any bm.  Both operands must share the dtype.

A wrapper runs the plain version only because its operand lies on the CPU;
for a CUDA tensor it launches its kernel or raises.  Under grad, with an
operand that requires grad, it raises on either device
(``_build.refuse_autograd``): the kernel has no backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spmv import spmm_bcsr_dense

from . import _build

__all__ = ["bcsr_spmm", "bcsr_spmm_plain", "bf16_tensor_core_path"]

_P, _I = ctypes.c_void_p, ctypes.c_int


BF16_BK = (8, 16, 32, 64, 128, 256)


def bf16_tensor_core_path(bm: int, bk: int) -> bool:
    """Whether bf16 blocks of (bm, bk) take the tensor-core kernel (as the
    C launcher decides, by shape alone); the others take the CUDA-core one."""
    return bm % 16 == 0 and bk % 16 == 0 and bk in BF16_BK


def bcsr_spmm_plain(blocks, block_cols, indptr, x_blocked) -> torch.Tensor:
    """One dense (bm, bk) x (bk, k) product per stored block, summed per
    block row over ``indptr`` — the kernel's arithmetic in plain torch.
    bf16 operands are widened to float32 first (both must be bf16), so the
    products are exact and the sums float32, as in the kernel."""
    if torch.bfloat16 in (blocks.dtype, x_blocked.dtype):
        if blocks.dtype != x_blocked.dtype:
            raise TypeError(f"blocks are {blocks.dtype} but x_blocked is "
                            f"{x_blocked.dtype}: the operands must share a dtype")
        blocks, x_blocked = blocks.float(), x_blocked.float()
    return spmm_bcsr_dense(
        {"blocks": blocks, "block_cols": block_cols, "indptr": indptr},
        x_blocked,
        n_block_rows=indptr.shape[0] - 1,
    )


def bcsr_spmm(
    blocks: torch.Tensor,  # (n_blocks, bm, bk) float32 or bf16, sorted by block row
    block_cols: torch.Tensor,  # (n_blocks,) int32
    indptr: torch.Tensor,  # (n_block_rows + 1,) int32 block-row pointer
    x_blocked: torch.Tensor,  # (n_col_blocks, bk, k), the dtype of blocks
) -> torch.Tensor:
    """Y = A @ X for A in BCSR; returns (n_block_rows, bm, k) float32.
    Refuses autograd (``NotImplementedError`` under grad when ``blocks`` or
    ``x_blocked`` requires grad): train through :func:`bcsr_spmm_plain`."""
    _build.refuse_autograd("bcsr_spmm", blocks, x_blocked)
    if x_blocked.device.type == "cpu":
        return bcsr_spmm_plain(blocks, block_cols, indptr, x_blocked)
    dev = x_blocked.device
    bf16 = blocks.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    _build.expect(blocks, "blocks", dtype, dev, 3, align=16)
    _build.expect(block_cols, "block_cols", torch.int32, dev, 1)
    _build.expect(indptr, "indptr", torch.int32, dev, 1)
    _build.expect(x_blocked, "x_blocked", dtype, dev, 3, align=16)
    n_blocks, bm, bk = blocks.shape
    _, bk2, k = x_blocked.shape
    gm = indptr.shape[0] - 1
    if bk2 != bk or block_cols.shape[0] != n_blocks or gm < 0:
        raise ValueError(
            f"BCSR shapes blocks {tuple(blocks.shape)} block_cols "
            f"{tuple(block_cols.shape)} x_blocked {tuple(x_blocked.shape)}"
        )
    if bf16 and bk not in BF16_BK:
        raise ValueError(f"the bf16 kernel takes bk in {BF16_BK}, not {bk}")
    y = torch.empty((gm, bm, k), dtype=torch.float32, device=dev)
    if gm == 0 or k == 0:
        return y
    key = "bcsr_spmm_bf16" if bf16 else "bcsr_spmm"
    fn = _build.function("bcsr_spmm", f"{key}_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        code = fn(indptr.data_ptr(), block_cols.data_ptr(), blocks.data_ptr(),
                  x_blocked.data_ptr(), y.data_ptr(), gm, bm, bk, k,
                  _build.stream(dev))
    _build.check("bcsr_spmm", code, f"{key} launch")
    _build.count(key)
    if bf16 and bf16_tensor_core_path(bm, bk):
        _build.count("bcsr_spmm_bf16_mma")
    return y

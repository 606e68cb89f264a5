"""Prepare + dispatch around the CUDA kernels.

Everything the raw kernels don't do: the fill-in of empty BCSR block rows
and the block-row pointer, the chunk-tile padding of SELL, the column-slab
split for an x too large for the on-chip budget, and padding x to whole
blocks or slabs.  Host construction is numpy and produces the same arrays
as ``repro.kernels.ops``; :func:`from_arrays` puts such arrays on a device
(also the way ``repro_torch.interop`` carries the JAX package's prepared
dicts across).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.formats import (
    BCSRMatrix,
    CSRMatrix,
    SELLMatrix,
    nnz_row_ids,
    sell_from_csr,
)
from repro_torch.core.spmv import spmv_sell

from .bcsr_spmm import bcsr_spmm as _bcsr_kernel
from .sell_spmv import sell_spmv as _sell_kernel
from .sell_spmv import sell_spmv_blocked as _sell_blocked_kernel

__all__ = [
    "ONCHIP_BUDGET_BYTES",
    "from_arrays",
    "bcsr_prepare",
    "bcsr_spmm",
    "sell_prepare",
    "sell_spmv",
    "sell_prepare_blocked",
    "sell_spmv_blocked",
    "sell_prepare_blocked_stacked",
    "sell_spmv_blocked_stacked",
    "slab_chunk_widths",
]

# The x footprint above which the tuner adds column-slab SELL candidates.
# On an H100 the gathers into x hit the 50 MB L2; an x of up to 32 MiB
# leaves L2 room for the matrix stream passing through it, a larger one
# thrashes it.  The value equals the JAX package's VMEM budget, so both
# packages enumerate the same candidates for the same matrix.
ONCHIP_BUDGET_BYTES = 32 * 1024 * 1024


def from_arrays(fmt: str, arrays: dict, meta: dict, device) -> dict[str, Any]:
    """A prepared dict on ``device`` from host arrays and static metadata.

    ``fmt`` is ``"bcsr"``, ``"sell"``, ``"sell_blocked"`` (one SELL per
    column slab; ``arrays = {"slabs": [...], "bounds": ...}``),
    ``"sell_blocked_stacked"`` or ``"spmspv"`` (the CSC view; its host
    ``col_len_np`` is kept beside the tensors, and ``top_len_np``, the sums
    of the k longest columns for k = 0 .. n, which bound the products of
    any k distinct touched columns).  What the CUDA kernels walk
    is derived here from the arrays themselves, so a dict carried across
    from ``repro`` gets it too: the BCSR block-row pointer from the
    row-sorted ``block_rows``, and the chunk widths ``chunk_w`` of SELL and
    of the column slabs (see :func:`slab_chunk_widths`).  A ``"sell"`` dict
    stores ``cols``/``vals`` slot-major, (n_chunks, W, C) in memory, and
    holds them as the logical (n_chunks, C, W) view of that storage: the
    values equal ``repro``'s slot for slot, the plain tiers read the view,
    and the SELL kernel reads each chunk's slots as whole sectors.
    """

    def t(v):
        return torch.tensor(np.asarray(v), device=device)

    if fmt == "bcsr":
        gm = int(meta["grid_shape"][0])
        block_rows = np.asarray(arrays["block_rows"])
        if np.any(np.diff(block_rows) < 0):
            raise ValueError("BCSR blocks must be sorted by block row")
        indptr = np.zeros(gm + 1, dtype=np.int32)
        np.cumsum(np.bincount(block_rows, minlength=gm), out=indptr[1:])
        return {
            "block_rows": t(block_rows),
            "block_cols": t(arrays["block_cols"]),
            "blocks": t(arrays["blocks"]),
            "indptr": t(indptr),
            "grid_shape": tuple(int(v) for v in meta["grid_shape"]),
            "block_shape": tuple(int(v) for v in meta["block_shape"]),
            "shape": tuple(int(v) for v in meta["shape"]),
        }
    if fmt == "sell":
        # Stored slot-major, (n_chunks, W, C), and seen as the logical
        # (n_chunks, C, W) view: one slot of a chunk is one 32-byte sector.
        prep = {key: t(np.ascontiguousarray(np.swapaxes(arrays[key], 1, 2)))
                .transpose(1, 2) for key in ("cols", "vals")}
        prep["row_perm"] = t(arrays["row_perm"])
        prep["chunk_w"] = t(slab_chunk_widths(arrays["cols"], arrays["vals"],
                                              multiple=1))
        prep["shape"] = tuple(int(v) for v in meta["shape"])
        prep["chunk_tile"] = int(meta.get("chunk_tile", 8))
        return prep
    if fmt == "sell_blocked_stacked":
        prep = {key: t(arrays[key]) for key in ("cols", "vals", "row_perm")}
        prep["shape"] = tuple(int(v) for v in meta["shape"])
        prep["slab_n"] = int(meta["slab_n"])
        prep["chunk_w"] = t(slab_chunk_widths(arrays["cols"], arrays["vals"]))
        return prep
    if fmt == "sell_blocked":
        m = int(meta["shape"][0])
        bounds = np.asarray(arrays["bounds"], dtype=np.int64)
        slabs = [
            from_arrays(
                "sell", slab,
                {"shape": (m, int(bounds[s + 1] - bounds[s])),
                 "chunk_tile": meta.get("chunk_tile", 8)},
                device,
            )
            for s, slab in enumerate(arrays["slabs"])
        ]
        return {"slabs": slabs, "bounds": bounds,
                "shape": tuple(int(v) for v in meta["shape"])}
    if fmt == "spmspv":
        prep = {key: t(arrays[key])
                for key in ("col_start", "col_len", "rows", "vals")}
        prep["col_len_np"] = np.array(arrays["col_len"], dtype=np.int32)
        n = int(meta["shape"][1])
        top = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.sort(prep["col_len_np"][:n])[::-1], out=top[1:])
        prep["top_len_np"] = top
        prep["shape"] = tuple(int(v) for v in meta["shape"])
        prep["nnz"] = int(meta["nnz"])
        return prep
    raise ValueError(f"unknown prepared format: {fmt}")


def slab_chunk_widths(cols, vals, multiple: int = 4) -> np.ndarray:
    """int32 widths of SELL chunks, ``cols``/``vals`` of shape (..., C, W)
    (stacked column slabs: (n_slabs, n_chunks); one SELL: (n_chunks,)):
    one past the last slot that holds a nonzero value or a nonzero column
    in any of a chunk's rows, rounded up to a multiple of ``multiple`` (0
    for a chunk with none).  A stored (column 0, value 0.0) at the end of a
    chunk counts as padding; it adds nothing to the product."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    held = ((vals != 0) | (cols != 0)).any(axis=-2)  # (..., W)
    W = held.shape[-1]
    width = np.where(held.any(axis=-1), W - np.argmax(held[..., ::-1], axis=-1), 0)
    return np.minimum(-(-width // multiple) * multiple, W).astype(np.int32)


# ---------------------------------------------------------------------------
# BCSR
# ---------------------------------------------------------------------------
def bcsr_prepare(a: BCSRMatrix, device) -> dict[str, Any]:
    """Give every empty block row one explicit zero block at column 0
    (paper-style fill-in, as the JAX package does), sort by block row, and
    add the block-row pointer."""
    gm, _ = a.grid_shape
    present = np.zeros(gm, dtype=bool)
    present[a.block_rows] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    bm, bk = a.block_shape
    block_rows = np.concatenate([a.block_rows, missing])
    block_cols = np.concatenate([a.block_cols, np.zeros_like(missing)])
    blocks = np.concatenate(
        [a.blocks, np.zeros((missing.shape[0], bm, bk), a.blocks.dtype)]
    )
    order = np.argsort(block_rows, kind="stable")
    return from_arrays(
        "bcsr",
        {"block_rows": block_rows[order], "block_cols": block_cols[order],
         "blocks": blocks[order]},
        {"grid_shape": a.grid_shape, "block_shape": a.block_shape,
         "shape": a.shape},
        device,
    )


def bcsr_spmm(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X.  x: (n, k) unblocked; returns (m, k) unpadded."""
    gm, gn = prep["grid_shape"]
    bm, bk = prep["block_shape"]
    m, n = prep["shape"]
    k = x.shape[-1]
    x_pad = torch.zeros((gn * bk, k), dtype=x.dtype, device=x.device)
    x_pad[:n] = x
    out = _bcsr_kernel(
        prep["blocks"], prep["block_cols"], prep["indptr"],
        x_pad.view(gn, bk, k),
    )
    return out.reshape(gm * bm, k)[:m]


# ---------------------------------------------------------------------------
# SELL
# ---------------------------------------------------------------------------
def _sell_pad(a: SELLMatrix, chunk_tile: int) -> dict[str, np.ndarray]:
    """Pad the chunk count to a multiple of chunk_tile."""
    pad = (-a.n_chunks) % chunk_tile
    cols, vals, row_perm = a.cols, a.vals, a.row_perm
    if pad:
        cols = np.concatenate([cols, np.zeros((pad,) + cols.shape[1:], cols.dtype)])
        vals = np.concatenate([vals, np.zeros((pad,) + vals.shape[1:], vals.dtype)])
        row_perm = np.concatenate(
            [row_perm, np.full(pad * a.C, -1, row_perm.dtype)]
        )
    return {"cols": cols, "vals": vals, "row_perm": row_perm}


def sell_prepare(a: SELLMatrix, chunk_tile: int = 8, *, device) -> dict[str, Any]:
    return from_arrays(
        "sell", _sell_pad(a, chunk_tile),
        {"shape": a.shape, "chunk_tile": chunk_tile}, device,
    )


def sell_spmv(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the SELL kernel (un-permute fused)."""
    return _sell_kernel(
        prep["cols"], prep["vals"], x, prep["row_perm"],
        n_rows=prep["shape"][0], chunk_w=prep["chunk_w"],
        chunk_tile=prep["chunk_tile"],
    )


# ---------------------------------------------------------------------------
# Column slabs, one independent SELL per slab (the sell_blocked/ref tier)
# ---------------------------------------------------------------------------
def sell_prepare_blocked(a: CSRMatrix, n_slabs: int, chunk_tile: int = 8,
                         C: int = 8, sigma: int = 64, *, device) -> dict[str, Any]:
    """Split A into column slabs, one SELL per slab (cache blocking,
    Nishtala et al. in the paper's references).  One searchsorted assigns
    every nonzero to its slab; the mask keeps row-major order, so per-row
    column order is unchanged from A."""
    m, n = a.shape
    bounds = np.linspace(0, n, n_slabs + 1).astype(np.int64)
    rows_of_nnz = nnz_row_ids(a.indptr, dtype=np.int64)
    slab_of_nnz = np.searchsorted(bounds[1:], a.indices, side="right")
    slabs = []
    for s in range(n_slabs):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        sel = slab_of_nnz == s
        counts = np.bincount(rows_of_nnz[sel], minlength=m)
        indptr = np.zeros(m + 1, dtype=a.indptr.dtype)
        np.cumsum(counts, out=indptr[1:])
        sub = CSRMatrix(
            (m, hi - lo), indptr,
            (a.indices[sel] - lo).astype(a.indices.dtype),
            a.data[sel],
        )
        slabs.append(
            _sell_pad(sell_from_csr(sub, C=C, sigma=sigma, width_align=8),
                      chunk_tile)
        )
    return from_arrays(
        "sell_blocked", {"slabs": slabs, "bounds": bounds},
        {"shape": a.shape, "chunk_tile": chunk_tile}, device,
    )


def sell_spmv_blocked(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """y = A @ x as a sum of per-slab plain SELL products (the reference
    for the single-launch :func:`sell_spmv_blocked_stacked`)."""
    m, _ = prep["shape"]
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    for s, slab in enumerate(prep["slabs"]):
        lo, hi = int(prep["bounds"][s]), int(prep["bounds"][s + 1])
        y = y + spmv_sell(slab, x[lo:hi], n_rows=m)
    return y


# ---------------------------------------------------------------------------
# Stacked column slabs over one shared row permutation (one launch)
# ---------------------------------------------------------------------------
def sell_prepare_blocked_stacked(a: CSRMatrix, n_slabs: int, C: int = 8,
                                 sigma: int = 64, *, device) -> dict[str, Any]:
    """Pack A into ``n_slabs`` column slabs sharing ONE row permutation.

    Every slab is packed over the same window-of-``sigma`` row sort, so the
    per-slab partial sums align positionally and the kernel accumulates
    them across slabs.  All slabs share one width W (the most nonzeros of
    any (row, slab) cell, rounded up to 8): cols/vals are
    (n_slabs, n_chunks, C, W), as in the JAX package.  Beside them,
    ``chunk_w`` (n_slabs, n_chunks) says how many slots of each chunk the
    kernel reads.  Slab widths are uniform (``slab_n = ceil(n /
    n_slabs)``; x is zero-padded to n_slabs * slab_n).
    """
    m, n = a.shape
    slab_n = max(1, -(-n // n_slabs))
    lengths = np.diff(a.indptr).astype(np.int64)
    perm = np.arange(m)
    for s in range(0, m, sigma):
        e = min(s + sigma, m)
        window = perm[s:e]
        perm[s:e] = window[np.argsort(-lengths[window], kind="stable")]
    inv_perm = np.empty(m, dtype=np.int64)
    inv_perm[perm] = np.arange(m)
    n_chunks = max(1, -(-m // C))

    rows_of_nnz = nnz_row_ids(a.indptr, dtype=np.int64)
    slab_of_nnz = a.indices.astype(np.int64) // slab_n
    # Within a row, columns ascend, so each (row, slab) group is a contiguous
    # run; the slot of a nonzero is its rank inside that run.
    key = rows_of_nnz * n_slabs + slab_of_nnz
    counts = np.bincount(key, minlength=m * n_slabs) if a.nnz else np.zeros(1)
    W = int(max(counts.max(initial=0), 1))
    W = -(-W // 8) * 8
    run_start = np.zeros(a.nnz, dtype=np.int64)
    if a.nnz:
        new_run = np.flatnonzero(np.diff(key) != 0) + 1
        starts = np.concatenate([[0], new_run])
        run_id = np.zeros(a.nnz, dtype=np.int64)
        run_id[new_run] = 1
        run_id = np.cumsum(run_id)
        run_start = starts[run_id]
    slot = np.arange(a.nnz, dtype=np.int64) - run_start

    sorted_row = inv_perm[rows_of_nnz]
    cols = np.zeros((n_slabs, n_chunks, C, W), dtype=np.int32)
    vals = np.zeros((n_slabs, n_chunks, C, W), dtype=a.data.dtype)
    cols[slab_of_nnz, sorted_row // C, sorted_row % C, slot] = (
        a.indices.astype(np.int64) - slab_of_nnz * slab_n
    )
    vals[slab_of_nnz, sorted_row // C, sorted_row % C, slot] = a.data
    row_perm = np.full(n_chunks * C, -1, dtype=np.int32)
    row_perm[:m] = perm
    return from_arrays(
        "sell_blocked_stacked",
        {"cols": cols, "vals": vals, "row_perm": row_perm},
        {"shape": a.shape, "slab_n": slab_n},
        device,
    )


def sell_spmv_blocked_stacked(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the single-launch column-slab kernel."""
    n_slabs = prep["cols"].shape[0]
    slab_n = prep["slab_n"]
    x_pad = torch.zeros((n_slabs * slab_n,), dtype=x.dtype, device=x.device)
    x_pad[: x.shape[0]] = x
    return _sell_blocked_kernel(
        prep["cols"], prep["vals"], x_pad, prep["row_perm"],
        n_rows=prep["shape"][0], slab_n=slab_n, chunk_w=prep["chunk_w"],
    )

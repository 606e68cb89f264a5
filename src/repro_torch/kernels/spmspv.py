"""SpMSpV — y = A @ x with a *sparse* x: the work-efficient bucket tier.

The Azad–Buluc bucket SpMSpV, as the JAX package shapes it:

* :func:`spmspv_prepare` builds the CSC view of A once on the host (column
  starts and lengths plus the row/value streams), because a sparse x
  touches *columns*; a virtual length-0 sentinel column at index ``n``
  makes padded x slots free.  The arrays equal ``repro``'s.
* :func:`expand_products` expands exactly the touched columns into a
  ``(rows, products)`` stream: per-slot offsets from a cumsum over the
  touched column lengths, and a ``searchsorted`` mapping every product
  lane back to its x slot.  The stream is padded to a *work bucket* G from
  a geometric ladder (:func:`work_bucket`), so its shapes stay static.
* :func:`spmspv_scatter` accumulates the stream: ``y[rows[t]] += prods[t]``
  for the true products t < total.  It launches ``csrc/spmspv_scatter.cu``,
  which replaces the TPU kernel ``repro.kernels.spmspv.spmspv_scatter_pallas``;
  :func:`spmspv_scatter_plain` is its plain torch version.

Padding conventions: x slots pad with the sentinel column ``n`` and value
0; product lanes past the true total carry (row 0, value 0).  An all-zero
x is the smallest work bucket of pure padding and returns exact zeros.

:func:`spmspv_bind` takes the padded operands as HOST numpy arrays: it
picks G on the host from ``col_len_np`` and copies the two short arrays to
the device in one transfer, so a request never waits on a device value.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .ops import from_arrays

__all__ = [
    "WORK_BUCKET_BASE",
    "WORK_BUCKET_GROWTH",
    "expand_products",
    "pad_sparse_rhs",
    "spmspv_bind",
    "spmspv_prepare",
    "spmspv_scatter",
    "spmspv_scatter_plain",
    "validate_sparse_rhs",
    "work_bucket",
]

# Geometric work-bucket ladder: G = BASE * GROWTH**i, capped at nnz(A)
# rounded up to BASE (the JAX package's values).
WORK_BUCKET_BASE = 256
WORK_BUCKET_GROWTH = 4

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def validate_sparse_rhs(indices, values, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Validate a sparse RHS given as (indices, values); return host copies.

    Out-of-range, unsorted or duplicated indices would silently corrupt the
    gather, so they raise here, with the JAX package's texts.
    """
    idx = np.asarray(indices)
    val = np.asarray(values)
    if idx.ndim != 1 or val.ndim != 1 or idx.shape[0] != val.shape[0]:
        raise ValueError(
            f"sparse RHS: indices shape {idx.shape} and values shape {val.shape} "
            "must be 1-D and the same length; pass the nonzero coordinates of x "
            "as (indices, values)"
        )
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(
            f"sparse RHS: indices dtype {idx.dtype} is not an integer type; pass "
            "int32/int64 column coordinates (np.nonzero(x) produces them directly)"
        )
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= n:
            bad = lo if lo < 0 else hi
            raise ValueError(
                f"sparse RHS: index {bad} is outside [0, {n}) for this "
                f"{n}-column operand; sparse coordinates address columns of A — "
                "check the operand orientation or clip the coordinate list"
            )
        if np.any(np.diff(idx) <= 0):
            raise ValueError(
                "sparse RHS: indices must be strictly increasing (sorted, no "
                "duplicates) — the bucketed dispatch keys column segments by "
                "sorted coordinates; canonicalize with np.unique (summing the "
                "values of duplicate coordinates first)"
            )
    return idx.astype(np.int64, copy=False), val


def pad_sparse_rhs(idx: np.ndarray, val: np.ndarray, bucket: int, n: int):
    """Pad validated (idx, val) to the x-nnz ``bucket`` with sentinel slots."""
    size = int(idx.size)
    if size > bucket:
        raise ValueError(
            f"sparse RHS has nnz={size} but the x-nnz bucket is {bucket}; "
            f"build the operator with x_nnz >= {size} (the engine's "
            "submit_sparse picks the bucket automatically)"
        )
    xi = np.full(bucket, n, dtype=np.int32)  # sentinel = empty column n
    xv = np.zeros(bucket, dtype=np.float32)
    xi[:size] = idx
    xv[:size] = val
    return xi, xv


def spmspv_prepare(a, *, device) -> dict:
    """CSC view of a CSR matrix with a sentinel empty column, on ``device``.

    ``col_start``/``col_len`` have n + 1 entries (entry n is the length-0
    padding column); ``rows``/``vals`` are the CSC-ordered streams, padded
    with one zero entry when nnz == 0 so gathers stay in bounds.
    ``col_len_np`` keeps a host copy for picking the work bucket.
    """
    m, n = a.shape
    nnz = int(a.indptr[-1])
    if nnz >= 2**31:
        raise OverflowError(
            f"spmspv tier: nnz={nnz} overflows the int32 CSC offsets; this "
            "matrix needs row-partitioned shards each below 2**31 nnz"
        )
    lengths = np.diff(np.asarray(a.indptr))
    rows_of = np.repeat(np.arange(m, dtype=np.int64), lengths)
    order = np.argsort(np.asarray(a.indices), kind="stable")
    csc_rows = rows_of[order].astype(np.int32)
    csc_vals = np.asarray(a.data)[order].astype(np.float32)
    if csc_rows.size == 0:
        csc_rows = np.zeros(1, np.int32)
        csc_vals = np.zeros(1, np.float32)
    col_len = np.zeros(n + 1, np.int32)
    if n:
        col_len[:n] = np.bincount(np.asarray(a.indices), minlength=n)
    col_start = np.zeros(n + 1, np.int32)
    col_start[1:] = np.cumsum(col_len[:n])  # col_start[n] = nnz: empty sentinel
    return from_arrays(
        "spmspv",
        {"col_start": col_start, "col_len": col_len, "rows": csc_rows,
         "vals": csc_vals},
        {"shape": (m, n), "nnz": nnz},
        device,
    )


def work_bucket(total: int, nnz: int) -> int:
    """Smallest ladder bucket >= ``total`` gathered products, capped at nnz
    rounded up to WORK_BUCKET_BASE."""
    cap = -(-max(int(nnz), 1) // WORK_BUCKET_BASE) * WORK_BUCKET_BASE
    g = WORK_BUCKET_BASE
    while g < min(int(total), cap):
        g *= WORK_BUCKET_GROWTH
    return min(g, cap)


def expand_products(prep: dict, xi: torch.Tensor, xv: torch.Tensor, G: int):
    """Expand the touched columns into (rows, products) streams of length G.

    ``searchsorted`` over the cumulative touched-column lengths maps each
    product lane t back to its x slot; lanes past the true total carry
    (row 0, value 0).  The same arithmetic as the JAX package's, so the
    streams are equal bit for bit.
    """
    B = xi.shape[0]
    xi = xi.long()
    lens = prep["col_len"][xi]  # (B,); the sentinel column n contributes 0
    offs = torch.zeros(B + 1, dtype=torch.int32, device=lens.device)
    offs[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    t = torch.arange(G, dtype=torch.int32, device=lens.device)
    slot = (torch.searchsorted(offs, t, right=True) - 1).clamp_(0, B - 1)
    within = t - offs[slot]
    valid = t < offs[-1]
    src = torch.where(valid, prep["col_start"][xi[slot]] + within, 0).long()
    rows = torch.where(valid, prep["rows"][src], 0)
    prods = torch.where(valid, prep["vals"][src] * xv[slot], 0.0)
    return rows, prods


def spmspv_scatter_plain(rows: torch.Tensor, prods: torch.Tensor, m: int,
                         total: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: y[rows[t]] += prods[t] over
    the true products t < total (one ``index_add_``)."""
    y = torch.zeros(m, dtype=prods.dtype, device=prods.device)
    return y.index_add_(0, rows[:total], prods[:total])


def spmspv_scatter(
    rows: torch.Tensor,  # (G,) int32, row of each product
    prods: torch.Tensor,  # (G,) float32
    *,
    m: int,
    total: int,
    slab: int = 4096,
) -> torch.Tensor:
    """y (m,) = scatter-add of the first ``total`` products of the stream.

    ``slab`` is the number of products each thread block covers.  The
    padded tail (t >= total) is never read.
    """
    if rows.shape != prods.shape or rows.dim() != 1:
        raise ValueError(
            f"rows {tuple(rows.shape)} and prods {tuple(prods.shape)} must be "
            "1-D streams of the same length"
        )
    if not 0 <= int(total) <= rows.shape[0]:
        raise ValueError(f"total {total} is outside [0, {rows.shape[0]}]")
    if prods.device.type == "cpu":
        return spmspv_scatter_plain(rows, prods, m, total)
    dev = prods.device
    _build.expect(rows, "rows", torch.int32, dev, 1)
    _build.expect(prods, "prods", torch.float32, dev, 1)
    if int(slab) < 1:
        raise ValueError(f"slab must be >= 1, got {slab}")
    y = torch.zeros(m, dtype=torch.float32, device=dev)
    if total == 0:
        return y
    fn = _build.function(
        "spmspv_scatter", "spmspv_scatter_launch", [_P, _P, _P, _LL, _I, _P]
    )
    with torch.cuda.device(dev):
        code = fn(rows.data_ptr(), prods.data_ptr(), y.data_ptr(), int(total),
                  int(slab), _build.stream(dev))
    _build.check("spmspv_scatter", code, "spmspv_scatter launch")
    _build.LAUNCHES["spmspv_scatter"] += 1
    return y


def _to_device(xi: np.ndarray, xv, device: torch.device):
    """(xi, xv) on ``device`` in one host-to-device copy."""
    B = xi.shape[0]
    buf = np.empty(2 * B, np.int32)
    buf[:B] = xi
    buf[B:] = np.ascontiguousarray(xv, dtype=np.float32).view(np.int32)
    d = torch.from_numpy(buf).to(device)
    return d[:B], d[B:].view(torch.float32)


def spmspv_bind(prep: dict, x_nnz: int, *, impl: str = "ref", slab: int = 4096):
    """Bind ``fn((xi, xv)) -> y`` over padded (x_nnz,) HOST operands.

    Per call the host gathers ``col_len_np[xi]`` to find the true product
    count T, picks the work bucket G from the ladder, and copies xi and xv
    to the device once.  ``impl="cuda"`` scatters through the CUDA kernel,
    ``impl="ref"`` through the plain version.
    """
    if impl not in ("ref", "cuda"):
        raise ValueError(f"unknown spmspv impl {impl!r}: ref or cuda")
    col_len = prep["col_len_np"]
    nnz = prep["nnz"]
    m, _ = prep["shape"]
    device = prep["rows"].device
    bucket = int(x_nnz)

    def fn(sx):
        xi, xv = sx
        xi_host = np.clip(np.asarray(xi).astype(np.int32, copy=False),
                          0, col_len.size - 1)
        if xi_host.shape != (bucket,):
            raise ValueError(
                f"sparse operand has shape {xi_host.shape}; this runner takes "
                f"({bucket},) padded slots (pad_sparse_rhs)"
            )
        total = int(col_len[xi_host].sum())
        rows, prods = expand_products(prep, *_to_device(xi_host, xv, device),
                                      work_bucket(total, nnz))
        if impl == "cuda":
            return spmspv_scatter(rows, prods, m=m, total=total, slab=slab)
        return spmspv_scatter_plain(rows, prods, m, total)

    return fn

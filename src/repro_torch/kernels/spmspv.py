"""SpMSpV — y = A @ x with a *sparse* x: the work-efficient bucket tier.

The Azad–Buluc bucket SpMSpV, as the JAX package shapes it:

* :func:`spmspv_prepare` builds the CSC view of A once on the host (column
  starts and lengths plus the row/value streams), because a sparse x
  touches *columns*; a virtual length-0 sentinel column at index ``n``
  makes padded x slots free.  The arrays equal ``repro``'s.
* :func:`spmspv_scatter` launches ``csrc/spmspv_scatter.cu``: four passes
  (``SCATTER_PASSES``) that expand the touched columns, sort their true
  products stably into buckets of ``2**shift`` rows (:func:`row_tiles`),
  and sum each bucket's rows one product after another.  Every y_i is then
  the left-to-right float32 sum of row i's products in stream order
  (ascending x slot, CSC order within a column), starting from +0.0: the
  function the TPU kernel ``repro.kernels.spmspv.spmspv_scatter_pallas``
  computes with its sequential slab loop, bit for bit, and the same every
  run.  It replaces that kernel together with the expansion that feeds it.
  The host gives it the cumulative touched-column offsets
  (:func:`touched_offsets`) and each block's first slot
  (:func:`scatter_plan`).
* :func:`spmspv_scatter_plain` is its plain torch version:
  :func:`expand_products` expands the touched columns into a ``(rows,
  products)`` stream padded to a *work bucket* G from a geometric ladder
  (:func:`work_bucket`), exactly as ``repro`` does, and one ``index_add_``
  adds its true products.  On the CPU that ``index_add_`` adds in stream
  order, so it equals the kernel bit for bit; on a card it is an atomic
  ``index_add_`` whose order changes from run to run, so there only the
  kernel is bitwise repeatable.

Padding conventions: x slots pad with the sentinel column ``n`` and value
0; product lanes past the true total carry (row 0, value 0).  An all-zero
x has no products and returns exact zeros without a launch.

:func:`spmspv_bind` takes the padded operands as HOST numpy arrays: the
host finds the offsets and the block plan from ``col_len_np`` and copies
them with xi and xv in one transfer, so a request never waits on a device
value.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .ops import from_arrays

__all__ = [
    "WORK_BUCKET_BASE",
    "WORK_BUCKET_GROWTH",
    "SCATTER_LAUNCHES",
    "SCATTER_MAX_TILE",
    "SCATTER_MAX_TILES",
    "SCATTER_PASSES",
    "SCATTER_SMEM_TILE_ROWS",
    "expand_products",
    "pad_sparse_rhs",
    "row_tiles",
    "scatter_plan",
    "spmspv_bind",
    "spmspv_prepare",
    "spmspv_scatter",
    "spmspv_scatter_plain",
    "stage_sparse",
    "touched_offsets",
    "validate_sparse_rhs",
    "work_bucket",
]

# Geometric work-bucket ladder: G = BASE * GROWTH**i, capped at nnz(A)
# rounded up to BASE (the JAX package's values).
WORK_BUCKET_BASE = 256
WORK_BUCKET_GROWTH = 4

# The kernel's passes, in launch order; a request with T > 0 true products
# launches each once, and one with none launches nothing.
SCATTER_PASSES = ("count", "scan", "place", "sum")
SCATTER_LAUNCHES = len(SCATTER_PASSES)
# Products a block (one warp) takes at most, row tiles at most, and rows a
# tile sums in shared memory at most (csrc/spmspv_scatter.cu: kMaxTile,
# kMaxTiles, 1 << kSmemTileShift); a larger tile sums its rows in y itself.
SCATTER_MAX_TILE = 1024
SCATTER_MAX_TILES = 1024
SCATTER_SMEM_TILE_ROWS = 8192

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
    if nnz >= 2**31 or m >= 2**31:
        raise OverflowError(
            f"spmspv tier: nnz={nnz} or m={m} overflows the int32 CSC offsets "
            "and rows; this matrix needs row-partitioned shards each below "
            "2**31 rows and nnz"
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


def spmspv_scatter_plain(prep: dict, xi: torch.Tensor, xv: torch.Tensor,
                         total: int) -> torch.Tensor:
    """The kernel's function in plain torch: :func:`expand_products` into
    the work bucket, then one ``index_add_`` over the first ``total`` true
    products (the padded tail is never added).  In stream order on the CPU;
    in an order that changes from run to run on a card."""
    m, _ = prep["shape"]
    rows, prods = expand_products(prep, xi, xv, work_bucket(total, prep["nnz"]))
    y = torch.zeros(m, dtype=prods.dtype, device=prods.device)
    return y.index_add_(0, rows[:total], prods[:total])


def touched_offsets(col_len: np.ndarray, xi: np.ndarray, out=None) -> np.ndarray:
    """(B + 1,) int32 cumulative lengths of the touched columns: x slot s
    owns products [offs[s], offs[s + 1]); offs[B] is the true total T.  On
    the host, written into ``out`` when given (torch's CPU gather and
    in-place cumsum on views of the numpy arrays: both beat numpy's at a
    few 10^5 slots); T < nnz < 2**31 (guarded in :func:`spmspv_prepare`)."""
    offs = np.empty(xi.shape[0] + 1, np.int32) if out is None else out
    offs[0] = 0
    tail = torch.from_numpy(offs)[1:]
    torch.index_select(torch.from_numpy(col_len), 0,
                       torch.from_numpy(np.ascontiguousarray(xi)), out=tail)
    tail.cumsum_(0)
    return offs


def scatter_plan(offs: np.ndarray, slab: int = 4096,
                 out=None) -> tuple[int, np.ndarray]:
    """How the kernel splits the T = offs[-1] products: (tile, first).
    Block b (one warp) takes products [b * tile, (b + 1) * tile); ``first``
    (n_blocks + 1,) int32 holds the slot of each block's first product and,
    last, the slot of product T - 1, so block b's products lie in slots
    first[b] .. first[b + 1].  The tile is sqrt(T) rounded up to a warp's
    32, within [32, ``SCATTER_MAX_TILE``] and capped at ``slab``: about as
    many blocks as :func:`row_tiles` gives row tiles, so the count matrix
    (blocks x row tiles) stays near T entries.  ``first`` is written into
    the start of ``out`` when given."""
    total = int(offs[-1])
    if total == 0:
        first = np.zeros(1, np.int32) if out is None else out[:1]
        first[0] = 0
        return 32, first
    tile = -(-math.isqrt(total) // 32) * 32
    tile = min(max(tile, 32), SCATTER_MAX_TILE, max(int(slab), 1))
    n_blocks = -(-total // tile)
    starts = np.empty(n_blocks + 1, np.int32)  # the same dtype as offs: no cast
    np.multiply(np.arange(n_blocks), tile, out=starts[:-1], casting="unsafe")
    starts[-1] = total - 1
    first = np.empty(n_blocks + 1, np.int32) if out is None else out[:n_blocks + 1]
    np.subtract(np.searchsorted(offs, starts, side="right"), 1, out=first,
                casting="unsafe")
    return tile, first


def row_tiles(m: int, total: int) -> tuple[int, int]:
    """The kernel's row tiles for an m-row y (m < 2**31) and T = ``total``
    products: (shift, n_tiles), n_tiles = ceil(m / 2**shift) tiles of
    2**shift rows.  About sqrt(T) tiles of 32 to ``SCATTER_SMEM_TILE_ROWS``
    rows (summed in shared memory); where m needs more than
    ``SCATTER_MAX_TILES`` of those, ``SCATTER_MAX_TILES`` tiles at most of
    as many rows as it takes (summed in y itself)."""
    target = max(math.isqrt(int(total)), 1)
    shift = 5
    while (1 << shift) < SCATTER_SMEM_TILE_ROWS and (target << shift) < m:
        shift += 1
    while (SCATTER_MAX_TILES << shift) < m:
        shift += 1
    return shift, -(-int(m) >> shift)


def spmspv_scatter(
    prep: dict,  # spmspv_prepare's CSC view
    xi: torch.Tensor,  # (B,) int32 x slots (sentinel n = padding)
    xv: torch.Tensor,  # (B,) float32
    offs: torch.Tensor,  # (B + 1,) int32, touched_offsets
    first: torch.Tensor,  # (n_blocks + 1,) int32, scatter_plan
    *,
    total: int,
    tile: int,
) -> torch.Tensor:
    """y (m,) = A @ x for the padded sparse x (xi, xv) over the ``total``
    true products, each row summed in stream order (the module's note).

    ``offs`` and ``first`` come from :func:`touched_offsets` and
    :func:`scatter_plan` on the host, which also give ``total`` and
    ``tile``, so nothing here waits on a device value.  On a card one C
    call launches the ``SCATTER_LAUNCHES`` passes in order on the current
    stream, checking each launch right after it, into one scratch tensor
    taken with ``torch.empty``; each launched pass counts once as
    ``spmspv_scatter``, and a refused one raises.  With no product nothing
    launches.  On CPU tensors the plain version runs (it needs only xi, xv
    and total).  Under grad, with ``xv`` or A's values requiring grad, it
    raises on either device (``_build.refuse_autograd``): the kernel has no
    backward."""
    B = xi.shape[0]
    n_blocks = -(-int(total) // max(int(tile), 1))
    if xi.dim() != 1 or tuple(xv.shape) != (B,) or tuple(offs.shape) != (B + 1,):
        raise ValueError(
            f"xi {tuple(xi.shape)}, xv {tuple(xv.shape)} and offs "
            f"{tuple(offs.shape)} must be (B,), (B,) and (B + 1,)"
        )
    if int(total) < 0 or int(tile) < 1 or tuple(first.shape) != (n_blocks + 1,):
        raise ValueError(
            f"total {total} and tile {tile} give {n_blocks} blocks, so first "
            f"must be ({n_blocks + 1},), got {tuple(first.shape)} (scatter_plan)"
        )
    _build.refuse_autograd("spmspv_scatter", prep["vals"], xv)
    if xv.device.type == "cpu":
        return spmspv_scatter_plain(prep, xi, xv, total)
    dev = xv.device
    m, _ = prep["shape"]
    for t, name, dtype in ((xi, "xi", torch.int32), (xv, "xv", torch.float32),
                           (offs, "offs", torch.int32), (first, "first", torch.int32),
                           (prep["col_start"], "col_start", torch.int32),
                           (prep["rows"], "rows", torch.int32),
                           (prep["vals"], "vals", torch.float32)):
        _build.expect(t, name, dtype, dev, 1)
    if int(tile) > SCATTER_MAX_TILE:
        raise ValueError(
            f"tile {tile} exceeds {SCATTER_MAX_TILE} products a block (scatter_plan)"
        )
    total, tile = int(total), int(tile)
    if total == 0:
        return torch.zeros(m, dtype=torch.float32, device=dev)
    shift, n_tiles = row_tiles(m, total)
    # [counts (n_blocks x n_tiles) | tot | tile_start | ticket | bucket rows
    #  | bucket products]
    scratch = torch.empty(n_blocks * n_tiles + 2 * n_tiles + 2 + 2 * total,
                          dtype=torch.int32, device=dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)  # the sum pass writes every row
    fn = _build.function("spmspv_scatter", "spmspv_scatter_launch",
                         [_P] * 9 + [_I] * 6 + [_P, _P])
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        code = fn(prep["col_start"].data_ptr(), prep["rows"].data_ptr(),
                  prep["vals"].data_ptr(), xi.data_ptr(), xv.data_ptr(),
                  offs.data_ptr(), first.data_ptr(), scratch.data_ptr(), y.data_ptr(),
                  m, total, tile, n_blocks, shift, n_tiles, ctypes.byref(launched),
                  _build.stream(dev))
    for _ in range(launched.value):  # each launch checked in C right after it
        _build.count("spmspv_scatter")
    _build.check("spmspv_scatter", code, "spmspv_scatter launch, "
                 f"{SCATTER_PASSES[min(launched.value, SCATTER_LAUNCHES - 1)]} pass")
    return y


def stage_sparse(prep: dict, xi, xv, *, slab: int = 4096) -> dict:
    """The kernel's operands for one padded sparse x given as HOST arrays:
    ``xi``, ``xv``, ``offs`` and ``first`` on the prep's device, written
    into one int32 host buffer and sent in one host-to-device copy, beside
    ``total`` and ``tile``, as :func:`spmspv_scatter` takes them."""
    col_len = prep["col_len_np"]
    B = int(np.shape(xi)[0])
    # [xi | xv bits | offs | first]; the blocks are at most nnz / tile_min
    max_blocks = -(-max(int(prep["nnz"]), 1) // min(32, max(int(slab), 1)))
    buf = np.empty(3 * B + 2 + max_blocks, np.int32)
    xi_h, offs = buf[:B], buf[2 * B:3 * B + 1]
    np.clip(np.asarray(xi), 0, col_len.size - 1, out=xi_h, casting="unsafe")
    buf[B:2 * B] = np.asarray(xv, dtype=np.float32).view(np.int32)
    touched_offsets(col_len, xi_h, out=offs)
    tile, first = scatter_plan(offs, slab, out=buf[3 * B + 1:])
    used = 3 * B + 1 + first.shape[0]
    d = torch.from_numpy(buf[:used]).to(prep["rows"].device)
    return {"xi": d[:B], "xv": d[B:2 * B].view(torch.float32),
            "offs": d[2 * B:3 * B + 1], "first": d[3 * B + 1:used],
            "total": int(offs[-1]), "tile": tile}


def spmspv_bind(prep: dict, x_nnz: int, *, impl: str = "ref", slab: int = 4096):
    """Bind ``fn((xi, xv)) -> y`` over padded (x_nnz,) HOST operands.

    Per call the host gathers ``col_len_np[xi]`` into the cumulative
    offsets (the true product count T is the last), and copies what the
    device needs in one transfer.  ``impl="cuda"`` runs the kernel
    (``SCATTER_LAUNCHES`` launches; ``slab`` caps the products a block
    takes), ``impl="ref"`` the plain version (expansion into the work
    bucket, then ``index_add_``).
    """
    if impl not in ("ref", "cuda"):
        raise ValueError(f"unknown spmspv impl {impl!r}: ref or cuda")
    bucket = int(x_nnz)

    def fn(sx):
        xi, xv = sx
        if np.shape(xi) != (bucket,):
            raise ValueError(
                f"sparse operand has shape {np.shape(xi)}; this runner takes "
                f"({bucket},) padded slots (pad_sparse_rhs)"
            )
        op = stage_sparse(prep, xi, xv, slab=slab)
        if impl == "cuda":
            return spmspv_scatter(prep, op["xi"], op["xv"], op["offs"],
                                  op["first"], total=op["total"], tile=op["tile"])
        return spmspv_scatter_plain(prep, op["xi"], op["xv"], op["total"])

    return fn

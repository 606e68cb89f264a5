"""SpMSpV — y = A @ x with a *sparse* x: the work-efficient bucket tier.

The Azad–Buluc bucket SpMSpV, as the JAX package shapes it:

* :func:`spmspv_prepare` builds the CSC view of A once on the host (column
  starts and lengths plus the row/value streams), because a sparse x
  touches *columns*; a virtual length-0 sentinel column at index ``n``
  makes padded x slots free.  The arrays equal ``repro``'s.
* :func:`spmspv_scatter` launches ``csrc/spmspv_scatter.cu``: five passes
  (``SCATTER_PASSES``) that find the touched columns' offsets on the
  device, expand their true products, sort them stably into row-tile
  buckets and, inside each tile, by row, then sum each row one product
  after another.  Every y_i is then the left-to-right float32 sum of row
  i's products in stream order (ascending x slot, CSC order within a
  column), starting from +0.0: the function the TPU kernel
  ``repro.kernels.spmspv.spmspv_scatter_pallas`` computes with its
  sequential slab loop, bit for bit, and the same every run.  It replaces
  that kernel together with the expansion that feeds it.
* :func:`scatter_plan` fixes a launch's shapes per (operator, x-nnz
  bucket) from bounds the host knows without reading the device: the sum
  of the bucket's B longest columns (``top_len_np``, made once with the
  prepared dict) sizes the scratch, the row tiles (:func:`row_tiles`)
  follow the expected product count.  The device splits the products it
  finds into chunks (:func:`chunk_shift`).
* :class:`SparseStager` is a request's host half: the padded x slots and
  values, and the zeroed flag words the passes synchronise on, written
  into a reused pinned buffer and sent in one host-to-device copy.
* :func:`spmspv_scatter_plain` is its plain torch version:
  :func:`expand_products` expands the touched columns into a ``(rows,
  products)`` stream padded to a *work bucket* G from a geometric ladder
  (:func:`work_bucket`), exactly as ``repro`` does, and its true products
  are added to each row in stream order: by one ``index_add_`` on the CPU,
  and on a card by :func:`rank_ordered_sum` (a stable sort by row, then
  one ``index_add_`` per rank within the row, so no row takes two adds in
  one call).  Both equal the kernel bit for bit, every run.

Padding conventions: x slots pad with the sentinel column ``n`` and value
0; product lanes past the true total carry (row 0, value 0).  An x with no
nonzero launches nothing (:func:`spmspv_bind` returns zeros); a T of 0 from
empty touched columns launches the passes, which write zeros.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from . import _build
from .ops import from_arrays

__all__ = [
    "WORK_BUCKET_BASE",
    "WORK_BUCKET_GROWTH",
    "SCATTER_GRAIN",
    "SCATTER_LAUNCHES",
    "SCATTER_MAX_CHUNK",
    "SCATTER_MAX_TILES",
    "SCATTER_MIN_TILES",
    "SCATTER_PASSES",
    "SCATTER_SCAN_SLOTS",
    "SCATTER_SMEM_TILE_ROWS",
    "SCATTER_SORT_BYTES",
    "SCATTER_SORT_DIGIT_BITS",
    "SCATTER_TARGET_CHUNKS",
    "SCATTER_TILE_PRODUCTS",
    "ScatterPlan",
    "SparseStager",
    "chunk_shift",
    "expand_products",
    "pad_sparse_rhs",
    "rank_ordered_sum",
    "row_tiles",
    "scatter_plan",
    "sort_cap",
    "spmspv_bind",
    "spmspv_prepare",
    "spmspv_scatter",
    "spmspv_scatter_plain",
    "stage_sparse",
    "validate_sparse_rhs",
    "work_bucket",
]

# Geometric work-bucket ladder: G = BASE * GROWTH**i, capped at nnz(A)
# rounded up to BASE (the JAX package's values).
WORK_BUCKET_BASE = 256
WORK_BUCKET_GROWTH = 4

# The kernel's passes, in launch order; every launch runs all five.
SCATTER_PASSES = ("offsets", "count", "scan", "place", "sum")
SCATTER_LAUNCHES = len(SCATTER_PASSES)
# csrc/spmspv_scatter.cu's constants: x slots an offsets block scans
# (kScanSlots); products a chunk starts on and takes at most (1 <<
# kGrainShift, 1 << kMaxChunkShift); the chunk count the device aims at
# (kTargetChunks); row tiles at most (kMaxTiles); rows a tile sorts by row
# (1 << kSortShift: a larger tile is summed in y itself); a sum block's
# shared memory (kSortBytes), which bounds the products a tile sorts there
# (sort_cap: a longer bucket sorts in global scratch); the bits of the row a
# pass of the in-tile sort keys on at most (kDigitMax).
SCATTER_SCAN_SLOTS = 4096
SCATTER_GRAIN = 256
SCATTER_MAX_CHUNK = 4096
SCATTER_TARGET_CHUNKS = 1024
SCATTER_MAX_TILES = 1024
SCATTER_SMEM_TILE_ROWS = 8192
SCATTER_SORT_BYTES = 200 * 1024
SCATTER_SORT_DIGIT_BITS = 7
# Row tiles: at least SCATTER_MIN_TILES (one a streaming multiprocessor,
# about), else one per SCATTER_TILE_PRODUCTS expected products
# (row_tiles); the most blocks a chunked pass launches (they walk the
# chunks grid-stride).
SCATTER_MIN_TILES = 128
SCATTER_TILE_PRODUCTS = 16384
SCATTER_MAX_GRID = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int


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
    ``col_len_np`` keeps a host copy of the lengths (the JAX package's
    field) and ``top_len_np`` the sums of the k longest columns, which
    :func:`scatter_plan` reads once per x-nnz bucket; no request reads
    either.
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


def rank_ordered_sum(y: torch.Tensor, rows: torch.Tensor,
                     prods: torch.Tensor) -> torch.Tensor:
    """Add ``prods[t]`` to ``y[rows[t]]`` in stream order per row, in place:
    a stable sort by row, each product's rank within its row, then one
    ``index_add_`` per rank, ascending, over that rank's products.  No row
    takes two adds in one call, so an atomic ``index_add_`` (a card's)
    adds each row left to right from its current value, every run.  About
    max k_i launches, each over its own products only."""
    if rows.numel() == 0:
        return y
    key, order = torch.sort(rows.long(), stable=True)
    p = prods[order]
    first = torch.searchsorted(key, key)  # each product's row starts here
    rank = torch.arange(key.numel(), device=key.device) - first
    by_rank = torch.argsort(rank, stable=True)
    key, p = key[by_rank], p[by_rank]
    start = 0
    for size in torch.bincount(rank).tolist():
        y.index_add_(0, key[start:start + size], p[start:start + size])
        start += size
    return y


def spmspv_scatter_plain(prep: dict, xi: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: T from ``col_len[xi]`` (read
    back to the host on a card), :func:`expand_products` into the work
    bucket, then the first T products (the padded tail is never added)
    into a zero y, each row in stream order: one ``index_add_`` on the CPU,
    :func:`rank_ordered_sum` on a card."""
    m, _ = prep["shape"]
    total = int(prep["col_len"][xi.long()].sum())
    rows, prods = expand_products(prep, xi, xv, work_bucket(total, prep["nnz"]))
    y = torch.zeros(m, dtype=prods.dtype, device=prods.device)
    if y.device.type == "cpu":
        return y.index_add_(0, rows[:total], prods[:total])
    return rank_ordered_sum(y, rows[:total], prods[:total])


def chunk_shift(total: int, max_shift: int) -> int:
    """log2 of the products a chunk takes for T = ``total``: the smallest of
    2**8 .. 2**``max_shift`` that leaves at most ``SCATTER_TARGET_CHUNKS``
    chunks (the device's rule, csrc/spmspv_scatter.cu: chunk_shift)."""
    cs = SCATTER_GRAIN.bit_length() - 1
    while cs < max_shift and -(-int(total) >> cs) > SCATTER_TARGET_CHUNKS:
        cs += 1
    return cs


def sort_cap(shift: int) -> int:
    """Products a row tile of 2**shift rows sorts in shared memory: what
    ``SCATTER_SORT_BYTES`` leaves beside its row counts, 8 bytes a product,
    in whole warps (csrc: sort_cap)."""
    return (SCATTER_SORT_BYTES - (4 << int(shift))) // 8 // 32 * 32


def row_tiles(m: int, expected: int) -> tuple[int, int]:
    """The kernel's row tiles for an m-row y (m < 2**31) and an expected
    ``expected`` products: (shift, n_tiles), n_tiles = ceil(m / 2**shift)
    tiles of 2**shift rows.  Tiles of 32 to ``SCATTER_SMEM_TILE_ROWS`` rows
    (sorted by row in their block), as large as leaves at least
    ``SCATTER_MIN_TILES`` tiles, or one per ``SCATTER_TILE_PRODUCTS``
    expected products where that is more; where m needs more than
    ``SCATTER_MAX_TILES`` of the largest, ``SCATTER_MAX_TILES`` tiles at
    most of as many rows as it takes (summed in y itself).  Large tiles
    keep the place pass's runs long (T / (chunks x tiles) products)."""
    smem_shift = SCATTER_SMEM_TILE_ROWS.bit_length() - 1
    want = max(SCATTER_MIN_TILES, -(-int(expected) // SCATTER_TILE_PRODUCTS))
    shift = 5
    while shift < smem_shift and (want << shift) < m:
        shift += 1
    while (SCATTER_MAX_TILES << shift) < m:
        shift += 1
    return shift, -(-int(m) >> shift)


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """The launch shapes of one (operator, x-nnz bucket): y's ``m`` rows,
    ``B`` x slots, ``t_max`` products at most (the B longest columns),
    chunks of at most 2**``chunk_shift`` products and at most ``n_chunks``
    of them over ``grid`` blocks, ``n_tiles`` row tiles of 2**``shift``
    rows.  ``flag_words`` and ``scratch_words`` size the int32 buffers."""

    m: int
    B: int
    t_max: int
    chunk_shift: int
    shift: int
    n_tiles: int
    n_chunks: int
    grid: int

    @property
    def scan_blocks(self) -> int:
        return -(-self.B // SCATTER_SCAN_SLOTS)

    @property
    def flag_words(self) -> int:
        """The offsets pass's look-back words (2 a block) and two tickets."""
        return 2 * self.scan_blocks + 2

    @property
    def sorts_in_scratch(self) -> bool:
        """Whether a tile's bucket can pass :func:`sort_cap`, so the sum
        pass sorts it in global scratch (csrc: sorts_in_scratch)."""
        smem_shift = SCATTER_SMEM_TILE_ROWS.bit_length() - 1
        return self.shift <= smem_shift and self.t_max > sort_cap(self.shift)

    @property
    def scratch_words(self) -> int:
        """offs, base, firsts, counts, tot, tile_start, the bucket rows and
        products, then (:attr:`sorts_in_scratch`) the sort's permutation and
        sorted products (csrc: the launch's note)."""
        return (2 * self.B + 1 + self.t_max // SCATTER_GRAIN + 1
                + self.n_chunks * self.n_tiles + 2 * self.n_tiles + 1
                + (4 if self.sorts_in_scratch else 2) * self.t_max)


def scatter_plan(prep: dict, B: int, slab: int = 4096) -> ScatterPlan:
    """The kernel's launch shapes for B x slots on ``prep``'s operator, from
    what the host knows: t_max = the sum of the B longest columns
    (``top_len_np``), so any B distinct columns give T <= t_max; chunks of
    at most ``slab`` products (a power of two in 256 .. 4096); the row
    tiles of :func:`row_tiles` for the expected T = B * nnz / n, capped at
    t_max.  The chunk count is the most any T <= t_max splits into."""
    m, n = prep["shape"]
    B = int(B)
    if B < 1:
        raise ValueError(f"an x-nnz bucket of {B} slots: the kernel takes B >= 1")
    t_max = int(prep["top_len_np"][min(B, n)])
    cs = min(max(int(slab).bit_length() - 1, SCATTER_GRAIN.bit_length() - 1),
             SCATTER_MAX_CHUNK.bit_length() - 1)
    expected = min(t_max, B * int(prep["nnz"]) // max(int(n), 1))
    shift, n_tiles = row_tiles(m, expected)
    n_chunks = min(-(-t_max // SCATTER_GRAIN),
                   max(SCATTER_TARGET_CHUNKS, -(-t_max >> cs)))
    return ScatterPlan(m=int(m), B=B, t_max=t_max, chunk_shift=cs, shift=shift,
                       n_tiles=n_tiles, n_chunks=n_chunks,
                       grid=max(1, min(n_chunks, SCATTER_MAX_GRID)))


def spmspv_scatter(
    prep: dict,  # spmspv_prepare's CSC view
    xi: torch.Tensor,  # (B,) int32 x slots (sentinel n = padding)
    xv: torch.Tensor,  # (B,) float32
    flags: torch.Tensor,  # (plan.flag_words,) int32, zero, 8-byte aligned
    plan: ScatterPlan,  # scatter_plan(prep, B)
) -> torch.Tensor:
    """y (m,) = A @ x for the padded sparse x (xi, xv), each row summed in
    stream order (the module's note).  ``xi`` must hold distinct columns
    (:func:`validate_sparse_rhs`): a T above ``plan.t_max`` gives NaN rows.

    On a card one C call launches the ``SCATTER_LAUNCHES`` passes in order
    on the current stream, checking each launch right after it, into one
    scratch tensor taken with ``torch.empty``; nothing waits on a device
    value.  ``flags`` come zero (:class:`SparseStager` copies them with xi
    and xv) and the passes leave them zero, so staged operands launch
    again.  Each launched pass counts once as ``spmspv_scatter``, and a
    refused one raises, naming it.  On CPU tensors the plain version runs.
    Under grad, with ``xv`` or A's values requiring grad, it raises on
    either device (``_build.refuse_autograd``): the kernel has no
    backward."""
    B = plan.B
    m, _ = prep["shape"]
    if (xi.dim() != 1 or tuple(xi.shape) != (B,) or tuple(xv.shape) != (B,)
            or tuple(flags.shape) != (plan.flag_words,)):
        raise ValueError(
            f"xi {tuple(xi.shape)}, xv {tuple(xv.shape)} and flags "
            f"{tuple(flags.shape)} must be ({B},), ({B},) and ({plan.flag_words},) "
            "for this plan (stage_sparse)"
        )
    if plan.m != m:
        raise ValueError(f"a plan for {plan.m} rows on a {m}-row operator (scatter_plan)")
    _build.refuse_autograd("spmspv_scatter", prep["vals"], xv)
    if xv.device.type == "cpu":
        return spmspv_scatter_plain(prep, xi, xv)
    dev = xv.device
    for t, name, dtype, align in (
            (xi, "xi", torch.int32, 0), (xv, "xv", torch.float32, 0),
            (flags, "flags", torch.int32, 8),
            (prep["col_start"], "col_start", torch.int32, 0),
            (prep["col_len"], "col_len", torch.int32, 0),
            (prep["rows"], "rows", torch.int32, 0),
            (prep["vals"], "vals", torch.float32, 0)):
        _build.expect(t, name, dtype, dev, 1, align=align)
    scratch = torch.empty(plan.scratch_words, dtype=torch.int32, device=dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)  # the sum pass writes every row
    fn = _build.function("spmspv_scatter", "spmspv_scatter_launch",
                         [_P] * 9 + [_I] * 8 + [_P, _P])
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        code = fn(prep["col_start"].data_ptr(), prep["col_len"].data_ptr(),
                  prep["rows"].data_ptr(), prep["vals"].data_ptr(), xi.data_ptr(),
                  xv.data_ptr(), flags.data_ptr(), scratch.data_ptr(), y.data_ptr(),
                  m, B, plan.t_max, plan.chunk_shift, plan.shift, plan.n_tiles,
                  plan.grid, plan.n_chunks, ctypes.byref(launched), _build.stream(dev))
    for _ in range(launched.value):  # each launch checked in C right after it
        _build.count("spmspv_scatter")
    _build.check("spmspv_scatter", code, "spmspv_scatter launch, "
                 f"{SCATTER_PASSES[min(launched.value, SCATTER_LAUNCHES - 1)]} pass")
    return y


class SparseStager:
    """A request's host half for one (operator, plan): the padded x slots
    (clipped to [0, n]) and values, after ``plan.flag_words`` zero words,
    written into a pinned host buffer and sent in one host-to-device copy
    on the current stream.  A ring of ``depth`` pinned buffers is reused;
    a buffer is written again only once the event recorded after its last
    copy has fired (an engine keeps up to two requests in flight).  Returns
    ``{"flags", "xi", "xv"}``, views of one device tensor.  On the CPU the
    buffer is a fresh tensor.  Thread-safe: an engine's repair probe may
    stage beside its serving thread."""

    def __init__(self, prep: dict, plan: ScatterPlan, depth: int = 4):
        self.plan, self.n = plan, int(prep["shape"][1])
        self.device = prep["rows"].device
        self.words = plan.flag_words + 2 * plan.B
        self.depth = int(depth)
        self._ring: list = []  # [pinned tensor, its numpy view, event]
        self._next = 0
        self._lock = threading.Lock()

    def _slot(self):
        if len(self._ring) < self.depth:
            host = torch.zeros(self.words, dtype=torch.int32, pin_memory=True)
            self._ring.append([host, host.numpy(), torch.cuda.Event(), False])
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self.depth
        if slot[3]:
            slot[2].synchronize()  # its last copy has left the buffer
        return slot

    def __call__(self, xi, xv) -> dict:
        Z, B = self.plan.flag_words, self.plan.B
        with self._lock:
            cpu = self.device.type == "cpu"
            if cpu:
                dev = torch.zeros(self.words, dtype=torch.int32)
                buf = dev.numpy()
            else:
                slot = self._slot()
                buf = slot[1]
            np.clip(np.asarray(xi), 0, self.n, out=buf[Z:Z + B], casting="unsafe")
            buf[Z + B:].view(np.float32)[:] = np.asarray(xv, dtype=np.float32)
            if not cpu:
                dev = torch.empty(self.words, dtype=torch.int32, device=self.device)
                dev.copy_(slot[0], non_blocking=True)
                slot[2].record(torch.cuda.current_stream(self.device))
                slot[3] = True
        return {"flags": dev[:Z], "xi": dev[Z:Z + B],
                "xv": dev[Z + B:].view(torch.float32)}


def stage_sparse(prep: dict, xi, xv, *, plan: ScatterPlan | None = None,
                 slab: int = 4096) -> dict:
    """One padded sparse x given as HOST arrays staged for
    :func:`spmspv_scatter`: ``flags``, ``xi`` and ``xv`` on the prep's
    device (one copy) and the ``plan`` (:func:`scatter_plan` of its length
    unless given)."""
    if plan is None:
        plan = scatter_plan(prep, int(np.shape(xi)[0]), slab)
    return {**SparseStager(prep, plan, depth=1)(xi, xv), "plan": plan}


def spmspv_bind(prep: dict, x_nnz: int, *, impl: str = "ref", slab: int = 4096):
    """Bind ``fn((xi, xv)) -> y`` over padded (x_nnz,) HOST operands.

    The plan (:func:`scatter_plan`) and the pinned staging ring
    (:class:`SparseStager`) are made here, once; per call the host checks
    the shape, returns zeros without a launch for an x with no nonzero
    (slot 0 is the sentinel), and makes the one copy of xi and xv.
    ``impl="cuda"`` runs the kernel (``SCATTER_LAUNCHES`` launches; ``slab``
    caps the products a chunk takes), ``impl="ref"`` the plain version.
    The slots must be distinct columns, ascending, as
    :func:`validate_sparse_rhs` leaves them (``apply_sparse`` and
    ``submit_sparse`` validate before they pad); the runner does not check
    them again.  Repeated columns can pass the bucket's ``t_max``, and the
    kernel then answers NaN in every row where the plain version sums them.
    """
    if impl not in ("ref", "cuda"):
        raise ValueError(f"unknown spmspv impl {impl!r}: ref or cuda")
    bucket = int(x_nnz)
    plan = scatter_plan(prep, bucket, slab)
    stage = SparseStager(prep, plan)
    m, n = prep["shape"]
    device = prep["rows"].device

    def fn(sx):
        xi, xv = sx
        if np.shape(xi) != (bucket,):
            raise ValueError(
                f"sparse operand has shape {np.shape(xi)}; this runner takes "
                f"({bucket},) padded slots (pad_sparse_rhs)"
            )
        if int(xi[0]) >= n:  # padding only: no product
            return torch.zeros(m, dtype=torch.float32, device=device)
        op = stage(xi, xv)
        if impl == "cuda":
            return spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], plan)
        return spmspv_scatter_plain(prep, op["xi"], op["xv"])

    return fn

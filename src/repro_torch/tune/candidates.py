"""Candidate enumeration and the byte-model cost estimate that prunes it.

A *candidate* is one (format, impl, params) point of the cross-product the
paper sweeps by hand: CSR scalar/vector (Fig 4's -O1/-O3 tiers),
SELL-C-sigma with sigma in {1, 64, 256} and resident vs column-slabbed x
(Fig 5 / cache blocking), BCSR with the Table 2 block shapes, the
nnz-balanced merge tier (``kernels/merge_spmv``), for a sparse x the
bucket SpMSpV tier, and on request RCM-reordered variants of each (paper
§4.4).  On a device mesh the space is the collective schedules instead
(``fmt="dist"``, impl ``allgather`` or ``ring``).  The impl ``cuda`` names
the hand-written kernels; ``ref``, ``vector``, ``scalar`` and ``scan`` the
plain torch tiers.  Keys match the JAX package's with ``pallas`` renamed,
e.g. ``sell/cuda[C=8,chunk_tile=8,sigma=64]``.

Pruning happens *before* any format is materialized or timed, from the
paper's §4.2 application-bytes model per format, scaled by an impl penalty:
the scalar tier has no vector work (Fig 4: about an order of magnitude),
and a ``cuda`` candidate on a CPU device runs its kernel's plain version;
the model prices both out so the measured search skips them.  Candidates
costlier than ``prune_factor`` x the cheapest estimate are dropped untimed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

import numpy as np

from repro_torch.core.distributed import SCHEDULES
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.metrics import sorted_unique, spmm_app_bytes, spmv_app_bytes
from repro_torch.kernels.ops import ONCHIP_BUDGET_BYTES

from .features import MatrixFeatures

__all__ = [
    "Candidate",
    "make",
    "split_reorder",
    "enumerate_candidates",
    "enumerate_mesh_candidates",
    "estimate_cost",
    "prune",
    "sell_padded_slots",
    "bcsr_block_count",
    "DEFAULT_PRUNE_FACTOR",
    "SELL_SIGMAS",
    "BCSR_BLOCKS",
    "CHUNK_TILES",
    "MERGE_CHUNKS",
    "REORDER_METHODS",
    "RING_STEP_OVERHEAD_BYTES",
    "SCHEDULES",
    "SOLVER_STEP_AMORTIZE",
    "SOLVER_VEC_PASSES",
]

SELL_SIGMAS = (1, 64, 256)
BCSR_BLOCKS = ((8, 8), (8, 16), (8, 128))  # Table 2's shapes, as the JAX package
CHUNK_TILES = (8, 16)  # launch shapes of the SELL kernel
MERGE_CHUNKS = (2048, 16384)  # equal-nnz grains for the merge tier
DEFAULT_PRUNE_FACTOR = 3.0
REORDER_METHODS = ("rcm",)  # paper §4.4; opt-in via enumerate(reorders=...)

# The unvectorized -O1 tier (paper Fig 4); same value as the JAX package's.
SCALAR_SLOWDOWN = 32.0

# A cuda candidate on a CPU device runs its kernel's plain torch version,
# which is never the fastest way there; the penalty keeps it out of the
# measured search (on the card the penalty is 1.0 and kernels compete on
# bytes).  Same value as the JAX package's interpret-mode penalty.
CPU_KERNEL_SLOWDOWN = 256.0

# Fixed dispatch/launch latency in equivalent bytes.  Small problems are
# overhead-bound, where the byte streams cannot separate candidates; the
# constant makes their estimates near-tied, so pruning keeps them all and
# the measured search decides.
OVERHEAD_BYTES = 4 * 1024 * 1024

# Per-rotation cost of the ring schedule in equivalent bytes: each of its P
# steps is a slab move and one slab product, where allgather pays one
# gather; in return the ring overlaps a step's move with the product (the
# model's view; shards that share one card run one after another).
RING_STEP_OVERHEAD_BYTES = 512 * 1024

# Row-imbalance penalty for the row-parallel CSR tier: its effective
# throughput degrades with the nnz/row dispersion (capped, so one
# pathological row cannot price out a whole tier before measurement).
ROW_IMBALANCE_WEIGHT = 0.5
ROW_IMBALANCE_CV_CAP = 4.0

# The solver-step byte model (kind="solver_step", runtime/solver.py): inside
# an iterative solver x is produced and consumed on the device between
# iterations, so the dispatch constant is shared by many steps (the port
# enqueues a block of iterations per host sync; the value is the JAX
# package's, for parity), and each step adds about SOLVER_VEC_PASSES passes
# over an m-vector per column for its axpys and dot reductions.
SOLVER_STEP_AMORTIZE = 64.0
SOLVER_VEC_PASSES = 6


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space; params is a sorted tuple of pairs so
    the dataclass stays hashable."""

    fmt: str  # csr | merge | sell | sell_blocked | bcsr | spmspv | dist
    impl: str  # scalar | vector | scan | ref | cuda; for dist allgather | ring
    params: tuple = ()

    @property
    def param_dict(self) -> dict[str, Any]:
        return dict(self.params)

    def key(self) -> str:
        if not self.params:
            return f"{self.fmt}/{self.impl}"
        inner = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.fmt}/{self.impl}[{inner}]"


def make(fmt: str, impl: str, **params: Any) -> Candidate:
    norm = tuple(
        sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in params.items())
    )
    return Candidate(fmt, impl, norm)


def split_reorder(cand: Candidate) -> tuple[str | None, Candidate]:
    """(reorder method, candidate without the reorder param).

    Reordering is orthogonal to the format/impl choice, so it rides along
    as a ``reorder=<method>`` param; prepare and the runner strip it here
    and wrap the base candidate in the permutation."""
    p = cand.param_dict
    method = p.pop("reorder", None)
    if method is None:
        return None, cand
    return str(method), make(cand.fmt, cand.impl, **p)


def enumerate_candidates(
    feats: MatrixFeatures,
    kind: str = "spmv",
    *,
    k: int = 1,
    merge_chunks: Iterable[int] = MERGE_CHUNKS,
    include_scalar: bool = True,
    reorders: Iterable[str] = (),
) -> list[Candidate]:
    """The format x impl x params cross-product for one matrix.

    The SELL kernel and the scalar tier exist for SpMV (kind="spmv") only;
    the merge tier for every kind.  Column-slabbed SELL is enumerated, as
    in the JAX package, only for kind="spmm" when x exceeds the on-chip
    budget, although both of its runners serve k = 1 only — there they
    fail every SpMM search (recorded in ``SparseOperator.search_failures``).

    ``kind="solver_step"`` (the iterative solvers' plans) is the SpMV
    space without the scalar tier at ``k == 1`` and the SpMM space at
    ``k > 1``: the same kernels, but priced by ``estimate_cost(fused=True)``
    and (on the CPU) timed on the solver-step probe, so their plans are a
    cache kind of their own.

    ``kind="spmspv"`` (a sparse x) is the SpMV space without the scalar
    tier and without reorders, every tier timed through a densify wrapper,
    plus the bucket SpMSpV tier, so the dense-versus-sparse crossover is
    measured on one operand.

    ``reorders`` (e.g. ``("rcm",)``) adds a permuted variant of every
    candidate but the scalar tier, for square matrices only.
    """
    if kind == "solver_step":
        kind = "spmv" if int(k) == 1 else "spmm"
        include_scalar = False
    if kind == "spmspv":
        return enumerate_candidates(
            feats, "spmv", merge_chunks=merge_chunks, include_scalar=False,
        ) + [make("spmspv", "ref"), make("spmspv", "cuda", slab=4096)]
    cands: list[Candidate] = [make("csr", "vector")]
    cands.extend(make("merge", "scan", chunk=int(c)) for c in merge_chunks)
    if kind == "spmv":
        if include_scalar:
            cands.append(make("csr", "scalar"))
        for sigma in SELL_SIGMAS:
            cands.append(make("sell", "ref", C=8, sigma=sigma))
            for ct in CHUNK_TILES:
                cands.append(make("sell", "cuda", C=8, sigma=sigma, chunk_tile=ct))
    elif kind == "spmm":
        for sigma in SELL_SIGMAS:
            cands.append(make("sell", "ref", C=8, sigma=sigma))
        if not feats.x_fits_vmem:
            n_slabs = max(2, -(-feats.x_bytes // ONCHIP_BUDGET_BYTES))
            for sigma in SELL_SIGMAS:
                cands.append(
                    make("sell_blocked", "ref", C=8, sigma=sigma, n_slabs=n_slabs)
                )
                cands.append(
                    make("sell_blocked", "cuda", C=8, sigma=sigma,
                         n_slabs=n_slabs, chunk_tile=8)
                )
    else:
        raise ValueError(
            f"unknown kind {kind!r}: this port tunes spmv, spmm, spmspv and "
            "solver_step"
        )
    for block in BCSR_BLOCKS:
        cands.append(make("bcsr", "ref", block=block))
        cands.append(make("bcsr", "cuda", block=block))
    if reorders and feats.m == feats.n:
        base = [c for c in cands if c.impl != "scalar"]
        for method in reorders:
            cands.extend(
                make(c.fmt, c.impl, reorder=method, **c.param_dict) for c in base
            )
    return cands


def enumerate_mesh_candidates(
    feats: MatrixFeatures,
    n_shards: int,
    *,
    schedules: Iterable[str] = SCHEDULES,
) -> list[Candidate]:
    """The search space on a device mesh: one candidate per collective
    schedule (``fmt="dist"``, impl names the schedule).  Every shard runs
    the local CSR product; the open question is how x reaches each shard
    (the paper's "input vector distribution" note)."""
    del feats  # the same space for every matrix, as in the JAX package
    return [make("dist", s, n_shards=int(n_shards)) for s in schedules]


# ---------------------------------------------------------------------------
# Byte-model cost estimate (paper §4.2, generalized per format)
# ---------------------------------------------------------------------------
def sell_padded_slots(
    lengths: np.ndarray, C: int, sigma: int, width_align: int = 8
) -> int:
    """Stored slots (incl. padding) of sell_from_csr for these row lengths."""
    m = lengths.size
    if m == 0:
        return 0
    window = np.arange(m) // sigma
    sorted_len = lengths[np.lexsort((-lengths, window))]
    n_chunks = -(-m // C)
    padded = np.zeros(n_chunks * C, dtype=np.int64)
    padded[:m] = sorted_len
    W = int(max(padded.reshape(n_chunks, C).max(axis=1).max(initial=1), 1))
    if width_align > 1:
        W = -(-W // width_align) * width_align
    return n_chunks * C * W


def bcsr_block_count(a: CSRMatrix, block: tuple[int, int]) -> int:
    """Number of occupied (bm, bk) blocks — no block materialization."""
    if a.nnz == 0:
        return 0
    bm, bk = block
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(a.indptr))
    gn = -(-a.shape[1] // bk)
    key = (rows // bm) * gn + a.indices.astype(np.int64) // bk
    return int(sorted_unique(key).size)


def estimate_cost(
    a: CSRMatrix,
    cand: Candidate,
    feats: MatrixFeatures,
    *,
    k: int = 1,
    val_bytes: int = 4,
    idx_bytes: int = 4,
    on_cpu: bool = False,
    fused: bool = False,
    sparse_rhs: bool = False,
) -> float:
    """Abstract cost (bytes x impl slowdown) of running this candidate.

    Only relative magnitudes matter: prune() compares candidates against
    the cheapest estimate for the same matrix.  ``on_cpu`` says the
    candidates run on a CPU device.  ``fused`` prices one solver step
    (kind="solver_step"): the dispatch constant divided by
    :data:`SOLVER_STEP_AMORTIZE`, plus :data:`SOLVER_VEC_PASSES` m-vector
    passes per column for the step's axpys and dots.  ``sparse_rhs``
    prices serving a sparse x: the spmspv tier pays for the touched
    columns only (scaled by ``feats.x_density``), every dense tier for one
    extra densify pass.
    """
    m, n = a.shape
    method, base = split_reorder(cand)
    if method is not None:
        # Estimated on the original structure, plus the x gather and y
        # scatter of the permutation at the boundary.
        perm_bytes = (m + n) * (k * val_bytes + idx_bytes)
        return estimate_cost(
            a, base, feats, k=k, val_bytes=val_bytes, idx_bytes=idx_bytes,
            on_cpu=on_cpu, fused=fused, sparse_rhs=sparse_rhs,
        ) + perm_bytes
    p = cand.param_dict
    if cand.fmt == "spmspv":
        # The CSC gather of the touched (row, value) pairs, the product
        # stream's write and scatter read-back, the x coordinates with their
        # column-table lookups, and y.
        density = min(max(float(feats.x_density), 0.0), 1.0)
        touched = density * float(a.nnz)
        bytes_ = (
            3.0 * touched * (val_bytes + idx_bytes)
            + density * n * (2 * idx_bytes + val_bytes)
            + m * val_bytes
        )
    elif cand.fmt == "csr":
        bytes_ = (
            spmv_app_bytes(m, n, a.nnz, val_bytes, idx_bytes)
            if k == 1
            else spmm_app_bytes(m, n, a.nnz, k, val_bytes, idx_bytes)
        )
        cv = min(float(feats.nnz_row_cv), ROW_IMBALANCE_CV_CAP)
        bytes_ = bytes_ * (1.0 + ROW_IMBALANCE_WEIGHT * cv)
    elif cand.fmt == "merge":
        # Padded product stream in, the two-level scan (one more pass over
        # the products), two prefix-table gathers per row; no term depends
        # on the row distribution.
        chunk = max(1, int(p["chunk"]))
        nnz_pad = max(1, -(-a.nnz // chunk)) * chunk
        bytes_ = (
            nnz_pad * (val_bytes + idx_bytes)  # data + indices streams
            + n * k * val_bytes  # x gather
            + 2 * nnz_pad * k * val_bytes  # scan write + gather-back
            + m * (2 * idx_bytes + k * val_bytes)  # start/end + y out
        )
    elif cand.fmt in ("sell", "sell_blocked"):
        lengths = np.diff(a.indptr).astype(np.int64)
        slots = sell_padded_slots(lengths, int(p["C"]), int(p["sigma"]))
        bytes_ = (
            slots * (val_bytes + idx_bytes)  # padded cols+vals streams
            + (m + n) * k * val_bytes  # x in, y out
            + m * idx_bytes  # row_perm
        )
        if cand.fmt == "sell_blocked":
            # Slab splitting re-pads each slab to its own width.
            bytes_ = int(bytes_ * 1.15)
    elif cand.fmt == "bcsr":
        bm, bk = p["block"]
        n_blocks = bcsr_block_count(a, (int(bm), int(bk)))
        bytes_ = (
            n_blocks * (bm * bk * val_bytes + 2 * idx_bytes)  # fill-in stored
            + (m + n) * k * val_bytes
        )
    elif cand.fmt == "dist":
        # Per-shard stream bytes plus the traffic that makes x visible to
        # every shard: (P-1)/P |x| per shard under both schedules; allgather
        # pays it before the product, the ring overlaps it with the slab
        # products at the price of P steps.
        P = max(1, int(p["n_shards"]))
        local = (
            spmv_app_bytes(m, n, a.nnz, val_bytes, idx_bytes)
            if k == 1
            else spmm_app_bytes(m, n, a.nnz, k, val_bytes, idx_bytes)
        ) / P
        collective = (P - 1) / P * n * k * val_bytes
        if cand.impl == "allgather":
            bytes_ = local + collective
        elif cand.impl == "ring":
            bytes_ = max(local, collective) + P * RING_STEP_OVERHEAD_BYTES
        else:
            raise ValueError(f"unknown schedule impl: {cand.impl}")
    else:
        raise ValueError(f"unknown candidate format: {cand.fmt}")
    if sparse_rhs and cand.fmt != "spmspv":
        bytes_ = float(bytes_) + n * val_bytes  # densify x first
    slowdown = 1.0
    if cand.impl == "scalar":
        slowdown = SCALAR_SLOWDOWN
    elif cand.impl == "cuda" and on_cpu:
        slowdown = CPU_KERNEL_SLOWDOWN
    overhead = OVERHEAD_BYTES
    if fused:
        overhead = OVERHEAD_BYTES / SOLVER_STEP_AMORTIZE
        bytes_ = float(bytes_) + SOLVER_VEC_PASSES * m * k * val_bytes
    cost = (float(bytes_) + overhead) * slowdown
    if not math.isfinite(cost):
        return math.inf  # NaN would lose every comparison silently
    return cost


def prune(
    costs: dict[Candidate, float], factor: float = DEFAULT_PRUNE_FACTOR
) -> list[Candidate]:
    """Keep candidates within ``factor`` of the cheapest estimate.

    The cheapest candidate always survives.  Non-finite estimates never
    rank: when every estimate is non-finite the tuner falls back to ONE
    deterministic default — csr/vector when enumerated, else the first.
    """
    if not costs:
        return []
    finite = {c: est for c, est in costs.items() if math.isfinite(est)}
    if not finite:
        for c in costs:
            if c.fmt == "csr" and c.impl == "vector":
                return [c]
        return [next(iter(costs))]
    best = min(finite.values())
    return [c for c, est in finite.items() if est <= factor * best]

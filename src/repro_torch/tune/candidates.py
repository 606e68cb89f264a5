"""Candidate enumeration and the byte-model cost estimate that prunes it.

A *candidate* is one (format, impl, params) point of the cross-product the
paper sweeps by hand: CSR gather + row sum (Fig 4's vectorized tier),
SELL-C-sigma with sigma in {1, 64, 256} and resident vs column-slabbed x
(Fig 5 / cache blocking), BCSR with the Table 2 block shapes, and for a
sparse x the bucket SpMSpV tier.  The impl ``cuda`` names the hand-written
kernels; ``ref`` and ``vector`` the plain torch tiers.  Keys match the JAX package's with ``pallas`` renamed,
e.g. ``sell/cuda[C=8,chunk_tile=8,sigma=64]``.

Pruning happens *before* any format is materialized or timed, from the
paper's §4.2 application-bytes model per format, scaled by an impl penalty:
a ``cuda`` candidate on a CPU device runs its kernel's plain version,
which the model prices out so the measured search skips it.  Candidates
costlier than ``prune_factor`` x the cheapest estimate are dropped untimed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core.formats import CSRMatrix
from repro_torch.core.metrics import sorted_unique, spmm_app_bytes, spmv_app_bytes
from repro_torch.kernels.ops import ONCHIP_BUDGET_BYTES

from .features import MatrixFeatures

__all__ = [
    "Candidate",
    "make",
    "enumerate_candidates",
    "estimate_cost",
    "prune",
    "sell_padded_slots",
    "bcsr_block_count",
    "DEFAULT_PRUNE_FACTOR",
    "SELL_SIGMAS",
    "BCSR_BLOCKS",
    "CHUNK_TILES",
]

SELL_SIGMAS = (1, 64, 256)
BCSR_BLOCKS = ((8, 8), (8, 16), (8, 128))  # Table 2's shapes, as the JAX package
CHUNK_TILES = (8, 16)  # launch shapes of the SELL kernel
DEFAULT_PRUNE_FACTOR = 3.0

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

# Row-imbalance penalty for the row-parallel CSR tier: its effective
# throughput degrades with the nnz/row dispersion (capped, so one
# pathological row cannot price out a whole tier before measurement).
ROW_IMBALANCE_WEIGHT = 0.5
ROW_IMBALANCE_CV_CAP = 4.0


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space; params is a sorted tuple of pairs so
    the dataclass stays hashable."""

    fmt: str  # csr | sell | sell_blocked | bcsr | spmspv
    impl: str  # vector | ref | cuda
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


def enumerate_candidates(
    feats: MatrixFeatures,
    kind: str = "spmv",
    *,
    k: int = 1,
) -> list[Candidate]:
    """The format x impl x params cross-product for one matrix.

    The SELL kernel exists for SpMV (kind="spmv") only.  Column-slabbed SELL
    is enumerated, as in the JAX package, only for kind="spmm" when x
    exceeds the on-chip budget, although both of its runners serve k = 1
    only — there they fail every SpMM search (recorded in
    ``SparseOperator.search_failures``).

    ``kind="spmspv"`` (a sparse x) is the SpMV space, every tier timed
    through a densify wrapper, plus the bucket SpMSpV tier, so the
    dense-versus-sparse crossover is measured on one operand.
    """
    del k  # the SpMM space does not depend on the width
    if kind == "spmspv":
        return enumerate_candidates(feats, "spmv") + [
            make("spmspv", "ref"),
            make("spmspv", "cuda", slab=4096),
        ]
    cands: list[Candidate] = [make("csr", "vector")]
    if kind == "spmv":
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
            f"unknown kind {kind!r}: this port tunes spmv, spmm and spmspv"
        )
    for block in BCSR_BLOCKS:
        cands.append(make("bcsr", "ref", block=block))
        cands.append(make("bcsr", "cuda", block=block))
    return cands


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
    sparse_rhs: bool = False,
) -> float:
    """Abstract cost (bytes x impl slowdown) of running this candidate.

    Only relative magnitudes matter: prune() compares candidates against
    the cheapest estimate for the same matrix.  ``on_cpu`` says the
    candidates run on a CPU device.  ``sparse_rhs`` prices serving a sparse
    x: the spmspv tier pays for the touched columns only (scaled by
    ``feats.x_density``), every dense tier for one extra densify pass.
    """
    m, n = a.shape
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
    else:
        raise ValueError(f"unknown candidate format: {cand.fmt}")
    if sparse_rhs and cand.fmt != "spmspv":
        bytes_ = float(bytes_) + n * val_bytes  # densify x first
    slowdown = CPU_KERNEL_SLOWDOWN if (cand.impl == "cuda" and on_cpu) else 1.0
    cost = (float(bytes_) + OVERHEAD_BYTES) * slowdown
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

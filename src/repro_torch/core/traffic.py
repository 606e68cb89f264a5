"""Traffic models: the paper's Fig 6 "actual bandwidth" cache analysis.

The paper distributes chunks of 64 rows round-robin over P cores and counts,
per core, the distinct input-vector cachelines touched — once under an
infinite-cache assumption and once under a 512 kB LRU cache.  The headline
findings were (i) actual traffic can be 1.7x application traffic because the
same x-lines are fetched by many private caches, and (ii) the finite cache
almost never adds traffic (no thrashing).

Both counts are reproduced, with the distributed generalization: with the
matrix row-partitioned over N shards and x all-gathered, the "vector
access" multiplier becomes the bytes the shards copy to see x.  The
defaults (61 cores, 64-row chunks, 8-element lines, an LRU of 8192 lines)
are the Xeon Phi's, the paper's model.  Host numpy only; every value
equals the JAX package's for the same matrix.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRMatrix
from .metrics import sorted_unique

__all__ = [
    "vector_lines_per_core",
    "actual_spmv_bytes",
    "vector_access_multiplier",
    "shard_vector_access",
]


def _core_of_rows(m: int, n_cores: int, chunk: int = 64) -> np.ndarray:
    """Round-robin chunks of ``chunk`` rows over cores (paper's model of
    OpenMP dynamic scheduling)."""
    chunk_ids = np.arange(m) // chunk
    return (chunk_ids % n_cores).astype(np.int32)


def vector_lines_per_core(
    a: CSRMatrix,
    n_cores: int = 61,
    chunk: int = 64,
    line_width: int = 8,
    cache_lines: int | None = None,
) -> np.ndarray:
    """Distinct (or LRU-refetched) x cachelines fetched by each core.

    ``cache_lines=None`` -> infinite cache (count distinct lines per core).
    Otherwise simulate an LRU of that many lines over the core's access
    stream (the paper's 512kB/64B = 8192 lines).
    """
    m, _ = a.shape
    core = _core_of_rows(m, n_cores, chunk)
    lengths = np.diff(a.indptr)
    row_of_nnz = np.repeat(np.arange(m, dtype=np.int64), lengths)
    core_of_nnz = core[row_of_nnz]
    lines = (a.indices // line_width).astype(np.int64)
    fetched = np.zeros(n_cores, dtype=np.int64)
    if cache_lines is None:
        for c in range(n_cores):
            fetched[c] = sorted_unique(lines[core_of_nnz == c]).shape[0]
        return fetched
    # LRU simulation per core (dict preserves insertion order).
    for c in range(n_cores):
        stream = lines[core_of_nnz == c]
        lru: dict[int, None] = {}
        misses = 0
        for ln in stream.tolist():
            if ln in lru:
                del lru[ln]
            else:
                misses += 1
                if len(lru) >= cache_lines:
                    lru.pop(next(iter(lru)))
            lru[ln] = None
        fetched[c] = misses
    return fetched


def actual_spmv_bytes(
    a: CSRMatrix,
    n_cores: int = 61,
    chunk: int = 64,
    line_width: int = 8,
    val_bytes: int = 4,
    idx_bytes: int = 4,
    cache_lines: int | None = None,
) -> int:
    """Paper Fig 6 top stacks: matrix+y move once, x moves per-core-distinct."""
    m, n = a.shape
    matrix_bytes = a.nnz * (val_bytes + idx_bytes) + (m + 1) * idx_bytes
    y_bytes = m * val_bytes
    x_lines = int(
        vector_lines_per_core(a, n_cores, chunk, line_width, cache_lines).sum()
    )
    return matrix_bytes + y_bytes + x_lines * line_width * val_bytes


def vector_access_multiplier(
    a: CSRMatrix, n_cores: int = 61, chunk: int = 64, line_width: int = 8
) -> float:
    """Paper Fig 8(c) "Vector Access": x-lines fetched / lines x occupies."""
    _, n = a.shape
    total = int(vector_lines_per_core(a, n_cores, chunk, line_width).sum())
    return total / max(-(-n // line_width), 1)


def shard_vector_access(
    a: CSRMatrix, n_shards: int, val_bytes: int = 4
) -> dict[str, float]:
    """Distributed analogue: row-partitioned A, x all-gathered vs on-demand.

    Returns bytes moved between shards under
      - allgather:  every shard receives all of x  (n * val_bytes * (N-1)/N each)
      - ondemand:   every shard receives only the distinct x entries its rows
                    touch (a perfect software cache / gather collective).
    The ratio is the headroom a smarter x-distribution could buy — the
    multi-device version of the paper's 61-private-caches observation.
    """
    m, n = a.shape
    bounds = np.linspace(0, m, n_shards + 1).astype(np.int64)
    ondemand = 0
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        seg = a.indices[a.indptr[lo] : a.indptr[hi]]
        local = np.arange(lo, hi)  # x entries that live on this shard already
        need = np.setdiff1d(sorted_unique(seg), local, assume_unique=False)
        ondemand += need.shape[0]
    allgather = n_shards * (n - (n // n_shards))
    return {
        "allgather_bytes": float(allgather * val_bytes),
        "ondemand_bytes": float(ondemand * val_bytes),
        "ratio": float(allgather) / max(ondemand, 1),
    }

"""Matrix (re)ordering — the paper's §4.4 densification study.

Reverse Cuthill-McKee (RCM) groups nonzeros near the diagonal, which
raises UCLD and cuts how often x must be re-fetched.  RCM here is a BFS
with degree-sorted neighbour expansion, reversed, over every connected
component — the same algorithm, step for step, as the JAX package's, so
both packages return the same permutation.

Orderings work on the *symmetrized* pattern of A (RCM is defined for
symmetric matrices; the paper's suite is square) and return ``perm``
arrays mapping new index -> old index (see ``CSRMatrix.permuted``).  Host
numpy only.
"""
from __future__ import annotations

import numpy as np

from .formats import CSRMatrix
from .metrics import sorted_unique

__all__ = ["rcm", "degree_order", "random_order", "symmetrize_pattern"]


def symmetrize_pattern(a: CSRMatrix) -> tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) of pattern(A + A^T), without values."""
    m, n = a.shape
    if m != n:
        raise ValueError("orderings are defined for square matrices")
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    key = sorted_unique(np.concatenate([rows * n + cols, cols * n + rows]))
    srows, scols = key // n, key % n
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(srows, minlength=m), out=indptr[1:])
    return indptr, scols.astype(np.int32)


def rcm(a: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (new -> old permutation).

    BFS from a minimum-degree vertex of each connected component,
    expanding neighbours in ascending-degree order (stable), then the
    whole order reversed — the classic algorithm behind MATLAB's
    ``symrcm``, which the paper uses.
    """
    indptr, indices = symmetrize_pattern(a)
    m = a.shape[0]
    degree = np.diff(indptr)
    visited = np.zeros(m, dtype=bool)
    order = np.empty(m, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = [int(seed)]
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            order[pos] = u
            pos += 1
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                queue.extend(nbrs.tolist())
    if pos != m:
        raise RuntimeError(f"RCM visited {pos} of {m} vertices")
    return order[::-1].copy()


def degree_order(a: CSRMatrix, descending: bool = True) -> np.ndarray:
    """Order rows by (symmetrized) degree — a cheap locality baseline."""
    indptr, _ = symmetrize_pattern(a)
    degree = np.diff(indptr)
    return np.argsort(-degree if descending else degree, kind="stable")


def random_order(a: CSRMatrix, seed: int = 0) -> np.ndarray:
    """A seeded random permutation of the rows (scrambles locality)."""
    return np.random.default_rng(seed).permutation(a.shape[0])

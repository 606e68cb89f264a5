"""Transfer tuning: predict a plan for a new fingerprint from the plan cache.

Every measured search persists the features it extracted beside the plan it
picked, so the cache is a labelled dataset of (structure -> winning
candidate).  Matrices of one structural family (banded FEM, power-law
graphs) land on the same winner, so a new fingerprint's plan can be read
off its nearest neighbours instead of measured.  :func:`predict_candidate`:

* embeds the request and every usable cache entry with
  :func:`~repro_torch.tune.features.feature_vector` (same kind, same k, same
  backend: a plan timed on one card model does not transfer to another;
  same mesh shape: a collective schedule does not serve one device);
* normalises each dimension by its spread over the pool and takes the RMS
  distance;
* serves the nearest neighbour's candidate when it lies within ``radius``
  (a **confident** transfer);
* otherwise falls back to the byte model's argmin over the enumerated
  space, flagged ``confident=False``.

One deviation from the JAX package: off the CPU the byte model prices a
kernel and its plain version alike (``sell/cuda`` and ``sell/ref``,
``bcsr/cuda`` and ``bcsr/ref``), and the plain one is enumerated first, so
an exact cost tie goes to the ``cuda`` candidate there.  A card must not
serve the plain version of a kernel.  On the CPU a kernel carries
``CPU_KERNEL_SLOWDOWN``, so the pick equals the JAX package's.

Predicted plans are served at once and never persisted: only measured
search results enter the cache, so a prediction never trains on itself.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.formats import CSRMatrix

from .candidates import Candidate, enumerate_candidates, estimate_cost
from .features import MatrixFeatures, extract, feature_vector
from .plan import PlanCache

__all__ = ["PREDICT_RADIUS", "Prediction", "byte_model_order", "predict_candidate"]

# Confidence radius in normalised feature space (RMS over dimensions, each
# divided by the pool's spread): within it a same-family neighbour
# transfers its winner; beyond it the byte model is the better prior.
PREDICT_RADIUS = 0.35

# Per-dimension spread floor: a pool with ~zero spread in one dimension
# must not turn a tiny difference into a huge distance.
_SPREAD_FLOOR = 0.05


@dataclasses.dataclass(frozen=True)
class Prediction:
    """One serve-now plan choice and the evidence behind it."""

    candidate: Candidate
    source: str  # neighbour fingerprint, or "byte_model" for the fallback
    distance: float  # normalised feature distance (inf with an empty pool)
    confident: bool  # the nearest neighbour was within the radius
    n_neighbors: int  # usable training points consulted


def byte_model_order(
    a: CSRMatrix, feats: MatrixFeatures, kind: str, k: int, *,
    device: str | torch.device = "cuda",
) -> list[Candidate]:
    """The enumerated space, cheapest byte-model estimate first (the
    ranking the measured search prunes with, minus the measurement).  Off
    the CPU an exact tie goes to the ``cuda`` candidate."""
    on_cpu = torch.device(device).type == "cpu"
    cands = enumerate_candidates(feats, kind, k=k)
    costs = {c: estimate_cost(a, c, feats, k=k, on_cpu=on_cpu) for c in cands}
    if on_cpu:
        return sorted(cands, key=costs.get)
    return sorted(cands, key=lambda c: (costs[c], c.impl != "cuda"))


def _byte_model_argmin(
    a: CSRMatrix, feats: MatrixFeatures, kind: str, k: int, *,
    device: str | torch.device = "cuda",
) -> Candidate:
    """The fallback prior: the first of :func:`byte_model_order`."""
    return byte_model_order(a, feats, kind, k, device=device)[0]


def predict_candidate(
    a: CSRMatrix,
    kind: str,
    k: int,
    cache: PlanCache,
    *,
    feats: MatrixFeatures | None = None,
    backend: str | None = None,
    mesh_shape: Iterable[int] = (),
    exclude: Iterable[str] = (),
    radius: float = PREDICT_RADIUS,
    device: str | torch.device = "cuda",
) -> Prediction:
    """Pick a serve-now candidate for ``a`` without a measured search.

    ``exclude`` drops training fingerprints (leave-one-out, or the
    request's own).  Only plans of ``mesh_shape`` (() = one device) train
    it.  ``device`` only sets the byte model's view (CPU penalties, the
    tie-break toward kernels); no tensor is made, so a CUDA device needs no
    card here.  Always returns a candidate: the byte model is the floor.
    """
    feats = extract(a, k=k) if feats is None else feats
    target = feature_vector(feats)
    mesh_shape = [int(s) for s in mesh_shape]
    exclude = set(exclude)

    pool: list[tuple[str, Candidate, np.ndarray]] = []
    if target is not None:
        for p in cache.plans():
            if p.kind != kind or int(p.k) != int(k):
                continue
            if p.fingerprint in exclude or not p.features:
                continue
            if backend is not None and p.backend != backend:
                continue
            if [int(s) for s in p.mesh_shape] != mesh_shape:
                continue
            vec = feature_vector(p.features)
            if vec is None:
                continue
            try:
                cand = p.candidate
            except Exception:
                continue  # params drifted: unusable as a training point
            pool.append((p.fingerprint, cand, vec))

    dists = None
    if pool:
        mat = np.stack([v for _, _, v in pool])
        both = np.vstack([mat, target[None]])
        spread = np.maximum(
            both.max(axis=0) - both.min(axis=0),
            _SPREAD_FLOOR * (1.0 + np.abs(np.median(both, axis=0))),
        )
        dists = np.sqrt((((mat - target[None]) / spread) ** 2).mean(axis=1))
        i = int(np.argmin(dists))
        if float(dists[i]) <= radius:
            fp_n, cand, _ = pool[i]
            return Prediction(candidate=cand, source=fp_n, distance=float(dists[i]),
                              confident=True, n_neighbors=len(pool))
    return Prediction(
        candidate=_byte_model_argmin(a, feats, kind, k, device=device),
        source="byte_model",
        distance=float("inf") if dists is None else float(np.min(dists)),
        confident=False,
        n_neighbors=len(pool),
    )

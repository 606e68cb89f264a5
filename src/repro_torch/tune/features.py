"""Per-matrix structural features driving candidate enumeration and pruning.

The quantities the paper shows to predict kernel choice: UCLD predicts the
vgatherd/SELL win (Fig 5), nnz/row dispersion drives load balance, and the
x-vector footprint against the on-chip budget decides whether SELL needs
column-slab cache blocking.  All are O(nnz) numpy on the host CSR, and the
names (``x_fits_vmem`` included) match the JAX package's, so feature
vectors from both packages stay comparable.

Plans persist these features beside the winning candidate
(``Plan.features``), so the plan cache doubles as a labelled dataset of
(structure -> winning plan): :mod:`repro_torch.tune.predict` takes the
nearest neighbour over :func:`feature_vector` to transfer a plan to a new
fingerprint without a measured search.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np

from repro_torch.core.formats import CSRMatrix
from repro_torch.core.metrics import matrix_bandwidth, ucld, utd
from repro_torch.kernels.ops import ONCHIP_BUDGET_BYTES

__all__ = ["MatrixFeatures", "extract", "FEATURE_NAMES", "feature_vector"]


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    m: int
    n: int
    nnz: int
    nnz_row_mean: float
    nnz_row_cv: float  # std/mean of nnz per row (load-imbalance proxy)
    ucld: float  # paper Fig 5 predictor
    utd: float  # tile generalization of UCLD
    bandwidth: int  # max |i - j| over nonzeros
    x_bytes: int  # footprint of the dense operand (k columns)
    x_fits_vmem: bool  # x_bytes <= ONCHIP_BUDGET_BYTES (name kept for parity)
    x_density: float = 1.0  # nnz(x)/n; 1.0 for the dense-RHS kinds

    def to_dict(self) -> dict[str, Any]:
        """Plain-python dict, safe for JSON persistence inside a Plan."""
        out: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (bool, np.bool_)):
                out[f.name] = bool(v)
            elif isinstance(v, (int, np.integer)):
                out[f.name] = int(v)
            else:
                out[f.name] = float(v)
        return out


# The embedding the transfer predictor measures distance in.  Sizes enter
# log-scaled (a 2x larger matrix of one family is a near neighbour); the
# O(1) density and dispersion predictors (cv, ucld, utd) enter raw.
FEATURE_NAMES = (
    "log_m",
    "log_n",
    "log_nnz",
    "log_nnz_row_mean",
    "nnz_row_cv",
    "ucld",
    "utd",
    "log_bandwidth",
    "x_fits_vmem",
    "x_density",
)


def feature_vector(feats: "MatrixFeatures | Mapping[str, Any]") -> np.ndarray | None:
    """Embed features (live, or a plan's persisted ``features``) in
    :data:`FEATURE_NAMES` order; None when a required key is missing, so a
    cache entry of another feature schema is skipped, never a crash.  A
    missing ``x_density`` means 1.0: every entry without it was measured
    for a dense x."""
    d = feats.to_dict() if isinstance(feats, MatrixFeatures) else feats
    try:
        return np.array(
            [
                math.log10(max(float(d["m"]), 1.0)),
                math.log10(max(float(d["n"]), 1.0)),
                math.log10(max(float(d["nnz"]), 1.0)),
                math.log10(float(d["nnz_row_mean"]) + 1.0),
                float(d["nnz_row_cv"]),
                float(d["ucld"]),
                float(d["utd"]),
                math.log10(float(d["bandwidth"]) + 1.0),
                1.0 if d["x_fits_vmem"] else 0.0,
                float(d.get("x_density", 1.0)),
            ],
            dtype=np.float64,
        )
    except (KeyError, TypeError, ValueError):
        return None


def extract(
    a: CSRMatrix, *, k: int = 1, val_bytes: int = 4, x_nnz: int | None = None
) -> MatrixFeatures:
    """Structural features; ``x_nnz`` sets the sparse-RHS density axis.
    Degenerate inputs (nnz = 0, m = 0) stay finite, since every consumer
    ranks by these numbers."""
    m, n = a.shape
    lengths = np.diff(a.indptr).astype(np.float64)
    mean = float(lengths.mean()) if m else 0.0
    cv = float(lengths.std() / mean) if mean > 0 else 0.0
    x_bytes = int(n) * int(k) * val_bytes
    x_density = 1.0 if x_nnz is None else min(max(int(x_nnz), 0) / max(int(n), 1), 1.0)
    return MatrixFeatures(
        m=m,
        n=n,
        nnz=a.nnz,
        nnz_row_mean=mean,
        nnz_row_cv=cv,
        ucld=ucld(a),
        utd=utd(a),
        bandwidth=matrix_bandwidth(a),
        x_bytes=x_bytes,
        x_fits_vmem=x_bytes <= ONCHIP_BUDGET_BYTES,
        x_density=x_density,
    )

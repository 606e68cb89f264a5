"""The paper's 22-matrix experiment suite (Table 1), synthesized offline.

The container has no network access to the UFL/SuiteSparse collection, so
each matrix is generated to match Table 1's structural statistics — exact
(#rows); (#nnz, nnz/row, max nnz/row) within a few percent — using a
generator per structural family:

  stencil5    exact 5-point stencil (mesh_2048 is exact by construction)
  banded_fem  clustered band profile typical of FEM/structural matrices
              (cant, pwtk, hood, bmw3_2, msdoor, ldoor, inline_1, ...)
  powerlaw    heavy-tailed degree with a few ultra-dense rows/cols
              (webbase-1M, torso1, crankseg_2's dense column)
  randsparse  near-uniform random pattern (cage14, atmosmodd, 2cubes, ...)
  blockdense  dense clusters -> very high nnz/row (nd24k, pdb1HYS)

Every generator is deterministic in (name, seed).  Diagonals are always
present (the suite matrices are mostly from PDE/FEM/graph settings where the
diagonal exists), values are iid N(0,1) scaled like the paper's double data
but stored f32.  Host arrays are byte-identical to the JAX package's
generators for the same (name, scale, seed).

``SCALE`` trims the row counts for CI-speed: scale=1.0 reproduces Table 1
sizes; benchmarks default to scale≈1/16 so the full suite builds in seconds
on the CPU container while preserving nnz/row and the pattern family (the
metrics the paper's phenomena depend on are per-row/per-tile densities, not
absolute size).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.formats import CSRMatrix, csr_from_coo

__all__ = ["MatrixSpec", "SUITE", "generate", "generate_suite"]


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    idx: int  # the paper's 1..22 numbering (sorted by nnz)
    name: str
    n_rows: int
    nnz: int
    family: str  # generator key
    band: int | None = None  # half bandwidth for banded families
    max_row: int | None = None  # Table 1 "max nnz/r"

    @property
    def nnz_per_row(self) -> float:
        return self.nnz / self.n_rows


# Table 1, in the paper's order (all square).
SUITE: list[MatrixSpec] = [
    MatrixSpec(1, "shallow_water1", 81_920, 204_800, "randsparse", max_row=4),
    MatrixSpec(2, "2cubes_sphere", 101_492, 874_378, "randsparse", max_row=24),
    MatrixSpec(3, "scircuit", 170_998, 958_936, "powerlaw", max_row=353),
    MatrixSpec(4, "mac_econ", 206_500, 1_273_389, "randsparse", max_row=44),
    MatrixSpec(5, "cop20k_A", 121_192, 1_362_087, "randsparse", max_row=24),
    MatrixSpec(6, "cant", 62_451, 2_034_917, "banded_fem", band=200, max_row=40),
    MatrixSpec(7, "pdb1HYS", 36_417, 2_190_591, "blockdense", max_row=184),
    MatrixSpec(8, "webbase-1M", 1_000_005, 3_105_536, "powerlaw", max_row=4700),
    MatrixSpec(9, "hood", 220_542, 5_057_982, "banded_fem", band=800, max_row=51),
    MatrixSpec(10, "bmw3_2", 227_362, 5_757_996, "banded_fem", band=1000, max_row=204),
    MatrixSpec(11, "pre2", 659_033, 5_834_044, "powerlaw", max_row=627),
    MatrixSpec(12, "pwtk", 217_918, 5_871_175, "banded_fem", band=700, max_row=180),
    MatrixSpec(13, "crankseg_2", 63_838, 7_106_348, "blockdense", max_row=297),
    MatrixSpec(14, "torso1", 116_158, 8_516_500, "powerlaw", max_row=3263),
    MatrixSpec(15, "atmosmodd", 1_270_432, 8_814_880, "randsparse", max_row=7),
    MatrixSpec(16, "msdoor", 415_863, 9_794_513, "banded_fem", band=900, max_row=57),
    MatrixSpec(17, "F1", 343_791, 13_590_452, "banded_fem", band=2500, max_row=306),
    MatrixSpec(18, "nd24k", 72_000, 14_393_817, "blockdense", max_row=481),
    MatrixSpec(19, "inline_1", 503_712, 18_659_941, "banded_fem", band=1500, max_row=843),
    MatrixSpec(20, "mesh_2048", 4_194_304, 20_963_328, "stencil5"),
    MatrixSpec(21, "ldoor", 952_203, 21_723_010, "banded_fem", band=1200, max_row=49),
    MatrixSpec(22, "cage14", 1_505_785, 27_130_349, "randsparse", max_row=41),
]


def _values(rng: np.random.Generator, nnz: int) -> np.ndarray:
    return rng.standard_normal(nnz).astype(np.float32)


def _stencil5(spec: MatrixSpec, scale: float, rng) -> CSRMatrix:
    side = max(int(round(np.sqrt(spec.n_rows * scale))), 4)
    n = side * side
    idx = np.arange(n)
    r, c = idx // side, idx % side
    rows, cols = [idx], [idx]
    for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < side) & (cc >= 0) & (cc < side)
        rows.append(idx[ok])
        cols.append((rr * side + cc)[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    return csr_from_coo((n, n), rows, cols, _values(rng, rows.shape[0]))


def _banded_fem(spec: MatrixSpec, scale: float, rng) -> CSRMatrix:
    """FEM-style: per-row nnz clustered in short runs near the diagonal.

    Runs of ``run`` consecutive columns (consecutive dof of one element)
    give the high UCLD the paper observes on cant/pwtk/nd24k.
    """
    n = max(int(spec.n_rows * scale), 64)
    per_row = max(int(round(spec.nnz_per_row)), 2)
    band = max(int((spec.band or 100) * np.sqrt(scale)), 8)
    run = 6  # consecutive-column run length (element coupling)
    n_runs = -(-per_row // run)
    r_idx = np.repeat(np.arange(n), n_runs)
    centers = rng.integers(-band, band, size=r_idx.shape[0])
    starts = np.clip(r_idx + centers, 0, n - 1)
    rows = np.repeat(r_idx, run)
    cols = np.clip(
        np.repeat(starts, run) + np.tile(np.arange(run), r_idx.shape[0]), 0, n - 1
    )
    rows = np.concatenate([rows, np.arange(n)])  # diagonal
    cols = np.concatenate([cols, np.arange(n)])
    return csr_from_coo((n, n), rows, cols, _values(rng, rows.shape[0]))


def _randsparse(spec: MatrixSpec, scale: float, rng) -> CSRMatrix:
    n = max(int(spec.n_rows * scale), 64)
    per_row = spec.nnz_per_row
    counts = rng.poisson(max(per_row - 1.0, 0.5), size=n)
    if spec.max_row:
        counts = np.minimum(counts, spec.max_row - 1)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, n, size=rows.shape[0])
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    return csr_from_coo((n, n), rows, cols, _values(rng, rows.shape[0]))


def _powerlaw(spec: MatrixSpec, scale: float, rng) -> CSRMatrix:
    """Zipf-ish row degrees + a handful of ultra-dense rows/columns."""
    n = max(int(spec.n_rows * scale), 64)
    target_nnz = int(spec.nnz * scale)
    raw = rng.zipf(2.1, size=n).astype(np.float64)
    cap = (spec.max_row or n) * scale + 16
    raw = np.minimum(raw, cap)
    counts = np.maximum((raw / raw.sum() * target_nnz).astype(np.int64), 1)
    # column popularity is also heavy-tailed (webbase's 28685-deep column)
    col_pop = rng.zipf(2.0, size=n).astype(np.float64)
    col_p = col_pop / col_pop.sum()
    rows = np.repeat(np.arange(n), counts)
    cols = rng.choice(n, size=rows.shape[0], p=col_p)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    return csr_from_coo((n, n), rows, cols, _values(rng, rows.shape[0]))


def _blockdense(spec: MatrixSpec, scale: float, rng) -> CSRMatrix:
    """Dense diagonal clusters: nd24k/pdb1HYS-style near-dense rows."""
    n = max(int(spec.n_rows * scale), 128)
    per_row = int(round(spec.nnz_per_row))
    cluster = max(min(per_row * 2, n // 4), 8)
    n_clusters = -(-n // cluster)
    rows_l, cols_l = [], []
    for b in range(n_clusters):
        lo = b * cluster
        hi = min(lo + cluster, n)
        size = hi - lo
        density = min(per_row / max(size, 1), 1.0)
        m_ = rng.random((size, size)) < density
        np.fill_diagonal(m_, True)
        r, c = np.nonzero(m_)
        rows_l.append(r + lo)
        cols_l.append(c + lo)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    return csr_from_coo((n, n), rows, cols, _values(rng, rows.shape[0]))


_GENERATORS: dict[str, Callable] = {
    "stencil5": _stencil5,
    "banded_fem": _banded_fem,
    "randsparse": _randsparse,
    "powerlaw": _powerlaw,
    "blockdense": _blockdense,
}


def generate(name_or_spec: str | MatrixSpec, scale: float = 1.0, seed: int = 0) -> CSRMatrix:
    spec = (
        name_or_spec
        if isinstance(name_or_spec, MatrixSpec)
        else next(s for s in SUITE if s.name == name_or_spec)
    )
    rng = np.random.default_rng(seed * 1000 + spec.idx)
    mat = _GENERATORS[spec.family](spec, scale, rng)
    mat.validate()
    return mat


def generate_suite(scale: float = 1.0, seed: int = 0) -> dict[str, CSRMatrix]:
    return {s.name: generate(s, scale, seed) for s in SUITE}

"""Structural FEM stand-in: each row holds runs of ``RUN`` consecutive
columns (one element's degrees of freedom) centred within a half band of
``row["band"]`` (scaled by sqrt(scale)), plus the diagonal.  A frozen copy
of the program's ``data/suite.py`` family of the same name."""
import numpy as np

RUN = 6  # consecutive columns of one element


def structure(row: dict, scale: float, rng) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, rows, cols)`` before duplicates are merged."""
    n = max(int(row["n_rows"] * scale), 64)
    per_row = max(int(round(row["nnz"] / row["n_rows"])), 2)
    band = max(int((row["band"] or 100) * np.sqrt(scale)), 8)
    n_runs = -(-per_row // RUN)
    r_idx = np.repeat(np.arange(n), n_runs)
    centers = rng.integers(-band, band, size=r_idx.shape[0])
    starts = np.clip(r_idx + centers, 0, n - 1)
    rows = np.repeat(r_idx, RUN)
    cols = np.clip(np.repeat(starts, RUN) + np.tile(np.arange(RUN), r_idx.shape[0]),
                   0, n - 1)
    return n, np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)])

"""Random-pattern stand-in: Poisson row lengths of mean nnz / n_rows - 1,
capped at ``row["max_row"]`` - 1, uniformly random columns, plus the
diagonal.  A frozen copy of the program's ``data/suite.py`` family of the
same name."""
import numpy as np


def structure(row: dict, scale: float, rng) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, rows, cols)`` before duplicates are merged."""
    n = max(int(row["n_rows"] * scale), 64)
    counts = rng.poisson(max(row["nnz"] / row["n_rows"] - 1.0, 0.5), size=n)
    if row["max_row"]:
        counts = np.minimum(counts, row["max_row"] - 1)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, n, size=rows.shape[0])
    return n, np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)])

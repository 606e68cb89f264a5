"""A cell's data: the matrix structure, its values and the x pool.

The structure comes from the configuration file alone: its ``matrix`` row
(rows, stored values, longest row, the generator ``family`` and its
parameters) goes to ``bench/generators/<family>.py``, found by name, at
the configuration's ``scale`` and fixed ``generator_seed``.  It is
generated once and kept in ``bench/.cache/`` inside the checkout, as a
deployment keeps its matrix on disk.  The values and the right-hand sides
are drawn from ``--seed`` on the device, in two large calls of one
generator.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from . import spec


def csr(n: int, rows: np.ndarray, cols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(indptr int32 (n+1,), indices int32)`` of a square pattern given
    as coordinates: duplicates merged, each row's columns ascending."""
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    counts = np.bincount(key // n, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), (key % n).astype(np.int32)


def generate(root: Path, row: dict, scale: float = 1.0, seed: int = 0
             ) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, indptr, indices)`` of the stand-in for one matrix row, from its
    family's generator; the same as the program's ``generate(name, scale,
    seed)`` for a Table 1 row."""
    rng = np.random.default_rng(seed * 1000 + row["idx"])
    n, rows, cols = spec.generator(root, row["family"]).structure(row, scale, rng)
    return (n, *csr(n, rows, cols))


def structure_path(root: Path, config: dict, scale: float | None = None,
                   cache: Path | None = None) -> Path:
    """Where the configuration's structure at ``scale`` is cached: the key
    covers the row, the scale, the seed and the generator's source."""
    scale = float(config["scale"] if scale is None else scale)
    cache = root / "bench" / ".cache" if cache is None else Path(cache)
    row = config["matrix"]
    source = spec.generator_path(root, row["family"]).read_bytes()
    blob = json.dumps([row, scale, config["generator_seed"]], sort_keys=True).encode()
    key = hashlib.sha256(blob + source).hexdigest()[:16]
    return cache / f"{config['name']}-{key}.npz"


def structure(root: Path, config: dict, scale: float | None = None, *,
              cache: Path | None = None) -> tuple[int, np.ndarray, np.ndarray]:
    """``(n, indptr, indices)`` of the configuration's matrix at ``scale``
    (default the configuration's own), from the cache directory (default
    the checkout's) or generated there."""
    path = structure_path(root, config, scale, cache)
    if path.exists():
        with np.load(path) as z:
            return int(z["n"]), z["indptr"], z["indices"]
    scale = float(config["scale"] if scale is None else scale)
    n, indptr, indices = generate(root, config["matrix"], scale,
                                  int(config["generator_seed"]))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, n=n, indptr=indptr, indices=indices)
    os.replace(tmp, path)
    return n, indptr, indices


def draw(seed: int, nnz: int, n: int, pool: int, device: torch.device
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values (nnz,), X (pool, n))``, float32 N(0, 1) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    values = torch.randn(nnz, generator=gen, device=device, dtype=torch.float32)
    X = torch.randn((pool, n), generator=gen, device=device, dtype=torch.float32)
    return values, X

"""Carry prepared state across from the JAX package.

``repro.kernels.ops`` and ``repro.tune.operator.prepare`` build prepared
dicts whose leaves are device arrays; :func:`split` turns such a dict into
host numpy arrays plus its static metadata (``np.asarray`` reads any array
exposing the buffer protocol, so this module imports no JAX), and
:func:`prep_from_arrays` puts them on a torch device in this package's
layout, so the port's kernels and plain versions can run on exactly the
arrays the JAX package prepared.
"""
from __future__ import annotations

from typing import Any

import numpy as np

import torch

from repro_torch.core.formats import CSRMatrix
from repro_torch.kernels import merge_spmv
from repro_torch.kernels.ops import from_arrays

__all__ = ["split", "prep_from_arrays"]

_ARRAY_KEYS = ("cols", "vals", "row_perm", "block_rows", "block_cols", "blocks",
               "bounds", "col_start", "col_len", "rows", "indices", "data",
               "start", "end", "perm")


def split(prep: dict[str, Any]) -> tuple[dict, dict]:
    """(arrays as numpy, metadata) of a JAX-side prepared dict.  A
    ``slabs`` list (per-slab SELL) and a reordered candidate's ``inner``
    dict are split recursively; its permuted ``matrix`` becomes
    ``(shape, indptr, indices, data)``."""
    arrays: dict[str, Any] = {}
    meta: dict[str, Any] = {}
    for key, value in prep.items():
        if key == "slabs":
            arrays["slabs"] = [split(slab)[0] for slab in value]
            meta["chunk_tile"] = int(value[0].get("chunk_tile", 8)) if value else 8
        elif key == "inner":
            arrays["inner"], meta["inner"] = split(value)
        elif key == "matrix":
            arrays["matrix"] = (tuple(int(v) for v in value.shape),
                                np.asarray(value.indptr), np.asarray(value.indices),
                                np.asarray(value.data))
        elif key in _ARRAY_KEYS:
            arrays[key] = np.asarray(value)
        else:
            meta[key] = value
    return arrays, meta


def prep_from_arrays(fmt: str, arrays: dict, meta: dict, device) -> dict[str, Any]:
    """The port's prepared dict for ``fmt`` on ``device``, built from host
    arrays such as :func:`split` returns.  ``fmt`` is one of
    :func:`~repro_torch.kernels.ops.from_arrays`'s formats, ``"merge"``, or
    ``"reorder:<inner fmt>"`` for a reordered candidate (its permutation,
    permuted matrix and the inner format's dict)."""
    if fmt == "merge":
        return merge_spmv.from_host(arrays, meta, device)
    if fmt.startswith("reorder:"):
        shape, indptr, indices, data = arrays["matrix"]
        return {
            "perm": torch.as_tensor(np.asarray(arrays["perm"], np.int64), device=device),
            "matrix": CSRMatrix(tuple(shape), indptr, indices, data),
            "inner": prep_from_arrays(fmt.split(":", 1)[1], arrays["inner"],
                                      meta["inner"], device),
        }
    return from_arrays(fmt, arrays, meta, device)

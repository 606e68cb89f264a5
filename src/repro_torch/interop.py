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

from repro_torch.kernels.ops import from_arrays

__all__ = ["split", "prep_from_arrays"]

_ARRAY_KEYS = ("cols", "vals", "row_perm", "block_rows", "block_cols", "blocks",
               "bounds", "col_start", "col_len", "rows")


def split(prep: dict[str, Any]) -> tuple[dict, dict]:
    """(arrays as numpy, metadata) of a JAX-side prepared dict; a
    ``slabs`` list (per-slab SELL) is split recursively."""
    arrays: dict[str, Any] = {}
    meta: dict[str, Any] = {}
    for key, value in prep.items():
        if key == "slabs":
            arrays["slabs"] = [split(slab)[0] for slab in value]
            meta["chunk_tile"] = int(value[0].get("chunk_tile", 8)) if value else 8
        elif key in _ARRAY_KEYS:
            arrays[key] = np.asarray(value)
        else:
            meta[key] = value
    return arrays, meta


def prep_from_arrays(fmt: str, arrays: dict, meta: dict, device) -> dict[str, Any]:
    """The port's prepared dict for ``fmt`` (``"bcsr"``, ``"sell"``,
    ``"sell_blocked"``, ``"sell_blocked_stacked"`` or ``"spmspv"``) on
    ``device``, built from host arrays such as :func:`split` returns."""
    return from_arrays(fmt, arrays, meta, device)

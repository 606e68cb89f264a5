"""Merge-style nnz-balanced SpMV/SpMM: the load-balance tier, plain torch.

Every row-parallel tier pays for row-length skew: SELL pads each chunk to
its longest row and CSR's row sum follows the rows.  Merge-based SpMV
(Merrill & Garland's merge path applied to CSR) splits the *nonzero
stream*, not the rows, into equal chunks, scans each chunk, and fixes up
the rows that straddle chunk boundaries with a carry pass:

* prepare (host, once): pad nnz to ``n_chunks * chunk``; hoist the row
  boundaries (``indptr`` start/end per row);
* phase 1 (chunk-local): products ``A.data * x[cols]`` as (n_chunks,
  chunk, k), then an inclusive ``torch.cumsum`` within each chunk;
* phase 2 (carry): an exclusive scan of the chunk totals adds each chunk's
  carry-in, giving one global prefix-sum table P;
* gather: row r's sum is ``P[end[r]] - P[start[r]]``, O(1) per row
  whatever its length; empty rows come out as exact zeros.

The JAX package writes this tier as plain ``jnp`` (no Pallas kernel), so
the port writes it as plain torch.

Precision: a row's sum is a *difference of global prefix sums*, so its
error scales with eps * max|P|, not with the row's own terms.  Rows whose
true sum is small beside max|P| lose relative precision against the
per-row tiers; the port's checks hold this tier to
``|d_i| <= 1e-5 (|A| |x|)_i + 8 * 2**-24 * max|P|``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["merge_prepare", "merge_spmv", "merge_spmm", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 4096  # equal-nnz work chunk (the merge-path grain)


def merge_prepare(a, chunk: int = DEFAULT_CHUNK, *, device) -> dict[str, Any]:
    """Padded nnz streams and hoisted row pointers, on ``device``.

    ``indices``/``data`` are padded to ``n_chunks * chunk`` (padding reads
    x[0] with value 0.0); ``start``/``end`` are the int32 offsets into the
    prefix table.  A matrix with nnz >= 2**31 cannot be represented and is
    refused here: the int32 cast would wrap the late offsets to negative
    values and return silently wrong rows.
    """
    chunk = max(1, int(chunk))
    nnz = a.nnz
    n_chunks = max(1, -(-nnz // chunk))
    if int(a.indptr[-1]) >= 2**31 or n_chunks * chunk >= 2**31:
        raise OverflowError(
            f"merge tier: nnz={int(a.indptr[-1])} (padded {n_chunks * chunk}) "
            "overflows the int32 prefix-sum offsets; this matrix needs the "
            "CSR/SELL tiers (or row-partitioned shards each below 2**31 nnz)"
        )
    pad = n_chunks * chunk - nnz
    indices = np.concatenate([a.indices, np.zeros(pad, a.indices.dtype)])
    data = np.concatenate([a.data, np.zeros(pad, a.data.dtype)])
    return from_host(
        {"indices": indices, "data": data,
         "start": a.indptr[:-1].astype(np.int32),
         "end": a.indptr[1:].astype(np.int32)},
        {"chunk": chunk, "n_chunks": n_chunks, "shape": a.shape},
        device,
    )


def from_host(arrays: dict, meta: dict, device) -> dict[str, Any]:
    """The prepared dict on ``device`` from host arrays (``indices``,
    ``data``, ``start``, ``end``) and ``chunk``/``n_chunks``/``shape``."""
    prep = {key: torch.tensor(np.asarray(arrays[key]), device=device)
            for key in ("indices", "data", "start", "end")}
    prep["chunk"] = int(meta["chunk"])
    prep["n_chunks"] = int(meta["n_chunks"])
    prep["shape"] = tuple(int(v) for v in meta["shape"])
    return prep


def _prefix_table(data, indices, x2, *, chunk: int, n_chunks: int) -> torch.Tensor:
    """P (1 + n_chunks*chunk, k): global prefix sums of A.data * x[cols]."""
    prod = data[:, None] * x2[indices]  # (nnz_pad, k)
    k = prod.shape[-1]
    local = torch.cumsum(prod.view(n_chunks, chunk, k), dim=1)  # intra-chunk
    zero = torch.zeros((1, k), dtype=prod.dtype, device=prod.device)
    carry = torch.cat([zero, torch.cumsum(local[:, -1, :], dim=0)[:-1]])
    P = (local + carry[:, None, :]).view(n_chunks * chunk, k)
    return torch.cat([zero, P])


def merge_spmm(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n, k): nnz-balanced segmented reduction."""
    P = _prefix_table(prep["data"], prep["indices"], x,
                      chunk=prep["chunk"], n_chunks=prep["n_chunks"])
    return P[prep["end"]] - P[prep["start"]]


def merge_spmv(prep: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the k = 1 column of :func:`merge_spmm`."""
    return merge_spmm(prep, x[:, None])[:, 0]

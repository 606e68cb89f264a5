"""Plain torch oracles for the kernels, written independently of them.

Counterparts of ``repro.kernels.ref.bcsr_spmm_ref``, ``sell_spmv_ref`` and
``banded_attention_scores_ref``:
deliberately the dumbest correct thing (an explicit loop over stored blocks;
a gather and a sum in sorted row order), sharing no code with the kernels'
plain versions.
"""
from __future__ import annotations

import torch

__all__ = ["bcsr_spmm_ref", "sell_spmv_ref", "banded_attention_scores_ref"]


def bcsr_spmm_ref(blocks, block_rows, block_cols, x_blocked, n_block_rows):
    """Y = A @ X.  blocks (B, bm, bk); x_blocked (Gn, bk, k).

    Returns (n_block_rows, bm, k) float32, one python-level step per block.
    """
    B, bm, _ = blocks.shape
    k = x_blocked.shape[-1]
    out = torch.zeros((n_block_rows, bm, k), dtype=torch.float32,
                      device=x_blocked.device)
    for t in range(B):
        r, c = int(block_rows[t]), int(block_cols[t])
        out[r] += blocks[t].float() @ x_blocked[c].float()
    return out


def sell_spmv_ref(cols, vals, x):
    """Per-sorted-row sums for SELL chunks.

    cols/vals (n_chunks, C, W); x (n,).  Returns (n_chunks * C,) sums in
    *sorted* row order (the caller un-permutes).
    """
    return (vals * x[cols.long()]).sum(dim=-1).reshape(-1)


def banded_attention_scores_ref(q, k, window):
    """Banded QK^T for the sliding-window attention check.

    q, k: (seq, d).  Returns (seq, seq) scores, -inf outside the causal band
    (j <= i and i - j < window).
    """
    seq = q.shape[0]
    scores = q @ k.T
    i = torch.arange(seq, device=q.device)[:, None]
    j = torch.arange(seq, device=q.device)[None, :]
    mask = (j <= i) & (i - j < window)
    return scores.masked_fill(~mask, float("-inf"))

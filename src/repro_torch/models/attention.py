"""Attention: chunked (flash-style) prefill path and cached decode.

Plain torch, as the JAX package writes it in ``jnp`` (no Pallas kernel):
blockwise softmax(QK^T)V with running max/sum statistics in float32, GQA
grouping, causal masking and sliding windows by position arithmetic.  The
q and kv chunks are Python loops over views (the JAX package's ``lax.map``
and ``lax.scan``).

Decode uses a slot-position cache: ``positions[b, slot]`` records which
absolute token a slot holds (-1 = empty) and ``pos[b]`` the next position,
per batch element, so sequences at different depths share one cache.  A
ring buffer (sliding-window decode) is the same structure with slots =
window.  Unlike the JAX package, :func:`update_kv_cache` writes the cache
in place (a cache may be a view of one layer of the stacked decode state),
which saves a copy of every layer's cache per token.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve

from .common import upcast

__all__ = [
    "flash_attention",
    "decode_attention",
    "init_kv_cache",
    "update_kv_cache",
]

NEG_INF = -1e30


def _divisor_chunk(total: int, chunk: int) -> int:
    """Largest divisor of ``total`` that is <= ``chunk``."""
    chunk = min(chunk, total)
    while total % chunk:
        chunk -= 1
    return chunk


def flash_attention(
    q: torch.Tensor,  # (b, sq, h, hd)
    k: torch.Tensor,  # (b, skv, kvh, hd)
    v: torch.Tensor,  # (b, skv, kvh, hd)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    skip_masked_blocks: bool = False,
    p_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Blockwise softmax(QK^T)V with float32 statistics and accumulators
    (float64 for float64 operands).

    ``skip_masked_blocks``: when causal (and no window), skip the kv chunks
    wholly above the diagonal.  ``p_dtype``: the type of the probability
    tiles fed to the PV product (None = float32); the statistics stay
    float32.  Chunks are the largest divisors of the lengths at most the
    requested sizes.
    """
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv heads")
    g = h // kvh
    q_chunk = _divisor_chunk(sq, q_chunk)
    kv_chunk = _divisor_chunk(skv, kv_chunk)
    nq, nkv = sq // q_chunk, skv // kv_chunk
    scale = hd ** -0.5
    dev = q.device
    acc_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32

    qr = q.reshape(b, nq, q_chunk, kvh, g, hd)
    kr = k.reshape(b, nkv, kv_chunk, kvh, hd)
    vr = v.reshape(b, nkv, kv_chunk, kvh, hd)
    q_ar = torch.arange(q_chunk, device=dev)
    kv_ar = torch.arange(kv_chunk, device=dev)
    outs = []
    for iq in range(nq):
        q_blk = upcast(qr[:, iq])  # (b, q_chunk, kvh, g, hd)
        q_pos = q_offset + iq * q_chunk + q_ar
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=acc_dtype, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=acc_dtype, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), dtype=acc_dtype, device=dev)
        n_steps = nkv
        if skip_masked_blocks and causal and window is None:
            n_steps = min((q_offset + (iq + 1) * q_chunk + kv_chunk - 1) // kv_chunk, nkv)
        for ikv in range(n_steps):
            kv_pos = ikv * kv_chunk + kv_ar
            s = torch.einsum("bqkgd,bckd->bkgqc", q_blk, upcast(kr[:, ikv])) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= q_pos[:, None] - kv_pos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = p if p_dtype is None else p.to(p_dtype)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", pv, vr[:, ikv].to(pv.dtype)).to(acc_dtype)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, q_chunk, kvh, g, hd)
    out = torch.stack(outs, dim=1).reshape(b, sq, h, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode path: slot-position KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(batch: int, slots: int, kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> dict[str, Any]:
    """slots = max_seq for full caches, = window for ring (SWA) caches."""
    dev = resolve(device)
    return {
        "k": torch.zeros((batch, slots, kv_heads, head_dim), dtype=dtype, device=dev),
        "v": torch.zeros((batch, slots, kv_heads, head_dim), dtype=dtype, device=dev),
        "positions": torch.full((batch, slots), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Append one token (k/v_new: (b, 1, kvh, hd)) at each batch element's
    own ring position ``pos % slots``, in place; returns ``cache``."""
    b, slots = cache["k"].shape[:2]
    pos = cache["pos"]
    slot = (pos % slots).long()
    rows = torch.arange(b, device=pos.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["positions"][rows, slot] = pos
    pos.add_(1)
    return cache


def decode_attention(q: torch.Tensor, cache: dict, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token attention (q: (b, 1, h, hd)) against the cache, whose
    last appended token is the query's own."""
    b, _, h, hd = q.shape
    kvh = cache["k"].shape[2]
    g = h // kvh
    scale = hd ** -0.5
    pos = (cache["pos"] - 1)[:, None]  # the query's position
    qv = q.reshape(b, kvh, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qv, cache["k"].float()) * scale
    positions = cache["positions"]
    valid = (positions >= 0) & (positions <= pos)
    if window is not None:
        valid &= pos - positions < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, cache["v"].float())
    return out.reshape(b, 1, h, hd).to(q.dtype)

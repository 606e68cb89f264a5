"""Stub inputs of the audio and VLM families, one request at a time.

Both front ends are stubs in the JAX package (its ``data/pipeline.py``
``make_batch`` draws them), so a request carries what they would produce:
whisper's precomputed frame embeddings, Qwen2-VL's precomputed vision
embeddings and its M-RoPE positions.  Embeddings are N(0, 1) float32 from
the caller's ``numpy`` generator, as the JAX package draws them.  The
positions differ from the JAX package's, which are ``arange`` on all three
streams: equal streams make M-RoPE plain RoPE, so they could not show a
wrong section split.  Here they follow Qwen2-VL's layout
(:func:`qwen2_vl_positions`).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["qwen2_vl_positions", "request_inputs"]


def qwen2_vl_positions(n_vision: int, n_text: int) -> np.ndarray:
    """(3, n_vision + n_text) int32 M-RoPE positions (t, h, w) in Qwen2-VL's
    layout for one image followed by text: vision slot i on a grid of
    w = ceil(sqrt(n_vision)) columns at (0, i // w, i % w), text token j at
    start + j on all three streams, where start is the largest vision
    position + 1 (16 for 256 slots on their 16 x 16 grid)."""
    w = math.isqrt(n_vision)
    w += w * w < n_vision
    i = np.arange(n_vision)
    vision = np.stack([np.zeros_like(i), i // max(w, 1), i % max(w, 1)])
    start = int(vision.max()) + 1 if n_vision else 0
    text = np.broadcast_to(start + np.arange(n_text), (3, n_text))
    return np.concatenate([vision, text], axis=1).astype(np.int32)


def request_inputs(cfg, prompt_len: int, rng: np.random.Generator) -> dict:
    """The modality inputs of one request of ``cfg``'s family with a prompt
    of ``prompt_len`` tokens (a VLM's counts its vision slots), drawn from
    ``rng``: audio ``frames`` (enc_frames, d_model); vlm ``vision_embeds``
    (n_vision_tokens, d_model) and ``positions`` (3, prompt_len); no draw
    and no input for the other families."""
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((cfg.enc_frames, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "vlm" and cfg.n_vision_tokens:
        n = cfg.n_vision_tokens
        return {"vision_embeds": rng.standard_normal((n, cfg.d_model)).astype(np.float32),
                "positions": qwen2_vl_positions(n, prompt_len - n)}
    return {}

"""Deterministic synthetic training data, the JAX package's generators.

Pure numpy, line for line the JAX package's ``data/pipeline.py``, so both
packages train on the same arrays for every seed and step:

* ``SyntheticTokens`` — iid tokens keyed by (seed, step): a pure function
  of the step index, so a restart never replays or skips data;
* ``MarkovTokens`` — an order-1 Markov chain whose transition matrix is
  sparse (each state moves to ``branch`` successors).  An LM that learns
  it drops from log(vocab) towards ``entropy_floor()`` nats.

:func:`make_batch` adds the audio and VLM stub inputs as the JAX package
draws them: seeded gaussian ``frames`` or ``vision_embeds``, and VLM
``positions`` (3, b, s) that are ``arange`` on all three streams.  (The
serving stubs of :mod:`repro_torch.data.modality` use Qwen2-VL's layout
instead; both stay.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokens", "MarkovTokens", "make_batch"]


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq + 1), dtype=np.int64)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class MarkovTokens:
    vocab: int
    batch: int
    seq: int
    branch: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse transition structure: each state -> `branch` successors
        self.successors = rng.integers(
            0, self.vocab, (self.vocab, self.branch), dtype=np.int64
        )
        probs = rng.random((self.vocab, self.branch))
        self.probs = probs / probs.sum(axis=1, keepdims=True)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, 1, step))
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        u = rng.random((self.batch, self.seq))
        for t in range(self.seq):
            cur = toks[:, t]
            cdf = np.cumsum(self.probs[cur], axis=1)
            choice = (u[:, t : t + 1] > cdf).sum(axis=1)
            toks[:, t + 1] = self.successors[cur, np.minimum(choice, self.branch - 1)]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def entropy_floor(self) -> float:
        """Mean conditional entropy of the chain (nats): the loss floor."""
        p = self.probs
        return float(-(p * np.log(p)).sum(axis=1).mean())


def make_batch(cfg, shape_batch: int, seq: int, step: int, seed: int = 0):
    """A concrete batch for a ``ModelConfig`` (adds the family's stub inputs)."""
    gen = SyntheticTokens(cfg.vocab, shape_batch, seq, seed)
    batch = gen.batch_at(step)
    rng = np.random.default_rng((seed, 2, step))
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (shape_batch, cfg.enc_frames, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm" and cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (shape_batch, cfg.n_vision_tokens, cfg.d_model)
        ).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq)[None, None, :], (3, shape_batch, seq))
        batch["positions"] = pos.astype(np.int32).copy()
    return batch

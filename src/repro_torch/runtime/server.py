"""Batched LM decode serving: continuous batching over a fixed slot grid.

A request queue, B decode slots, and per-slot free/assign/evict
bookkeeping.  A new request is prefilled with one ``prefill`` pass (batch
1) and its KV cache copied into the freed slot while the other slots keep
decoding; the cache tracks positions per slot, so sequences at different
depths share one B-wide ``decode_step``.  Greedy sampling: the argmax over
the padded vocabulary, as the JAX package takes it (a pad id can win:
ROADMAP C.18).

Decode is the paper's k = 1 regime (memory-bound, as SpMV), and batching B
requests is its SpMM move: with the block-sparse FFN each decode step runs
the BCSR kernel at k = B.  With ``impl="auto"`` the server routes W1 and W2
through the tuner's measured search at k = B when it is built.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.lm import LM, ModelConfig, decode_step, init_decode_state, prefill

__all__ = ["Request", "BatchedServer"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float | None = None
    t_start: float | None = None  # slot assignment (prefill) time
    t_done: float | None = None

    @property
    def latency_s(self) -> float:
        if self.t_done is None or self.t_submit is None:
            raise ValueError(f"request {self.rid} has not completed")
        return self.t_done - self.t_submit


def _merge_slot(state: dict, state1: dict, i: int) -> None:
    """Copy a batch-1 decode state into slot ``i`` of ``state``: every leaf
    has the layers axis first and the batch axis second."""
    for key, t in state["kv"].items():
        t[:, i] = state1["kv"][key][:, 0]


class BatchedServer:
    """Fixed-B slot server over ``decode_step``.

    All slots share each step; empty slots decode token 0 into their own
    cache rows, which the next prefill into that slot overwrites.
    ``plan_cache``: the tuner's plan cache for ``impl="auto"`` (the default
    cache when None).
    """

    def __init__(self, cfg: ModelConfig, model: LM, batch_slots: int, max_seq: int,
                 *, plan_cache=None):
        sff = cfg.sparse_ffn
        if sff is not None and sff.kind == "bcsr" and sff.impl == "auto":
            from repro_torch.models.ffn import tune_sparse_ffn

            cfg = dataclasses.replace(cfg, sparse_ffn=tune_sparse_ffn(
                sff, model.blocks[0].ffn, cfg.d_model, cfg.d_ff, k=batch_slots,
                cache=plan_cache))
        self.cfg = cfg
        self.model = model
        self.B = batch_slots
        self.max_seq = max_seq
        self.device = model.device
        self.state = init_decode_state(cfg, batch_slots, max_seq, self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.queue: list[Request] = []
        self.steps = 0
        self.prefills = 0
        self.slot_tokens = 0  # decoded tokens, for occupancy reporting
        self.completed: list[Request] = []

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _assign(self) -> None:
        """Prefill queued requests into free slots (one pass per request)."""
        for i in range(self.B):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                         dtype=torch.long, device=self.device)
                state1, logits = prefill(self.cfg, self.model, {"tokens": tokens},
                                         self.max_seq)
                _merge_slot(self.state, state1, i)
                req._first = int(torch.argmax(logits[0]))
                req.t_start = time.perf_counter()
                self.prefills += 1

    def step(self) -> int:
        """One decode step for all active slots; returns the number active."""
        self._assign()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        toks = np.zeros((self.B, 1), np.int64)
        for i in active:
            req = self.slot_req[i]
            toks[i, 0] = req.out[-1] if req.out else req._first
        self.state, logits = decode_step(self.cfg, self.model, self.state,
                                         torch.as_tensor(toks, device=self.device))
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        t_now = time.perf_counter()
        for i in active:
            req = self.slot_req[i]
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new:
                req.done = True
                req.t_done = t_now
                self.completed.append(req)
                self.slot_req[i] = None
        self.steps += 1
        self.slot_tokens += len(active)
        return len(active)

    @property
    def occupancy(self) -> float:
        """Mean fraction of decode slots doing real work per step."""
        return self.slot_tokens / max(self.steps * self.B, 1)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.steps < max_steps:
            self.step()
        return self.completed

"""Batched LM decode serving: continuous batching over a fixed slot grid.

A request queue, B decode slots, and per-slot free/assign/evict
bookkeeping.  A new request is prefilled with one ``prefill`` pass (batch
1) and its KV cache copied into the freed slot while the other slots keep
decoding; the cache tracks positions per slot, so sequences at different
depths share one B-wide ``decode_step``; an RWKV-6 or Mamba-2 model's
recurrent state, and an audio model's cross-attention keys and values, are
copied into the slot the same way.  Greedy sampling: the argmax over the
``vocab`` real columns of the logits.  The JAX package takes it over the
padded vocabulary, so a pad id can win there; the port masks the pad
columns out (ROADMAP C.18, a recorded deviation).

A request carries its own modality inputs, which its prefill reads: an
audio model's ``frames`` (enc_frames, d_model), a VLM's ``vision_embeds``
(n_vision_tokens, d_model) and, optionally, its M-RoPE ``positions`` (3,
len).  ``submit`` refuses a request whose inputs its model cannot take
(``ValueError``).  The JAX package's server prefills with the tokens alone,
so it cannot serve either family (ROADMAP C.25).

Decode is the paper's k = 1 regime (memory-bound, as SpMV), and batching B
requests is its SpMM move: with the block-sparse FFN each decode step runs
the BCSR kernel at k = B.  With ``impl="auto"`` the server routes W1 and W2
through the tuner's measured search at k = B when it is built.

On a card (``captured=True``, the default) the server runs compiled, as
the JAX package's server runs ``jax.jit(decode_step, donate_argnums=(1,))``
and ``jax.jit(prefill)``: one CUDA graph of ``decode_step`` for its B slots,
captured when it is built, and one graph of ``prefill`` per prompt length
(and set of modality inputs) it serves, captured at that length's first
request (``runtime.executable``).
The decode graph updates the server's own decode state in place, the
counterpart of the donated state; each step copies its tokens into the
graph's static ``(B, 1)`` input from pinned host memory, replays, and reads
the argmax of the static logits before the next replay.  A prefill graph
takes the prompt and its modality inputs as static inputs, filled the same
way before each replay; its state and last-token logits are static: the slot merge copies the state
out before the next prefill replays.  Each capture first runs its function
once eagerly (the warm-up; the decode warm-up runs on a scratch state, so
the first served token reads an unwritten cache): ``warmups`` counts those
passes, ``graphs`` the graphs and ``capture_s`` the seconds spent
capturing.  On the CPU, or with ``captured=False``, every pass is eager.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.lm import LM, ModelConfig, decode_step, init_decode_state, prefill
from repro_torch.runtime.executable import GraphPool, capture

__all__ = ["Request", "BatchedServer", "prompt_batch", "check_request"]

_MODALITY = ("frames", "vision_embeds", "positions")


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
    frames: np.ndarray | None = None  # audio: (enc_frames, d_model)
    vision_embeds: np.ndarray | None = None  # vlm: (n_vision_tokens, d_model)
    positions: np.ndarray | None = None  # vlm: (3, len) M-RoPE t, h, w

    @property
    def latency_s(self) -> float:
        if self.t_done is None or self.t_submit is None:
            raise ValueError(f"request {self.rid} has not completed")
        return self.t_done - self.t_submit

    def inputs(self) -> dict:
        """The modality inputs the request carries, by name."""
        return {key: getattr(self, key) for key in _MODALITY
                if getattr(self, key) is not None}


def prompt_batch(prompt, frames=None, vision_embeds=None, positions=None) -> dict:
    """The batch-1 model inputs of one prompt, as numpy: ``tokens`` (1,
    len) int64 and each modality input given, with a batch axis
    (``frames`` and ``vision_embeds`` float32, ``positions`` (3, 1, len)
    int64)."""
    batch = {"tokens": np.ascontiguousarray(np.asarray(prompt, np.int64)[None])}
    for key, value, dtype, axis in (("frames", frames, np.float32, 0),
                                    ("vision_embeds", vision_embeds, np.float32, 0),
                                    ("positions", positions, np.int64, 1)):
        if value is not None:
            batch[key] = np.ascontiguousarray(np.expand_dims(np.asarray(value, dtype),
                                                             axis))
    return batch


def check_request(cfg: ModelConfig, req: Request) -> None:
    """Raise ``ValueError`` unless ``req`` carries the modality inputs its
    model reads, at their shapes: frames for audio, vision embeddings for a
    VLM (whose prompt must also hold its vision slots), M-RoPE positions
    only where the model rotates by them; nothing else."""
    n = len(req.prompt)
    want = {}
    if cfg.family == "audio":
        want["frames"] = (cfg.enc_frames, cfg.d_model)
    if cfg.family == "vlm" and cfg.n_vision_tokens:
        want["vision_embeds"] = (cfg.n_vision_tokens, cfg.d_model)
        if n < cfg.n_vision_tokens:
            raise ValueError(f"request {req.rid}: a prompt of {n} tokens is shorter than "
                             f"{cfg.arch_id}'s {cfg.n_vision_tokens} vision slots")
    for key, shape in want.items():
        value = getattr(req, key)
        if value is None or np.shape(value) != shape:
            raise ValueError(f"request {req.rid}: {cfg.arch_id} needs {key} of shape "
                             f"{shape}, got "
                             f"{None if value is None else np.shape(value)}")
    if req.positions is not None:
        if cfg.mrope_sections is None:
            raise ValueError(f"request {req.rid}: {cfg.arch_id} takes no positions "
                             "(they are M-RoPE's)")
        if np.shape(req.positions) != (3, n):
            raise ValueError(f"request {req.rid}: positions of shape "
                             f"{np.shape(req.positions)}, expected (3, {n})")
    extra = set(req.inputs()) - set(want) - {"positions"}
    if extra:
        raise ValueError(f"request {req.rid}: {cfg.arch_id} ({cfg.family}) reads no "
                         f"{', '.join(sorted(extra))}")


# the batch axis of each decode-state group: after the layers axis, or for
# a hybrid's Mamba-2 states after the super-block and layer axes
_BATCH_AXIS = {"kv": 1, "rwkv": 1, "mamba": 2, "cross": 1}


def _merge_slot(state: dict, state1: dict, i: int) -> None:
    """Copy a batch-1 decode state into slot ``i`` of ``state``, group by
    group at the group's batch axis (``_BATCH_AXIS``: ``kv``, ``rwkv``,
    ``cross`` (L, B, ...); ``mamba`` (n_super, period, B, ...))."""
    for group, leaves in state.items():
        ax = _BATCH_AXIS[group]
        for key, t in leaves.items():
            t.select(ax, i).copy_(state1[group][key].select(ax, 0))


class BatchedServer:
    """Fixed-B slot server over ``decode_step``.

    All slots share each step; empty slots decode token 0 into their own
    cache rows, which the next prefill into that slot overwrites.
    ``plan_cache``: the tuner's plan cache for ``impl="auto"`` (the default
    cache when None).  ``captured``: decode and prefill as CUDA graphs on a
    card (see the module docstring).
    """

    def __init__(self, cfg: ModelConfig, model: LM, batch_slots: int, max_seq: int,
                 *, plan_cache=None, captured: bool = True):
        sff = cfg.sparse_ffn
        if sff is not None and sff.kind == "bcsr" and sff.impl == "auto":
            from repro_torch.models.ffn import tune_sparse_ffn

            # a hybrid's FFN is its shared block's (the JAX package means to
            # tune that one too, but reads its Mamba-2 tree: ROADMAP C.24);
            # every layer of a model shares the seeded block pattern
            blk = (model.shared if cfg.family == "hybrid" else
                   model.dec_blocks[0] if cfg.family == "audio" else model.blocks[0])
            cfg = dataclasses.replace(cfg, sparse_ffn=tune_sparse_ffn(
                sff, blk.ffn, cfg.d_model, cfg.d_ff, k=batch_slots,
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
        self.captured = bool(captured) and self.device.type == "cuda"
        self.graphs = 0
        self.warmups = 0
        self.capture_s = 0.0
        # the last decode step's logits (B, 1, V); on a card the decode
        # graph's static output, which the next step rewrites
        self.last_logits: torch.Tensor | None = None
        self._decode = None  # (graph, tokens, pinned tokens, logits)
        # (length, input names) -> (graph, static inputs, pinned, state, logits)
        self._prefill: dict[tuple, tuple] = {}
        # one pool for every graph of the server: each replay's outputs are
        # read (the argmax) or copied out (the slot merge) before the next
        self._pool = GraphPool(self.device) if self.captured else None
        if self.captured:
            self._capture_decode()

    def _captured(self, fn, *args, warmup_args=None):
        t0 = time.perf_counter()
        graph, out = capture(fn, *args, warmup_args=warmup_args, device=self.device,
                             pool=self._pool)
        self.capture_s += time.perf_counter() - t0
        self.graphs += 1
        self.warmups += 1
        return graph, out

    def _capture_decode(self) -> None:
        cfg, model = self.cfg, self.model
        tokens = torch.zeros((self.B, 1), dtype=torch.long, device=self.device)
        scratch = init_decode_state(cfg, self.B, self.max_seq, self.device)
        graph, logits = self._captured(
            lambda state, toks: decode_step(cfg, model, state, toks)[1],
            self.state, tokens, warmup_args=(scratch, tokens))
        pinned = torch.zeros((self.B, 1), dtype=torch.long).pin_memory()
        self._decode = (graph, tokens, pinned, logits)

    def _prefill_one(self, prompt: np.ndarray, **inputs) -> tuple[dict, torch.Tensor]:
        """(batch-1 decode state, last-token logits) of one prompt and its
        modality ``inputs`` (:func:`prompt_batch`'s keywords): a replay of
        the graph for its length and input names, or an eager pass."""
        batch = prompt_batch(prompt, **inputs)
        if not self.captured:
            return prefill(self.cfg, self.model,
                           {key: torch.as_tensor(v, device=self.device)
                            for key, v in batch.items()}, self.max_seq)
        key = (batch["tokens"].shape[1], tuple(sorted(batch)))
        entry = self._prefill.get(key)
        if entry is None:
            pinned = {name: torch.from_numpy(v).pin_memory() for name, v in batch.items()}
            static = {name: t.to(self.device) for name, t in pinned.items()}
            cfg, model, max_seq = self.cfg, self.model, self.max_seq
            graph, (state, logits) = self._captured(
                lambda b: prefill(cfg, model, b, max_seq), static)
            entry = self._prefill[key] = (graph, static, pinned, state, logits)
        graph, static, pinned, state, logits = entry
        for name, v in batch.items():
            pinned[name].copy_(torch.from_numpy(v))
            static[name].copy_(pinned[name], non_blocking=True)
        graph.replay()
        return state, logits

    def _decode_once(self, toks: np.ndarray) -> torch.Tensor:
        """One decode step of every slot on the host tokens ``toks`` (B, 1)
        int64: the decode graph's replay after the pinned copy, or an eager
        pass.  Returns the logits (B, 1, V), on a card the graph's static
        output."""
        if self._decode is None:
            self.state, logits = decode_step(self.cfg, self.model, self.state,
                                             torch.as_tensor(toks, device=self.device))
            return logits
        graph, tokens, pinned, logits = self._decode
        pinned.copy_(torch.from_numpy(toks))
        tokens.copy_(pinned, non_blocking=True)
        graph.replay()
        return logits

    def submit(self, req: Request) -> None:
        """Queue ``req``; raises ``ValueError`` (:func:`check_request`) if
        its model cannot take its inputs."""
        check_request(self.cfg, req)
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _assign(self) -> None:
        """Prefill queued requests into free slots (one pass per request)."""
        for i in range(self.B):
            if self.slot_req[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[i] = req
                state1, logits = self._prefill_one(req.prompt, **req.inputs())
                _merge_slot(self.state, state1, i)
                # reading the token waits for the merge, so the next prefill
                # replay cannot overwrite a graph's state before it is copied
                req._first = int(torch.argmax(logits[0, :self.cfg.vocab]))
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
        logits = self._decode_once(toks)
        # the host waits for the argmax here, before the pinned tokens and
        # the static logits are written again
        self.last_logits = logits
        nxt = torch.argmax(logits[:, 0, :self.cfg.vocab], dim=-1).cpu().numpy()
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

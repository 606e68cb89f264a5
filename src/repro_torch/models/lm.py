"""The language model of the port: the dense, MoE, RWKV-6, hybrid, audio
and VLM families.

A transformer decoder (dense, moe and vlm families) is ``n_layers`` blocks
of RMSNorm → attention with RoPE, GQA, QKV bias and sliding windows →
RMSNorm → FFN.  The FFN is dense SwiGLU, GELU, the block-sparse FFN through
the BCSR kernel (``cfg.sparse_ffn``), or, when ``cfg.moe`` is set, the
capacity-dropped mixture of experts (``models.moe``).  The ssm family
(``ssm_kind="rwkv6"``) is ``n_layers`` RWKV-6 blocks (``models.rwkv6``).
The hybrid family (zamba2, ``ssm_kind="mamba2"``) is ``n_layers //
hybrid_period`` super-blocks, each one application of a single **shared**
transformer block (whose q projection adds that super-block's LoRA,
``x @ lora_a[i] @ lora_b[i]``) followed by ``hybrid_period`` Mamba-2
layers (``models.mamba2``) with pre-norms and residuals; the shared
block's FFN is the block-sparse one when ``cfg.sparse_ffn`` is set.
The audio family (whisper) is an encoder of ``enc_layers`` blocks with
non-causal attention over ``batch["frames"]`` (b, enc_frames, d_model),
precomputed frame embeddings (the conv front end is a stub, as in the JAX
package) plus sinusoids, and a decoder of ``n_layers`` blocks of causal
self-attention, cross-attention over the encoder's output (keys and
values projected without bias) and the FFN; both add sinusoidal
positions and rotate nothing.  The vlm family (Qwen2-VL) is the
transformer decoder whose first ``n_vision_tokens`` slots take
``batch["vision_embeds"]`` (b, n_vision_tokens, d_model) in place of the
token embeddings (the vision tower is a stub) and whose attention rotates
by M-RoPE at ``batch["positions"]`` (3, b, s), the t, h and w streams
(``arange`` on all three when the batch has none).  A decode step
continues every stream at the cache's position s, as the JAX package
does (ROADMAP C.26).  Layers are an ``nn.ModuleList`` (a hybrid's
``blocks`` one per super-block); the JAX package scans a stacked
parameter tree instead.  ``family="ssm"`` with ``ssm_kind="mamba2"``,
which the JAX package refuses, raises ``NotImplementedError``.

Entry points mirror the JAX package's: :func:`init_model`, :func:`forward`,
:func:`prefill`, :func:`decode_step`, :func:`init_decode_state` and
:func:`param_count`.  Each takes the model and a config; the config decides
the execution tier of the sparse FFN, so a server can re-route a model's
FFN (``impl="auto"``) without touching its weights.  The decode state keeps
the JAX package's stacked layout, every leaf with the layers axis first and
the batch axis second: ``{"kv": {"k", "v": (L, B, S, kvh, hd), "positions":
(L, B, S), "pos": (L, B)}}`` for the transformers, plus ``{"cross": {"k",
"v": (L, B, enc_frames, kvh, hd)}}`` (the encoder's keys and values for
each decoder layer, written by :func:`prefill`) for audio, ``{"rwkv":
{"tm_shift", "cm_shift": (L, B, d), "wkv": (L, B, H, hd, hd)}}`` (float32)
for RWKV-6, and for the hybrid the shared block's caches with L = n_super
beside ``{"mamba": {"conv": (n_super, period, B, CONV_K - 1, ch), "ssd":
(n_super, period, B, H, P, N)}}`` (float32), whose batch axis is the
third.  :func:`decode_step` updates it in place.

Training: :func:`forward` runs under the caller's grad mode, and
:func:`loss_fn` is the JAX package's (float32 logits, pad columns masked,
cross-entropy plus z-loss plus the MoE's auxiliary loss).  A model is built
frozen, as a server wants it; :func:`trainable` makes its floating
parameters take gradients (the bcsr FFN's block indices are buffers and
stay out).  ``remat="full"`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, where the JAX package wraps the same block
bodies in ``jax.checkpoint``).  :func:`prefill` and :func:`decode_step`
run under ``torch.no_grad`` and write their state in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve

from . import attention as attn
from . import mamba2 as m2
from . import moe as moe_mod
from . import rwkv6 as rw
from .common import (
    apply_rope,
    embed_init,
    frozen,
    layer_norm,
    mrope,
    rms_norm,
    rope,
    sinusoid,
    upcast,
    weight,
)
from .ffn import GeluFFN, SparseFFN, SparseFFNConfig, SwiGLU, sparse_ffn_apply

__all__ = ["ModelConfig", "LM", "init_model", "forward", "loss_fn", "prefill",
           "decode_step", "init_decode_state", "param_count", "param_axes", "trainable"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the JAX package's ``ModelConfig``, so a configuration
    file copies across unchanged.  On one card the sharding fields
    (``moe_partition``, ``attn_dp_only``, ``fsdp_gather_weights``) are
    accepted and have no effect; ``remat`` (``"none"`` or ``"full"``)
    decides whether a trained forward recomputes its blocks in the
    backward pass.  ``moe`` is a :class:`~repro_torch.models.moe.MoEConfig`."""

    arch_id: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    attn_bias: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None
    attn_chunk: int = 1024
    skip_masked_blocks: bool = False  # triangular schedule in flash attention
    attn_p_bf16: bool = False  # bf16 probability tiles in flash attention
    # moe
    moe: Any = None
    moe_partition: str = "ep"
    # ssm
    ssm_kind: str | None = None
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid
    hybrid_period: int = 0
    lora_rank: int = 0
    # enc-dec
    enc_layers: int = 0
    enc_frames: int = 1500
    # vlm
    n_vision_tokens: int = 0
    # misc
    norm: str = "rmsnorm"
    act: str = "swiglu"
    dtype: Any = torch.bfloat16
    remat: str = "full"
    embed_onehot: bool = False  # one-hot matmul embedding
    attn_dp_only: bool = False
    fsdp_gather_weights: bool = False
    sparse_ffn: SparseFFNConfig | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def qkv_dims(self) -> tuple[int, int]:
        return self.n_heads * self.hd, self.n_kv_heads * self.hd


def _transformer(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "moe", "vlm")


def _hybrid(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid"


def _audio(cfg: ModelConfig) -> bool:
    return cfg.family == "audio"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_kind != (
            "rwkv6" if cfg.family == "ssm" else "mamba2"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the JAX package has no {cfg.family} family with "
            f"ssm_kind={cfg.ssm_kind!r}, and neither has the port")
    if not (_transformer(cfg) or _audio(cfg) or cfg.family in ("ssm", "hybrid")):
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}")
    if cfg.mrope_sections is not None and sum(cfg.mrope_sections) != cfg.hd // 2:
        raise ValueError(f"{cfg.arch_id}: mrope sections {cfg.mrope_sections} must sum "
                         f"to head_dim // 2 = {cfg.hd // 2}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    AXES = {"g": ("embed",), "b": ("embed",)}

    def __init__(self, cfg: ModelConfig, dim: int, device):
        super().__init__()
        self.layer = cfg.norm == "layernorm"
        self.g = frozen(torch.ones((dim,), dtype=cfg.dtype, device=device))
        if self.layer:
            self.b = frozen(torch.zeros((dim,), dtype=cfg.dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.g, self.b) if self.layer else rms_norm(x, self.g)


class Attention(nn.Module):
    AXES = {"wq": ("embed", "heads_flat"), "wk": ("embed", "kv_flat"),
            "wv": ("embed", "kv_flat"), "wo": ("heads_flat", "embed"),
            "bq": ("heads_flat",), "bk": ("kv_flat",), "bv": ("kv_flat",)}

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, (qd, kvd) = cfg.d_model, cfg.qkv_dims
        for name, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                            ("wo", (qd, d))):
            setattr(self, name, weight(gen, shape, cfg.dtype, device))
        self.bias = cfg.attn_bias
        if cfg.attn_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                setattr(self, name, frozen(torch.zeros((n,), dtype=cfg.dtype,
                                                       device=device)))

    def project(self, cfg: ModelConfig, x, lora=None):
        """(q, k, v) of x (b, s, d); ``lora=(a, b)`` adds ``x @ a @ b`` to q
        (zamba2's per-invocation LoRA)."""
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if lora is not None:
            q = q + x @ lora[0] @ lora[1]
        if self.bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        b, s, _ = x.shape
        return (q.reshape(b, s, cfg.n_heads, cfg.hd),
                k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
                v.reshape(b, s, cfg.n_kv_heads, cfg.hd))

    def query(self, cfg: ModelConfig, x):
        """q of x (b, s, d) alone (cross-attention's)."""
        q = x @ self.wq
        if self.bias:
            q = q + self.bq
        b, s, _ = x.shape
        return q.reshape(b, s, cfg.n_heads, cfg.hd)


def _ffn_module(cfg: ModelConfig, device, gen=None) -> nn.Module:
    if cfg.moe is not None:
        return moe_mod.MoE(cfg.d_model, cfg.moe, cfg.dtype, device, gen,
                           partition=cfg.moe_partition)
    if cfg.sparse_ffn is not None:
        return SparseFFN(cfg.d_model, cfg.d_ff, cfg.sparse_ffn, cfg.dtype, device, gen)
    if cfg.act == "gelu":
        return GeluFFN(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)
    return SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device, gen)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.ffn = _ffn_module(cfg, device, gen)


class DecoderBlock(nn.Module):
    """One decoder layer of the audio family: ``ln1`` and ``attn`` (causal
    self-attention), ``lnx`` and ``xattn`` (cross-attention over the
    encoder), ``ln2`` and ``ffn``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device, gen)
        self.lnx = Norm(cfg, cfg.d_model, device)
        self.xattn = Attention(cfg, device, gen)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        self.ffn = _ffn_module(cfg, device, gen)


class HybridLayer(nn.Module):
    """One Mamba-2 layer of a hybrid: its pre-norm ``ln`` and ``mamba``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln = Norm(cfg, cfg.d_model, device)
        self.mamba = m2.Mamba2(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                               dtype=cfg.dtype, device=device, gen=gen)


class LM(nn.Module):
    """Weights of a model: ``embed`` (V, d), ``unembed`` (d, V) with V the
    padded vocabulary, ``ln_f`` and ``blocks`` (transformer blocks, or
    RWKV-6 blocks for the ssm family).  A hybrid's ``blocks`` holds
    ``n_super`` groups of ``hybrid_period`` :class:`HybridLayer`; it also
    has ``shared`` (one :class:`Block`) and, with ``lora_rank``, ``lora_a``
    (n_super, d, r) and ``lora_b`` (n_super, r, qd; zeros at init, as the
    JAX package makes it).  An audio model has ``enc_blocks`` (``enc_layers``
    :class:`Block`), ``dec_blocks`` (``n_layers`` :class:`DecoderBlock`) and
    ``ln_enc`` in place of ``blocks``."""

    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "lora_a": (None, "embed", None), "lora_b": (None, None, "heads_flat")}

    def __init__(self, cfg: ModelConfig, device, gen: torch.Generator | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        V, d = cfg.vocab_padded, cfg.d_model
        self.embed = weight(gen, (V, d), cfg.dtype, device, init=embed_init)
        self.unembed = weight(gen, (d, V), cfg.dtype, device)
        self.ln_f = Norm(cfg, d, device)
        if _transformer(cfg):
            self.blocks = nn.ModuleList(Block(cfg, device, gen)
                                        for _ in range(cfg.n_layers))
        elif _hybrid(cfg):
            n_super = _n_super(cfg)
            self.blocks = nn.ModuleList(
                nn.ModuleList(HybridLayer(cfg, device, gen)
                              for _ in range(cfg.hybrid_period))
                for _ in range(n_super))
            self.shared = Block(cfg, device, gen)
            if cfg.lora_rank:
                self.lora_a = weight(gen, (n_super, d, cfg.lora_rank), cfg.dtype, device)
                self.lora_b = frozen(torch.zeros((n_super, cfg.lora_rank, cfg.qkv_dims[0]),
                                                 dtype=cfg.dtype, device=device))
        elif _audio(cfg):
            self.enc_blocks = nn.ModuleList(Block(cfg, device, gen)
                                            for _ in range(cfg.enc_layers))
            self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, device, gen)
                                            for _ in range(cfg.n_layers))
            self.ln_enc = Norm(cfg, d, device)
        else:
            self.blocks = nn.ModuleList(
                rw.RWKV6(d, cfg.d_ff, cfg.ssm_head_dim, cfg.dtype, device, gen)
                for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _n_super(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid_period


def _attention_layers(cfg: ModelConfig, model: LM) -> list:
    """(block, lora, Mamba-2 layers) for each application of attention: a
    transformer's blocks or an audio model's decoder blocks, with no LoRA
    and no Mamba-2 layer, or a hybrid's shared block once per super-block,
    with that super-block's LoRA and followed by its Mamba-2 layers.  Empty
    for RWKV-6."""
    if _transformer(cfg):
        return [(blk, None, ()) for blk in model.blocks]
    if _audio(cfg):
        return [(blk, None, ()) for blk in model.dec_blocks]
    if not _hybrid(cfg):
        return []
    return [(model.shared,
             (model.lora_a[i], model.lora_b[i]) if cfg.lora_rank else None, group)
            for i, group in enumerate(model.blocks)]


def _mamba(cfg: ModelConfig, layer: HybridLayer, h, st, step: bool = False):
    """h plus one Mamba-2 layer's output on its normed input from state
    ``st``; returns (h, new state)."""
    if step:
        y, new = m2.mamba2_apply_step(layer.mamba, layer.ln(h), st, cfg.ssm_state,
                                      cfg.ssm_head_dim)
    else:
        y, new = m2.mamba2_apply_seq(layer.mamba, layer.ln(h), st, cfg.ssm_state,
                                     cfg.ssm_head_dim, chunk=cfg.ssm_chunk)
    return h + y, new


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """A model with weights drawn from ``torch.Generator(device).manual_seed(seed)``
    on ``device`` (``"cuda"`` by default; raises without a card).
    ``device="meta"`` builds the module tree with no storage: the shapes
    and parameter count of a model too large for the host, as the JAX
    package's ``abstract_model`` gives them."""
    dev = resolve(device)
    if dev.type == "meta":
        return LM(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(cfg, dev, gen)


def trainable(model: nn.Module) -> dict[str, nn.Parameter]:
    """Make every floating parameter of ``model`` require grad and return
    them by name (``model.named_parameters()`` order): what an optimizer
    steps.  Serving models stay frozen; the bcsr FFN's index buffers are
    not parameters."""
    params = {}
    for name, p in model.named_parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
            params[name] = p
    return params


def param_axes(cfg: ModelConfig, model: LM) -> dict[str, tuple]:
    """The logical axes of every leaf of ``model.state_dict()``, by name:
    the JAX package's ``init_model(cfg)[1]`` annotations without the
    leading ``"layers"`` axes, since the port's leaves are per layer.  Each
    module class carries its weights' axes (``AXES``), copied from the JAX
    package's initialisers."""
    _check_supported(cfg)
    out = {}
    for name in model.state_dict():
        prefix, _, leaf = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        out[name] = owner.AXES[leaf]
    return out


def param_count(model: LM) -> int:
    """Entries of the model's state (weights and the block indices of a
    bcsr FFN), as the JAX package counts its parameter tree."""
    return sum(t.numel() for t in model.state_dict().values())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, p, x, aux: bool = True):
    """(y, auxiliary loss): the MoE's load-balance and z-losses, 0.0 for
    the other FFNs and with ``aux=False`` (the decode path drops it)."""
    if cfg.moe is not None:
        return moe_mod.moe_apply(p, x, cfg.moe, partition=cfg.moe_partition, aux=aux)
    if cfg.sparse_ffn is not None:
        return sparse_ffn_apply(p, x, cfg.sparse_ffn, cfg.d_ff), 0.0
    return p(x), 0.0


def _embed(cfg: ModelConfig, model: LM, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.embed_onehot:
        onehot = torch.nn.functional.one_hot(tokens, cfg.vocab_padded).to(cfg.dtype)
        return onehot @ model.embed
    return model.embed[tokens]


def _logits(model: LM, h: torch.Tensor) -> torch.Tensor:
    return model.ln_f(h) @ model.unembed


def _tokens(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device).long()


def _splice_vision(cfg: ModelConfig, h: torch.Tensor, batch) -> torch.Tensor:
    """A VLM's early fusion: ``batch["vision_embeds"]`` (b, n_vision_tokens,
    d) in place of the first n_vision_tokens token embeddings of h."""
    n = cfg.n_vision_tokens
    if cfg.family != "vlm" or not n:
        return h
    if h.shape[1] < n:
        raise ValueError(f"{cfg.arch_id}: a prompt of {h.shape[1]} tokens is shorter "
                         f"than its {n} vision slots")
    if batch.get("vision_embeds") is None:
        raise ValueError(f"{cfg.arch_id}: the batch has no vision_embeds (b, {n}, "
                         f"{cfg.d_model})")
    vis = torch.as_tensor(batch["vision_embeds"], device=h.device).to(h.dtype)
    return torch.cat([vis, h[:, n:]], dim=1)


def _positions(batch, b: int, s: int, device) -> torch.Tensor:
    """``batch["positions"]`` ((b, s), or (3, b, s) for M-RoPE), or arange."""
    pos = batch.get("positions")
    if pos is None:
        return torch.arange(s, device=device).expand(b, s)
    return torch.as_tensor(pos, device=device)


def _rotary(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) of the rotary angles at ``positions`` (b, s): M-RoPE's
    where the config has sections (a (b, s) positions array on all three
    streams), RoPE's otherwise; None for the audio family, which adds
    sinusoids instead."""
    if _audio(cfg):
        return None
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:
            positions = positions.expand(3, *positions.shape)
        return mrope(positions, cfg.hd, cfg.mrope_sections, cfg.rope_theta)
    return rope(positions, cfg.hd, cfg.rope_theta)


def _rotate(angles, q, k):
    if angles is None:
        return q, k
    cos, sin = angles
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _attn_seq(cfg: ModelConfig, p: Attention, x, angles, lora=None, causal: bool = True):
    """Full-sequence attention at the rotary ``angles`` of its positions
    (None: no rotation), with ``lora`` on q; returns (y, k, v)."""
    q, k, v = p.project(cfg, x, lora)
    q, k = _rotate(angles, q, k)
    s = x.shape[1]
    out = attn.flash_attention(
        q, k, v, causal=causal, window=cfg.sliding_window,
        q_chunk=min(cfg.attn_chunk, s), kv_chunk=min(cfg.attn_chunk, s),
        skip_masked_blocks=cfg.skip_masked_blocks,
        p_dtype=torch.bfloat16 if cfg.attn_p_bf16 else None,
    )
    return out.reshape(x.shape[0], s, -1) @ p.wo, k, v


def _cross_kv(cfg: ModelConfig, p: Attention, h_enc):
    """Cross-attention keys and values of the encoder output (no bias, as
    the JAX package projects them)."""
    b, f, _ = h_enc.shape
    return ((h_enc @ p.wk).reshape(b, f, cfg.n_kv_heads, cfg.hd),
            (h_enc @ p.wv).reshape(b, f, cfg.n_kv_heads, cfg.hd))


def _cross_attn(cfg: ModelConfig, blk: DecoderBlock, h, k, v, step: bool = False):
    """A decoder block's cross-attention of h (b, s, d) over the encoder's
    keys and values (b, F, kvh, hd), non-causal.  A decode step attends at
    q chunks of 1 with no window, as the JAX package's does."""
    q = blk.xattn.query(cfg, blk.lnx(h))
    b, s = h.shape[:2]
    out = attn.flash_attention(
        q, k, v, causal=False, window=None if step else cfg.sliding_window,
        q_chunk=1 if step else min(cfg.attn_chunk, s),
        kv_chunk=min(cfg.attn_chunk, k.shape[1]),
        p_dtype=torch.bfloat16 if cfg.attn_p_bf16 and not step else None,
    )
    return out.reshape(b, s, -1) @ blk.xattn.wo


def _add_sinusoids(cfg: ModelConfig, h, positions) -> torch.Tensor:
    """The audio decoder's absolute positions: h plus the sinusoids of
    ``positions`` (broadcastable to h's leading axes)."""
    return h + sinusoid(positions, cfg.d_model).to(h.dtype)


def _encode_audio(cfg: ModelConfig, model: LM, batch) -> torch.Tensor:
    """The whisper encoder over ``batch["frames"]`` (b, F, d_model), the
    precomputed frame embeddings, plus sinusoids: non-causal blocks, then
    ``ln_enc``."""
    frames = batch.get("frames")
    if frames is None:
        raise ValueError(f"{cfg.arch_id}: the batch has no frames (b, {cfg.enc_frames}, "
                         f"{cfg.d_model})")
    frames = torch.as_tensor(frames, device=model.device).to(cfg.dtype)
    h = _add_sinusoids(cfg, frames, torch.arange(frames.shape[1], device=model.device)[None])
    for blk in model.enc_blocks:
        y, _, _ = _attn_seq(cfg, blk.attn, blk.ln1(h), None, causal=False)
        h = h + y
        h = h + _ffn(cfg, blk.ffn, blk.ln2(h), aux=False)[0]
    return model.ln_enc(h)


def _remat(cfg: ModelConfig, fn, h: torch.Tensor):
    """fn(h), recomputed in the backward pass when ``cfg.remat == "full"``
    and grad mode is on (the JAX package's ``_maybe_remat``)."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(fn, h, use_reentrant=False)
    return fn(h)


def forward(cfg: ModelConfig, model: LM, batch) -> tuple[torch.Tensor, Any]:
    """Token logits (b, s, V) for ``batch["tokens"]`` (b, s), and the
    auxiliary loss summed over the layers (a float32 scalar tensor for a
    MoE model, 0.0 otherwise).  An audio batch adds ``frames`` (b, F, d),
    a VLM batch ``vision_embeds`` (b, n_vision_tokens, d) and, optionally,
    ``positions`` (3, b, s).  A hybrid's Mamba-2 layers each start from a
    zero state.  Runs under the caller's grad mode; the blocks that the
    JAX package rematerialises (a transformer or decoder block, an RWKV-6
    block, the hybrid's shared block and each Mamba-2 layer) go through
    :func:`_remat`."""
    _check_supported(cfg)
    dev = model.device
    tokens = _tokens(batch, dev)
    b, s = tokens.shape
    h = _splice_vision(cfg, _embed(cfg, model, tokens), batch)
    aux = 0.0
    if cfg.family == "ssm":
        st = rw.rwkv6_init_state(b, cfg.d_model, cfg.ssm_head_dim, dev)
        for blk in model.blocks:
            h = _remat(cfg, lambda x, blk=blk: rw.rwkv6_apply_seq(
                blk, x, st, cfg.ssm_head_dim)[0], h)
        return _logits(model, h), aux
    angles = _rotary(cfg, _positions(batch, b, s, dev))
    h_enc = None
    if _audio(cfg):
        h_enc = _encode_audio(cfg, model, batch)
        h = _add_sinusoids(cfg, h, torch.arange(s, device=dev)[None])
    st = _mamba_state0(cfg, b, dev)

    def block(blk, lora, x):
        y, _, _ = _attn_seq(cfg, blk.attn, blk.ln1(x), angles, lora)
        x = x + y
        if h_enc is not None:
            x = x + _cross_attn(cfg, blk, x, *_cross_kv(cfg, blk.xattn, h_enc))
        f, a = _ffn(cfg, blk.ffn, blk.ln2(x))
        return x + f, a

    for blk, lora, group in _attention_layers(cfg, model):
        h, a = _remat(cfg, functools.partial(block, blk, lora), h)
        aux = aux + a
        for layer in group:
            h = _remat(cfg, lambda x, layer=layer: _mamba(cfg, layer, x, st)[0], h)
    return _logits(model, h), aux


def loss_fn(cfg: ModelConfig, model: LM, batch, z_loss: float = 1e-4, *,
            denom: torch.Tensor | None = None, aux_weight: float = 1.0):
    """The JAX package's training loss: (total, {"ce", "z_loss", "aux",
    "tokens"}), float32 scalars (float64 for a float64 model).  Logits in
    float32, pad columns at -1e30,
    cross-entropy of ``batch["labels"]`` (b, s) over the positions whose
    label is >= 0 (a negative label is masked; its gold logit is read at
    id 0), ``z_loss`` times the mean squared log-partition over them, plus
    the MoE's auxiliary loss.

    A shard of a data-split batch passes ``denom``, the whole batch's count
    of unmasked labels (at least 1; a device scalar), which its masked sums
    divide by in place of its own count, and ``aux_weight``, its share of
    the batch's rows, which weights its auxiliary loss (a mean over rows):
    the shards' totals then add up to the whole batch's."""
    logits, aux = forward(cfg, model, batch)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = upcast(logits)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(logits.dtype)
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    ce = ((lse - gold) * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    if aux_weight != 1.0:
        aux = aux * aux_weight
    total = ce + zl + aux
    aux = aux if isinstance(aux, torch.Tensor) else torch.zeros_like(ce) + aux
    return total, {"ce": ce, "z_loss": zl, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def _slots(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def _mamba_state0(cfg: ModelConfig, batch: int, device) -> dict | None:
    """A hybrid's zero Mamba-2 state for one layer (None for the others)."""
    if not _hybrid(cfg):
        return None
    return m2.mamba2_init_state(batch, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                                device=device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Every layer's decode state, stacked: the KV caches of a transformer
    (slots = max_seq, or the window for a sliding-window model: a ring),
    with an audio model's cross-attention keys and values (zeros until
    :func:`prefill` writes them), RWKV-6's float32 recurrent state
    (``max_seq`` unused), or a hybrid's shared-block caches (one per
    super-block) and its float32 Mamba-2 states (n_super, period, batch,
    ...)."""
    _check_supported(cfg)
    dev = resolve(device)
    if cfg.family == "ssm":
        L = cfg.n_layers
        st = rw.rwkv6_init_state(batch, cfg.d_model, cfg.ssm_head_dim, dev)
        return {"rwkv": {key: t.expand(L, *t.shape).clone() for key, t in st.items()}}
    L = _n_super(cfg) if _hybrid(cfg) else cfg.n_layers
    S = _slots(cfg, max_seq)
    shape = (L, batch, S, cfg.n_kv_heads, cfg.hd)
    state = {"kv": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "positions": torch.full((L, batch, S), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((L, batch), dtype=torch.int32, device=dev),
    }}
    if _hybrid(cfg):
        state["mamba"] = {key: t.expand(L, cfg.hybrid_period, *t.shape).clone()
                          for key, t in _mamba_state0(cfg, batch, dev).items()}
    if _audio(cfg):
        cross = (L, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
        state["cross"] = {key: torch.zeros(cross, dtype=cfg.dtype, device=dev)
                          for key in ("k", "v")}
    return state


def _layer_state(state: dict, group: str, *index: int) -> dict:
    """Views of one layer's leaves of a state group (``index``: the layer,
    or a hybrid's super-block and layer), which ``copy_`` writes through."""
    return {key: t[index] for key, t in state[group].items()}


def _set(st: dict, new: dict) -> None:
    for key, t in st.items():
        t.copy_(new[key])


@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, batch, max_seq: int):
    """Run the whole prompt once: (decode state at position s, last-token
    logits (b, V)).  Each attention puts its last ``slots`` keys and values
    into its cache at slot = position mod slots; RWKV-6 and Mamba-2 keep
    each layer's state after the last token; an audio model runs its
    encoder over ``batch["frames"]`` and keeps each decoder layer's
    cross-attention keys and values.  The batch keys are
    :func:`forward`'s."""
    _check_supported(cfg)
    dev = model.device
    tokens = _tokens(batch, dev)
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_seq, dev)
    h = _splice_vision(cfg, _embed(cfg, model, tokens), batch)
    if cfg.family == "ssm":
        st0 = rw.rwkv6_init_state(b, cfg.d_model, cfg.ssm_head_dim, dev)
        for i, blk in enumerate(model.blocks):
            h, st = rw.rwkv6_apply_seq(blk, h, st0, cfg.ssm_head_dim)
            _set(_layer_state(state, "rwkv", i), st)
        return state, _logits(model, h[:, -1:])[:, -1]
    slots = _slots(cfg, max_seq)
    take = min(slots, s)
    pos_ids = torch.arange(s - take, s, device=dev)
    slot_ids = pos_ids % slots
    angles = _rotary(cfg, _positions(batch, b, s, dev))
    if _audio(cfg):
        h_enc = _encode_audio(cfg, model, batch)
        h = _add_sinusoids(cfg, h, torch.arange(s, device=dev)[None])
    st0 = _mamba_state0(cfg, b, dev)
    for i, (blk, lora, group) in enumerate(_attention_layers(cfg, model)):
        y, k, v = _attn_seq(cfg, blk.attn, blk.ln1(h), angles, lora)
        cache = _layer_state(state, "kv", i)
        cache["k"][:, slot_ids] = k[:, -take:].to(cfg.dtype)
        cache["v"][:, slot_ids] = v[:, -take:].to(cfg.dtype)
        cache["positions"][:, slot_ids] = pos_ids.to(torch.int32)
        cache["pos"].fill_(s)
        h = h + y
        if _audio(cfg):
            cross = _layer_state(state, "cross", i)
            _set(cross, dict(zip(("k", "v"), _cross_kv(cfg, blk.xattn, h_enc))))
            h = h + _cross_attn(cfg, blk, h, cross["k"], cross["v"])
        h = h + _ffn(cfg, blk.ffn, blk.ln2(h), aux=False)[0]
        for j, layer in enumerate(group):
            h, st = _mamba(cfg, layer, h, st0)
            _set(_layer_state(state, "mamba", i, j), st)
    return state, _logits(model, h[:, -1:])[:, -1]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, state: dict, tokens):
    """One new token for every sequence: ``tokens`` (b, 1).  Appends each
    attention's key and value to ``state``, and advances each layer's
    recurrent state, in place; returns (state, logits (b, 1, V)).  An
    audio model adds the sinusoid of each sequence's position and attends
    over its stored cross keys and values; a VLM rotates every M-RoPE
    stream by the cache's position."""
    _check_supported(cfg)
    tokens = _tokens({"tokens": tokens}, model.device)
    b = tokens.shape[0]
    h = _embed(cfg, model, tokens)
    if cfg.family == "ssm":
        for i, blk in enumerate(model.blocks):
            st = _layer_state(state, "rwkv", i)
            h, new = rw.rwkv6_apply_step(blk, h, st, cfg.ssm_head_dim)
            _set(st, new)
        return state, _logits(model, h)
    # every layer's cache sits at the same positions: one set of angles
    pos = state["kv"]["pos"][0][:, None]
    angles = _rotary(cfg, pos)
    if _audio(cfg):
        h = _add_sinusoids(cfg, h, pos)
    for i, (blk, lora, group) in enumerate(_attention_layers(cfg, model)):
        cache = _layer_state(state, "kv", i)
        p = blk.attn
        q, k, v = p.project(cfg, blk.ln1(h), lora)
        q, k = _rotate(angles, q, k)
        attn.update_kv_cache(cache, k, v)
        out = attn.decode_attention(q, cache, window=cfg.sliding_window)
        h = h + out.reshape(b, 1, -1) @ p.wo
        if _audio(cfg):
            h = h + _cross_attn(cfg, blk, h, state["cross"]["k"][i],
                                state["cross"]["v"][i], step=True)
        h = h + _ffn(cfg, blk.ffn, blk.ln2(h), aux=False)[0]
        for j, layer in enumerate(group):
            st = _layer_state(state, "mamba", i, j)
            h, new = _mamba(cfg, layer, h, st, step=True)
            _set(st, new)
    return state, _logits(model, h)

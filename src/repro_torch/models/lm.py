"""The language model of the port: the dense, MoE and RWKV-6 families.

A transformer decoder (dense and moe families) is ``n_layers`` blocks of
RMSNorm → attention with RoPE, GQA, QKV bias and sliding windows →
RMSNorm → FFN.  The FFN is dense SwiGLU, GELU, the block-sparse FFN through
the BCSR kernel (``cfg.sparse_ffn``), or, when ``cfg.moe`` is set, the
capacity-dropped mixture of experts (``models.moe``).  The ssm family
(``ssm_kind="rwkv6"``) is ``n_layers`` RWKV-6 blocks (``models.rwkv6``).
Layers are an ``nn.ModuleList``; the JAX package scans a stacked parameter
tree instead.  The hybrid, audio and VLM families raise
``NotImplementedError`` naming their ROADMAP item.

Entry points mirror the JAX package's: :func:`init_model`, :func:`forward`,
:func:`prefill`, :func:`decode_step`, :func:`init_decode_state` and
:func:`param_count`.  Each takes the model and a config; the config decides
the execution tier of the sparse FFN, so a server can re-route a model's
FFN (``impl="auto"``) without touching its weights.  The decode state keeps
the JAX package's stacked layout, every leaf with the layers axis first and
the batch axis second: ``{"kv": {"k", "v": (L, B, S, kvh, hd), "positions":
(L, B, S), "pos": (L, B)}}`` for the transformers, ``{"rwkv": {"tm_shift",
"cm_shift": (L, B, d), "wkv": (L, B, H, hd, hd)}}`` (float32) for RWKV-6.
:func:`decode_step` updates it in place.  Models serve under
``torch.no_grad``; their parameters do not require gradients (``loss_fn``
waits for training).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.device import resolve

from . import attention as attn
from . import moe as moe_mod
from . import rwkv6 as rw
from .common import apply_rope, embed_init, frozen, layer_norm, rms_norm, rope, weight
from .ffn import GeluFFN, SparseFFN, SparseFFNConfig, SwiGLU, sparse_ffn_apply

__all__ = ["ModelConfig", "LM", "init_model", "forward", "prefill",
           "decode_step", "init_decode_state", "param_count"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the JAX package's ``ModelConfig``, so a configuration
    file copies across unchanged.  On one card the sharding and
    rematerialisation fields (``remat``, ``moe_partition``,
    ``attn_dp_only``, ``fsdp_gather_weights``) are accepted and have no
    effect; the fields of unported families are read only to refuse them.
    ``moe`` is a :class:`~repro_torch.models.moe.MoEConfig`."""

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


_WAITS = {
    "hybrid": "ROADMAP A.5.3 (hybrid, zamba2/mamba2)",
    "audio": "ROADMAP A.5.4 (audio, whisper)",
    "vlm": "ROADMAP A.5.5 (VLM, M-RoPE)",
}


def _transformer(cfg: ModelConfig) -> bool:
    return cfg.family in ("dense", "moe")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.mrope_sections:
        fam = "vlm"
    elif _transformer(cfg) or (cfg.family == "ssm" and cfg.ssm_kind == "rwkv6"):
        return
    else:
        fam = cfg.family
    kind = f" ({cfg.ssm_kind})" if fam == "ssm" else ""
    raise NotImplementedError(
        f"{cfg.arch_id}: the {fam}{kind} family is not ported yet; it waits for "
        f"{_WAITS.get(fam, 'ROADMAP A.5')}")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, dim: int, device):
        super().__init__()
        self.layer = cfg.norm == "layernorm"
        self.g = frozen(torch.ones((dim,), dtype=cfg.dtype, device=device))
        if self.layer:
            self.b = frozen(torch.zeros((dim,), dtype=cfg.dtype, device=device))

    def forward(self, x):
        return layer_norm(x, self.g, self.b) if self.layer else rms_norm(x, self.g)


class Attention(nn.Module):
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

    def project(self, cfg: ModelConfig, x):
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        b, s, _ = x.shape
        return (q.reshape(b, s, cfg.n_heads, cfg.hd),
                k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
                v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device, gen)
        self.ln2 = Norm(cfg, cfg.d_model, device)
        if cfg.moe is not None:
            self.ffn = moe_mod.MoE(cfg.d_model, cfg.moe, cfg.dtype, device, gen,
                                   partition=cfg.moe_partition)
        elif cfg.sparse_ffn is not None:
            self.ffn = SparseFFN(cfg.d_model, cfg.d_ff, cfg.sparse_ffn, cfg.dtype,
                                 device, gen)
        elif cfg.act == "gelu":
            self.ffn = GeluFFN(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, device, gen)


class LM(nn.Module):
    """Weights of a model: ``embed`` (V, d), ``unembed`` (d, V) with V the
    padded vocabulary, ``ln_f`` and ``blocks`` (transformer blocks, or
    RWKV-6 blocks for the ssm family)."""

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
        else:
            self.blocks = nn.ModuleList(
                rw.RWKV6(d, cfg.d_ff, cfg.ssm_head_dim, cfg.dtype, device, gen)
                for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """A model with weights drawn from ``torch.Generator(device).manual_seed(seed)``
    on ``device`` (``"cuda"`` by default; raises without a card)."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(cfg, dev, gen)


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


def _attn_seq(cfg: ModelConfig, p: Attention, x, cos, sin):
    """Full-sequence causal attention at the rotary angles (cos, sin) of
    its positions; returns (y, k, v)."""
    q, k, v = p.project(cfg, x)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    s = x.shape[1]
    out = attn.flash_attention(
        q, k, v, causal=True, window=cfg.sliding_window,
        q_chunk=min(cfg.attn_chunk, s), kv_chunk=min(cfg.attn_chunk, s),
        skip_masked_blocks=cfg.skip_masked_blocks,
        p_dtype=torch.bfloat16 if cfg.attn_p_bf16 else None,
    )
    return out.reshape(x.shape[0], s, -1) @ p.wo, k, v


@torch.no_grad()
def forward(cfg: ModelConfig, model: LM, batch) -> tuple[torch.Tensor, Any]:
    """Token logits (b, s, V) for ``batch["tokens"]`` (b, s), and the
    auxiliary loss summed over the layers (a float32 scalar tensor for a
    MoE model, 0.0 otherwise)."""
    _check_supported(cfg)
    tokens = _tokens(batch, model.device)
    b, s = tokens.shape
    h = _embed(cfg, model, tokens)
    aux = 0.0
    if not _transformer(cfg):
        st = rw.rwkv6_init_state(b, cfg.d_model, cfg.ssm_head_dim, model.device)
        for blk in model.blocks:
            h, _ = rw.rwkv6_apply_seq(blk, h, st, cfg.ssm_head_dim)
        return _logits(model, h), aux
    cos, sin = rope(torch.arange(s, device=model.device).expand(b, s), cfg.hd,
                    cfg.rope_theta)
    for blk in model.blocks:
        y, _, _ = _attn_seq(cfg, blk.attn, blk.ln1(h), cos, sin)
        h = h + y
        f, a = _ffn(cfg, blk.ffn, blk.ln2(h))
        h, aux = h + f, aux + a
    return _logits(model, h), aux


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------
def _slots(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> dict:
    """Every layer's decode state, stacked: the KV caches of a transformer
    (slots = max_seq, or the window for a sliding-window model: a ring), or
    RWKV-6's float32 recurrent state (``max_seq`` unused)."""
    _check_supported(cfg)
    dev = resolve(device)
    L = cfg.n_layers
    if not _transformer(cfg):
        st = rw.rwkv6_init_state(batch, cfg.d_model, cfg.ssm_head_dim, dev)
        return {"rwkv": {key: t.expand(L, *t.shape).clone() for key, t in st.items()}}
    S = _slots(cfg, max_seq)
    shape = (L, batch, S, cfg.n_kv_heads, cfg.hd)
    return {"kv": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "positions": torch.full((L, batch, S), -1, dtype=torch.int32, device=dev),
        "pos": torch.zeros((L, batch), dtype=torch.int32, device=dev),
    }}


def _layer_state(state: dict, group: str, i: int) -> dict:
    return {key: t[i] for key, t in state[group].items()}


@torch.no_grad()
def prefill(cfg: ModelConfig, model: LM, batch, max_seq: int):
    """Run the whole prompt once: (decode state at position s, last-token
    logits (b, V)).  A transformer puts each layer's last ``slots`` keys and
    values into its cache at slot = position mod slots; RWKV-6 keeps each
    layer's state after the last token."""
    _check_supported(cfg)
    tokens = _tokens(batch, model.device)
    b, s = tokens.shape
    dev = model.device
    state = init_decode_state(cfg, b, max_seq, dev)
    h = _embed(cfg, model, tokens)
    if not _transformer(cfg):
        st0 = rw.rwkv6_init_state(b, cfg.d_model, cfg.ssm_head_dim, dev)
        for i, blk in enumerate(model.blocks):
            h, st = rw.rwkv6_apply_seq(blk, h, st0, cfg.ssm_head_dim)
            for key, t in _layer_state(state, "rwkv", i).items():
                t.copy_(st[key])
        return state, _logits(model, h[:, -1:])[:, -1]
    slots = _slots(cfg, max_seq)
    take = min(slots, s)
    pos_ids = torch.arange(s - take, s, device=dev)
    slot_ids = pos_ids % slots
    cos, sin = rope(torch.arange(s, device=dev).expand(b, s), cfg.hd, cfg.rope_theta)
    for i, blk in enumerate(model.blocks):
        y, k, v = _attn_seq(cfg, blk.attn, blk.ln1(h), cos, sin)
        cache = _layer_state(state, "kv", i)
        cache["k"][:, slot_ids] = k[:, -take:].to(cfg.dtype)
        cache["v"][:, slot_ids] = v[:, -take:].to(cfg.dtype)
        cache["positions"][:, slot_ids] = pos_ids.to(torch.int32)
        cache["pos"].fill_(s)
        h = h + y
        h = h + _ffn(cfg, blk.ffn, blk.ln2(h), aux=False)[0]
    return state, _logits(model, h[:, -1:])[:, -1]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: LM, state: dict, tokens):
    """One new token for every sequence: ``tokens`` (b, 1).  Appends each
    layer's key and value to ``state``, or advances each layer's recurrent
    state, in place; returns (state, logits (b, 1, V))."""
    _check_supported(cfg)
    tokens = _tokens({"tokens": tokens}, model.device)
    b = tokens.shape[0]
    h = _embed(cfg, model, tokens)
    if not _transformer(cfg):
        for i, blk in enumerate(model.blocks):
            st = _layer_state(state, "rwkv", i)
            h, new = rw.rwkv6_apply_step(blk, h, st, cfg.ssm_head_dim)
            for key, t in st.items():
                t.copy_(new[key])
        return state, _logits(model, h)
    # every layer's cache sits at the same positions: one set of angles
    cos, sin = rope(state["kv"]["pos"][0][:, None], cfg.hd, cfg.rope_theta)
    for i, blk in enumerate(model.blocks):
        cache = _layer_state(state, "kv", i)
        p = blk.attn
        q, k, v = p.project(cfg, blk.ln1(h))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        attn.update_kv_cache(cache, k, v)
        out = attn.decode_attention(q, cache, window=cfg.sliding_window)
        h = h + out.reshape(b, 1, -1) @ p.wo
        h = h + _ffn(cfg, blk.ffn, blk.ln2(h), aux=False)[0]
    return state, _logits(model, h)

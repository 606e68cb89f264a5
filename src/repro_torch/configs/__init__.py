"""Architecture registry of the port: the JAX package's ten language
models (``repro_torch.models.lm``): dense (h2o-danube-3-4b, deepseek-67b,
llama3-405b, qwen1.5-4b), moe (granite-moe-1b-a400m,
llama4-scout-17b-a16e), ssm (rwkv6-7b), hybrid (zamba2-2.7b), audio
(whisper-tiny) and vlm (qwen2-vl-72b).  deepseek-67b, llama3-405b and
qwen2-vl-72b do not fit one card whole.  Each configuration file is the
JAX package's own, copied unchanged but for its imports
(``sparse_suite`` is the paper's own matrix workload, not a model).

The shape grid of the dry run (``launch.dryrun``) is the JAX package's:
every (architecture x shape) cell is made concrete by ``input_specs(cfg,
shape)``, which returns tensors on the ``meta`` device (shapes and dtypes,
no storage) for every input of the step that cell runs (train_4k -> the
train step, prefill_32k -> ``prefill``, decode_32k / long_500k ->
``decode_step``), where the JAX package returns ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.lm import ModelConfig, init_decode_state

__all__ = ["ARCH_IDS", "get_config", "get_reduced", "ShapeSpec", "SHAPES", "SHAPE_NAMES",
           "is_subquadratic", "cell_supported", "input_specs"]

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-67b": "deepseek_67b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-4b": "qwen1_5_4b",
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "whisper-tiny": "whisper_tiny",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}
ARCH_IDS = list(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; the port serves "
                       f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration, at full width and depth."""
    return _mod(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    """A few layers at narrow widths, for tests and CPU runs."""
    return _mod(arch_id).REDUCED


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
SHAPE_NAMES = list(SHAPES)


def is_subquadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k only runs on sub-quadratic archs (DESIGN.md §5)."""
    if shape_name == "long_500k" and not is_subquadratic(cfg):
        return False, "pure full attention — long_500k skipped per spec"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_extras(cfg: ModelConfig, batch: int, seq: int) -> dict:
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = _meta((batch, cfg.enc_frames, cfg.d_model), torch.float32)
    if cfg.family == "vlm" and cfg.n_vision_tokens:
        extras["vision_embeds"] = _meta((batch, cfg.n_vision_tokens, cfg.d_model),
                                        torch.float32)
        extras["positions"] = _meta((3, batch, seq), torch.int32)
    return extras


def input_specs(cfg: ModelConfig, shape_name: str | ShapeSpec) -> dict:
    """Meta-tensor stand-ins for the cell's step inputs: ``{"batch": {...}}``
    for train and prefill cells (int32 ``tokens`` and, to train,
    ``labels`` (batch, seq); audio ``frames``, VLM ``vision_embeds`` and
    ``positions``), ``{"state", "tokens"}`` for decode cells (the decode
    state of ``init_decode_state(..., device="meta")`` and int32 tokens
    (batch, 1)).  ``shape_name`` may also be a :class:`ShapeSpec` off the
    grid (tests use small ones)."""
    sh = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    if sh.kind == "train":
        batch = {"tokens": _meta((sh.batch, sh.seq), torch.int32),
                 "labels": _meta((sh.batch, sh.seq), torch.int32)}
        batch.update(_batch_extras(cfg, sh.batch, sh.seq))
        return {"batch": batch}
    if sh.kind == "prefill":
        batch = {"tokens": _meta((sh.batch, sh.seq), torch.int32)}
        batch.update(_batch_extras(cfg, sh.batch, sh.seq))
        return {"batch": batch}
    if sh.kind == "decode":
        return {"state": init_decode_state(cfg, sh.batch, sh.seq, device="meta"),
                "tokens": _meta((sh.batch, 1), torch.int32)}
    raise ValueError(sh.kind)

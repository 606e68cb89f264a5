"""Architecture registry of the port: the JAX package's ten language
models (``repro_torch.models.lm``): dense (h2o-danube-3-4b, deepseek-67b,
llama3-405b, qwen1.5-4b), moe (granite-moe-1b-a400m,
llama4-scout-17b-a16e), ssm (rwkv6-7b), hybrid (zamba2-2.7b), audio
(whisper-tiny) and vlm (qwen2-vl-72b).  deepseek-67b, llama3-405b and
qwen2-vl-72b do not fit one card whole.  The JAX package's shape grid and
dry-run input specs wait for the dry-run tools' counterpart.  Each
configuration file is the JAX package's own, copied unchanged but for its
imports.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_reduced"]

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

"""Architecture registry of the port: the configurations it serves.

The language models of the families the port runs are registered
(``repro_torch.models.lm``): dense (qwen1.5-4b, h2o-danube-3-4b), moe
(granite-moe-1b-a400m, llama4-scout-17b-a16e), ssm (rwkv6-7b) and hybrid
(zamba2-2.7b).  The audio and VLM families of the JAX package's registry
wait for their slices, and so do its shape grid and dry-run input specs.  Each
configuration file is the JAX package's own, copied unchanged but for its
imports.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_reduced"]

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-2.7b": "zamba2_2_7b",
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

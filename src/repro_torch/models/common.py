"""Shared model helpers: initialisers, norms, rotary and sinusoidal
positions, and the mesh rules.

The JAX package's ``models.common`` holds parameter-with-logical-axes
leaves (``Px``); the port's parameters are ``nn.Module`` attributes, and
their logical axes come from :func:`repro_torch.models.lm.param_axes`.
:class:`MeshRules` maps those axes to mesh axes as the JAX package's does,
with a plain tuple per leaf where the JAX package builds a
``PartitionSpec``; its activation hint ``shard()`` is a GSPMD constraint
with no counterpart in the port's sharded step (ROADMAP A).  Norms, RoPE
and M-RoPE compute in float32 and cast back, as the JAX package does.

Initialisers draw from a seeded ``torch.Generator`` on the target device.
They give other numbers than ``jax.random`` for the same seed, so parity
tests carry the JAX package's weights across
(:func:`repro_torch.interop.lm_params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

__all__ = [
    "MeshRules",
    "default_rules",
    "DEFAULT_RULES",
    "set_active_rules",
    "spec_entry",
    "upcast",
    "dense_init",
    "embed_init",
    "frozen",
    "weight",
    "rms_norm",
    "layer_norm",
    "rope",
    "apply_rope",
    "mrope",
    "apply_mrope",
    "sinusoid",
    "sinusoidal_positions",
]


def spec_entry(axes):
    """A spec entry in ``PartitionSpec``'s normal form: a tuple of one mesh
    axis is that axis, an empty tuple is None."""
    if isinstance(axes, tuple):
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical axis -> mesh axis (or tuple of mesh axes) mapping."""

    rules: dict[str, Any]

    def spec(self, axes: tuple[str | None, ...]) -> tuple:
        """One entry per dimension: the mesh axis (or tuple of axes) that
        shards it, or None."""
        return tuple(spec_entry(self.rules.get(a)) if a else None for a in axes)

    def tree_specs(self, axes_tree: dict) -> dict:
        """``{name: logical axes}`` (nested dicts allowed) -> ``{name: spec}``."""
        return {k: self.tree_specs(v) if isinstance(v, dict) else self.spec(v)
                for k, v in axes_tree.items()}


def default_rules(multi_pod: bool) -> MeshRules:
    """The JAX package's table: the batch over ``("pod", "data")`` or
    ``("data",)``, ``embed`` over data (FSDP), the projections' heads,
    the MLP, the vocabulary and the experts over ``model``."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshRules(
        rules={
            "batch": batch_axes,
            "embed": "data",  # fsdp
            "heads_flat": "model",
            "kv_flat": "model",
            "mlp": "model",
            "vocab": "model",
            "experts": "model",
            "act_model": "model",  # activation constraint on tp'd dims
        }
    )


DEFAULT_RULES = default_rules(multi_pod=False)

# What launch code installs process-wide, as the JAX package's holder.
_ACTIVE_RULES: list[MeshRules] = [DEFAULT_RULES]


def set_active_rules(rules: MeshRules) -> None:
    _ACTIVE_RULES[0] = rules


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (the matmul weights' default): N(0, 1)
    cut at +-2, times ``scale`` or 1/sqrt(fan_in), drawn in float32 on the
    generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    value = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return value.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    value = torch.empty(shape, dtype=torch.float32, device=gen.device)
    value.normal_(0.0, 1.0, generator=gen)
    return value.mul_(0.02).to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient until ``lm.trainable`` asks for
    one: a model is built to serve."""
    return nn.Parameter(t, requires_grad=False)


def weight(gen: torch.Generator | None, shape, dtype, device, init=dense_init,
           **kw) -> nn.Parameter:
    """A frozen parameter drawn by ``init`` from ``gen``, or, with no
    generator, left empty on ``device`` to be filled from a carried state."""
    if gen is None:
        return frozen(torch.empty(shape, dtype=dtype, device=device))
    return frozen(init(gen, shape, dtype, **kw))


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x in float32, the precision the models take norms, rotations,
    attention statistics and the loss in, or x itself when it is float64:
    a float64 copy of a model computes in float64 throughout (an oracle
    for its float32 gradients)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = upcast(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * upcast(gamma)).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    xf = upcast(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * upcast(gamma) + upcast(beta)).to(x.dtype)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions (...,) int -> (cos, sin) each (..., head_dim // 2) float32."""
    half = head_dim // 2
    # a Python float base: no host-to-device copy (which would synchronise)
    freqs = float(theta) ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, s, h, d); cos/sin (b, s, d // 2) -> x rotated (half-split pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = upcast(x[..., :half]), upcast(x[..., half:])
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mrope(positions: torch.Tensor, head_dim: int, sections, theta: float = 10000.0):
    """Multimodal RoPE angles (Qwen2-VL): positions (3, b, s) int, the t, h
    and w streams -> (cos, sin) each (b, s, head_dim // 2) float32, where
    the rotary pairs of section i (``sections`` splits head_dim // 2, e.g.
    (16, 24, 24)) turn at stream i's positions."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim // 2 "
                         f"= {half}")
    freqs = float(theta) ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    pos = positions.float()
    starts = [sum(sections[:i]) for i in range(len(sections))]
    angles = torch.cat([pos[i][..., None] * freqs[a:a + w]
                        for i, (a, w) in enumerate(zip(starts, sections))], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections,
                theta: float = 10000.0) -> torch.Tensor:
    """x (b, s, h, d) rotated at the M-RoPE angles of positions (3, b, s)."""
    return apply_rope(x, *mrope(positions, x.shape[-1], sections, theta))


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings of positions (...,) ->
    (..., dim) float32.  The frequencies are exp(-ln(10000) i / (half - 1))
    in float32; the Python float of ln(10000) rounds to the float32 that
    the JAX package's ``jnp.log(10000.0)`` gives."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    angles = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, dim) float32."""
    return sinusoid(torch.arange(seq, device=device), dim)

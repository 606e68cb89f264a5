"""AdamW with configurable state dtypes, the JAX package's ``optim.adamw``.

The state mirrors the parameters, keyed by the model's parameter names:
``{"m", "v"}`` in ``moment_dtype`` (bfloat16 halves optimizer memory),
``"count"`` (an int32 scalar) and, with ``master_fp32``, ``"master"``, a
float32 copy of each parameter that the update steps instead of the
parameter's own dtype.

The arithmetic is the JAX package's, in float32: clip by the global norm
(the clipped gradient cast back to the gradient's dtype, so a bf16
gradient is rounded to bf16 there), ``count + 1``, the bias corrections,
decoupled weight decay on the base (the master copy or the parameter), and
the cast back to the parameter's dtype.  Where the JAX package returns new
trees from a step that donates its inputs, :func:`adamw_update` writes the
parameters and the state in place, one leaf at a time, so a step holds at
most a few float32 temporaries of the largest leaf beside them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

__all__ = ["OptimConfig", "lr_schedule", "adamw_init", "global_norm",
           "clip_by_global_norm", "step_scalars", "update_leaf", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32
    master_fp32: bool = False  # keep a float32 master copy of bf16 params


def lr_schedule(cfg: OptimConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``lr_min_ratio * lr_peak``; a
    float32 scalar on ``step``'s device (``step`` an int or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def adamw_init(params: Mapping[str, torch.Tensor], cfg: OptimConfig) -> dict:
    """Zero moments for every leaf of ``params`` (name -> tensor), a zero
    count on their device, and the float32 master copy if asked for."""
    params = dict(params)
    dev = next(iter(params.values())).device if params else torch.device("cpu")
    with torch.no_grad():
        state = {
            "m": {k: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if cfg.master_fp32:
            state["master"] = {k: p.detach().to(torch.float32, copy=True)
                               for k, p in params.items()}
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (each leaf's 2-norm taken in float32 without a float32 copy of it)."""
    sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square()
             for g in tree.values())
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """g scaled in float32 and cast back to g's dtype (a new tensor)."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(clipped grads, global norm): each leaf times min(1, max_norm /
    norm), computed in float32 and cast back to the leaf's dtype."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: _clipped(g, scale) for k, g in grads.items()}, norm


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t itself if float32 (to be written in place), else a float32 copy."""
    return t if t.dtype == torch.float32 else t.float()


def step_scalars(count: torch.Tensor, norm: torch.Tensor, cfg: OptimConfig) -> dict:
    """Advance ``count`` by one in place and return the step's device
    scalars: the clip ``scale`` from the global ``norm``, ``lr`` and the
    bias corrections ``b1c`` and ``b2c`` (float32, on ``count``'s device)."""
    count.add_(1)
    return {"scale": _clip_scale(norm, cfg.clip_norm), "lr": lr_schedule(cfg, count),
            "b1c": 1 - cfg.b1 ** count.float(), "b2c": 1 - cfg.b2 ** count.float()}


@torch.no_grad()
def update_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                master: torch.Tensor | None, k: Mapping[str, torch.Tensor],
                cfg: OptimConfig) -> None:
    """One leaf's AdamW update in place (``p``, ``m``, ``v`` and ``master``
    when given) from its gradient ``g`` and :func:`step_scalars` ``k``.
    The arithmetic is elementwise, so a block of a leaf updated alone gets
    the bits the whole leaf's update gives it."""
    # the clipped gradient, rounded to g's dtype as the JAX package does
    gf = g * k["scale"] if g.dtype == torch.float32 else _clipped(g, k["scale"]).float()
    m32 = _f32(m).mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
    v32 = _f32(v).mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
    del gf
    step = (m32 / k["b1c"]).div_((v32 / k["b2c"]).sqrt_().add_(cfg.eps))
    base = master if master is not None else _f32(p)
    step.add_(base, alpha=cfg.weight_decay).mul_(k["lr"])
    base.sub_(step)  # the master copy, p itself (float32) or p's float32 copy
    if base is not p:
        p.copy_(base)
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict,
                 params: Mapping[str, torch.Tensor], cfg: OptimConfig):
    """One AdamW step, in place: writes ``params`` and ``state``; returns
    (params, state, {"lr", "grad_norm"}) with the metrics as float32
    scalars on the device.  ``grads`` is keyed as ``params``; it is read,
    not written."""
    norm = global_norm(grads)
    k = step_scalars(state["count"], norm, cfg)
    master = state.get("master") if cfg.master_fp32 else None
    for name, p in params.items():
        update_leaf(p, grads[name], state["m"][name], state["v"][name],
                    master[name] if master is not None else None, k, cfg)
    return params, state, {"lr": k["lr"], "grad_norm": norm}

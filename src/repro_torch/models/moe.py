"""Mixture-of-Experts with capacity-dropped, scatter-based token dispatch.

The router builds a sparse (tokens x experts) assignment; each batch row's
tokens are ranked within their experts, the first C of each expert are
scattered into a (E·C + 1, d) dispatch buffer, the experts run as three
batched products over it, and the combine gathers each kept slot's output
back, weighted by its gate.  Capacity per (row, expert) is
C = ceil(s · top_k · capacity_factor / E); an expert's slots past C drop
to a zero contribution (their gate weight is lost), as in the JAX package.

Plain torch, as the JAX package writes the serving path in ``jnp``: the
dispatch has fixed shapes (C depends only on s) and reads no device value
on the host, so a decode step and a prefill run as CUDA graphs.  The
top-k ranks in ``jax.lax.top_k``'s order (largest first, the lower expert
on a tie), since the slot order t·k + j decides which slots an expert
keeps.  Kept slots scatter into distinct rows of the buffer; dropped slots
all add into its last row, which is discarded, so only that row depends on
the order of the device's atomic adds.

:func:`moe_apply_spmspv` serves the combine through the sparse stack
(``fmt="spmspv"``, the SpMSpV kernel on a card): per token, its kept
(dest, weight) pairs are a sparse right-hand side of the (d × E·C+1)
slot-output operand.  It is host-side per token, for tests and the smoke
test; the serving path is :func:`moe_apply`.

``partition`` (``"ep"``/``"tp"``) picks the JAX package's sharding
annotations; on one card it is accepted and computes the same function.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import weight

__all__ = [
    "MoEConfig",
    "MoE",
    "moe_init",
    "moe_capacity",
    "moe_apply",
    "moe_apply_dense_ref",
    "moe_apply_spmspv",
    "moe_combine_spmspv",
]

PARTITIONS = ("ep", "tp")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden size
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3


class MoE(nn.Module):
    """``router`` (d, E) in float32 whatever the model's dtype, as the JAX
    package makes it; ``wi_gate``/``wi_up`` (E, d, f) and ``wo`` (E, f, d)
    in ``dtype``.  ``AXES`` are the weights' logical axes: under ``"ep"``
    the experts shard, under ``"tp"`` each expert's d_ff does."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype, device, gen=None,
                 partition: str = "ep"):
        super().__init__()
        if partition not in PARTITIONS:
            raise ValueError(f"partition {partition!r}: one of {PARTITIONS}")
        e_ax, f_ax = ("experts", "expert_mlp") if partition == "ep" else (None, "mlp")
        self.AXES = {"router": ("embed", None), "wi_gate": (e_ax, "embed", f_ax),
                     "wi_up": (e_ax, "embed", f_ax), "wo": (e_ax, f_ax, "embed")}
        E, f = cfg.n_experts, cfg.d_ff
        self.router = weight(gen, (d_model, E), torch.float32, device)
        self.wi_gate = weight(gen, (E, d_model, f), dtype, device)
        self.wi_up = weight(gen, (E, d_model, f), dtype, device)
        self.wo = weight(gen, (E, f, d_model), dtype, device)


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, partition: str = "ep") -> MoE:
    return MoE(d_model, cfg, dtype, gen.device, gen, partition)


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    # a comparison, which never reads the ids on the host
    return ids[..., None] == torch.arange(n, device=ids.device)


def _route(p: MoE, x: torch.Tensor, cfg: MoEConfig, aux: bool = True):
    """Router in float32: (weights (b, s, k), ids (b, s, k), load-balance
    loss, z-loss).  With ``aux=False`` the two losses are 0.0 and not
    computed (the decode path drops them)."""
    logits = x.float() @ p.router.float()
    # a stable descending sort is jax.lax.top_k's order: the lower index
    # first among equal logits (torch.topk leaves ties unordered)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :cfg.top_k], ids[..., :cfg.top_k]
    weights = torch.softmax(vals, dim=-1)
    if not aux:
        return weights, ids, 0.0, 0.0
    E = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    density = _one_hot(ids, E).float().mean(dim=(1, 2))  # (b, E) slots per expert
    mean_probs = probs.mean(dim=1)  # (b, E)
    lb_loss = E * (density * mean_probs).sum(dim=-1).mean()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return weights, ids, lb_loss, cfg.router_zloss * z_loss


def moe_capacity(s: int, cfg: MoEConfig) -> int:
    """Per (row, expert) slot capacity: ceil(s * k * capacity_factor / E)."""
    return max(math.ceil(s * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)


def _dispatch(x: torch.Tensor, ids: torch.Tensor, cfg: MoEConfig, C: int):
    """(xe (E, b*C, d), dest (b, s*k)): each expert's first C slots of each
    batch row, ranked in slot order t*k + j; a dropped slot's dest is E*C."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    flat_ids = ids.reshape(b, s * k)
    ranks = _one_hot(flat_ids, E).long().cumsum(dim=1) - 1  # (b, s*k, E)
    rank_of_slot = ranks.gather(-1, flat_ids[..., None])[..., 0]
    dest = torch.where(rank_of_slot < C, flat_ids * C + rank_of_slot, E * C)
    x_slots = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    buf = x.new_zeros((b, E * C + 1, d)).scatter_add(
        1, dest[..., None].expand(b, s * k, d), x_slots)
    # (E, b*C, d): one batched product per expert weight
    return buf[:, :E * C].reshape(b, E, C, d).transpose(0, 1).reshape(E, b * C, d), dest


def _dispatch_expert_outputs(p: MoE, x: torch.Tensor, cfg: MoEConfig,
                             partition: str = "ep", aux: bool = True):
    """Route, capacity-drop and run the experts; the combine's operands.

    ``(out_flat (b, E*C+1, d), dest (b, s*k), weights (b, s, k), lb_loss,
    z_loss, C)``: ``out_flat`` holds every expert slot's output and a
    trailing zero row that dropped slots point at (``dest == E*C``).
    Shared by :func:`moe_apply` and :func:`moe_apply_spmspv`.
    """
    if partition not in PARTITIONS:
        raise ValueError(f"partition {partition!r}: one of {PARTITIONS}")
    b, s, d = x.shape
    E = cfg.n_experts
    C = moe_capacity(s, cfg)
    weights, ids, lb_loss, z_loss = _route(p, x, cfg, aux)
    xe, dest = _dispatch(x, ids, cfg, C)
    gate = torch.bmm(xe, p.wi_gate)
    up = torch.bmm(xe, p.wi_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    out = torch.bmm(h, p.wo)  # (E, b*C, d)
    out_flat = out.reshape(E, b, C, d).transpose(0, 1).reshape(b, E * C, d)
    out_flat = torch.cat([out_flat, out_flat.new_zeros((b, 1, d))], dim=1)
    return out_flat, dest, weights, lb_loss, z_loss, C


def moe_apply(p: MoE, x: torch.Tensor, cfg: MoEConfig, partition: str = "ep",
              *, aux: bool = True):
    """x (b, s, d) -> (y (b, s, d), aux loss: 0.01 load balance + z-loss;
    0.0 with ``aux=False``)."""
    b, s, d = x.shape
    k = cfg.top_k
    out_flat, dest, weights, lb_loss, z_loss, _ = _dispatch_expert_outputs(
        p, x, cfg, partition, aux)
    slot_out = out_flat.gather(1, dest[..., None].expand(b, s * k, d))
    slot_out = slot_out * weights.reshape(b, s * k).to(slot_out.dtype)[..., None]
    return slot_out.reshape(b, s, k, d).sum(dim=2), lb_loss * 0.01 + z_loss


def moe_apply_dense_ref(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Oracle: every expert on every token, combined by gate weight.  No
    capacity dropping, so it equals :func:`moe_apply` only where nothing
    drops (capacity_factor >= E / top_k)."""
    b, s, d = x.shape
    weights, ids, _, _ = _route(p, x, cfg, aux=False)
    gate = torch.einsum("bsd,edf->bsef", x, p.wi_gate)
    up = torch.einsum("bsd,edf->bsef", x, p.wi_up)
    h = F.silu(gate.float()).to(x.dtype) * up
    all_out = torch.einsum("bsef,efd->bsed", h, p.wo)  # (b, s, E, d)
    sel = all_out.gather(2, ids[..., None].expand(b, s, cfg.top_k, d))
    return (sel * weights[..., None].to(sel.dtype)).sum(dim=2)


def _combine_scale(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """(b, s, d) float64: the magnitudes behind each output entry of
    :func:`moe_apply`, for holding two evaluations of it (the dispatch, the
    dense oracle, the combine through the sparse stack) to 1e-5 of them.

    y_i = sum_j w_j sum_f h_jf wo_fi over a token's kept slots j is one
    product whose (|A| |x|)_i is sum_j |w_j| sum_f m_jf |wo_fi|, with m the
    magnitude of h and, to first order, of what reordering the gate and up
    products' sums can move it by: m = |h| + |silu'(g) u| (|x| |W_gate|) +
    |silu(g)| (|x| |W_up|).  Routing and capacity are ``moe_apply``'s."""
    b, s, d = x.shape
    k = cfg.top_k
    weights, ids, _, _ = _route(p, x, cfg, aux=False)
    xe, dest = _dispatch(x.double(), ids, cfg, moe_capacity(s, cfg))
    wg, wu, wo = p.wi_gate.double(), p.wi_up.double(), p.wo.double()
    g, u = torch.bmm(xe, wg), torch.bmm(xe, wu)
    sig = torch.sigmoid(g)
    m = ((g * sig * u).abs()
         + (sig * (1 + g * (1 - sig)) * u).abs() * torch.bmm(xe.abs(), wg.abs())
         + (g * sig).abs() * torch.bmm(xe.abs(), wu.abs()))
    E = cfg.n_experts
    mag = torch.bmm(m, wo.abs()).reshape(E, b, -1, d).transpose(0, 1).reshape(b, -1, d)
    mag = torch.cat([mag, mag.new_zeros((b, 1, d))], dim=1)
    slot = mag.gather(1, dest[..., None].expand(b, s * k, d))
    return (slot * weights.double().abs().reshape(b, s * k, 1)).reshape(b, s, k, d).sum(2)


def moe_apply_spmspv(p: MoE, x: torch.Tensor, cfg: MoEConfig, *,
                     impl: str = "cuda") -> torch.Tensor:
    """The combine through the sparse stack: x (b, s, d) -> y (b, s, d)
    float32.

    Per batch row the transposed slot outputs (d × E*C+1) become a CSR
    operand pinned to ``make("spmspv", impl)`` at nnz(x) = top_k, and each
    token's kept (dest, weight) pairs, sorted, are one ``apply_sparse``.
    ``impl="cuda"`` launches the SpMSpV kernel on a card (its plain version
    on CPU tensors); ``"ref"`` is the plain version.  The dispatch is
    :func:`moe_apply`'s own, so where nothing drops this equals
    :func:`moe_apply_dense_ref`.  Host-side per token: tests only.
    """
    out_flat, dest, weights, _, _, _ = _dispatch_expert_outputs(p, x, cfg, aux=False)
    return moe_combine_spmspv(out_flat, dest, weights, impl=impl)


def moe_combine_spmspv(out_flat: torch.Tensor, dest: torch.Tensor,
                       weights: torch.Tensor, *, impl: str = "cuda") -> torch.Tensor:
    """:func:`moe_apply_spmspv`'s combine alone, on ``out_flat``'s device:
    ``_dispatch_expert_outputs``'s out_flat (b, E*C+1, d), dest (b, s*k)
    and weights (b, s, k) -> y (b, s, d) float32.  On CPU operands the
    kernel tier runs its plain version, so the same operands give the
    kernel's bits there."""
    from repro_torch.core.formats import csr_from_dense
    from repro_torch.tune import SparseOperator, make

    b, s, k = weights.shape
    d = out_flat.shape[-1]
    n_slots = out_flat.shape[1] - 1  # E * C: the zero row dropped slots point at
    device = out_flat.device
    dest_np = dest.reshape(b, s, k).cpu().numpy()
    w_np = weights.float().reshape(b, s, k).cpu().numpy()
    out_np = out_flat.float().cpu().numpy()  # (b, E*C+1, d)
    y = torch.zeros((b, s, d), dtype=torch.float32, device=device)
    for bi in range(b):
        # columns are slots; the zero row E*C leaves the CSR pattern, and
        # the dropped slots that point at it leave the right-hand side
        a_T = csr_from_dense(np.ascontiguousarray(out_np[bi].T))
        op = SparseOperator.from_candidate(a_T, make("spmspv", impl), x_nnz=k,
                                           device=device)
        for t in range(s):
            di, wv = dest_np[bi, t], w_np[bi, t]
            kept = di < n_slots
            di, wv = di[kept], wv[kept]
            order = np.argsort(di)  # kept dests are distinct (expert, rank)
            y[bi, t] = op.apply_sparse(di[order].astype(np.int64), wv[order])
    return y

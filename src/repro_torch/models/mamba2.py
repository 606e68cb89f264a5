"""Mamba-2 (SSD) block, the state-space half of zamba2-2.7b.  The port of
``repro.models.mamba2``.

Per head h (state N = d_state, head width P) the recurrence is

    S_t = exp(dt_t * A) S_{t-1} + dt_t * x_t B_t^T      (P x N)
    y_t = S_t C_t + D x_t

A sequence runs the chunked SSD algorithm (quadratic within chunks of
length L, a scan of the carried state across chunks); the JAX package's
``lax.scan`` over chunks is a Python loop here, over a chunk count that is
a host integer.  :func:`mamba2_apply_seq_ref` is the step-by-step scan
(the oracle of the chunked form), and :func:`mamba2_apply_step`, the
decode step, is that scan over one token: one state update that reads
nothing on the host, so a CUDA graph captures it.  Decode carries
``conv`` (the short causal conv's last CONV_K - 1 inputs) and ``ssd`` (S),
both float32.

Types, as the JAX package rounds: the projections and the conv's sums run
in the model's dtype, the conv's SiLU in float32; the SSD, ``A_log``,
``D`` and ``dt_bias`` are float32 whatever the model's dtype; the gate
``y * silu(z)`` is taken in the model's dtype before the norm.  The conv
state is float32 but holds values of the model's dtype (its inputs).
Plain torch, as the JAX package writes it in ``jnp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.device import resolve

from .common import frozen, rms_norm, weight

__all__ = [
    "CONV_K",
    "Mamba2",
    "mamba2_init",
    "mamba2_apply_seq",
    "mamba2_apply_seq_ref",
    "mamba2_apply_step",
    "mamba2_init_state",
]

CONV_K = 4  # short causal conv width


class Mamba2(nn.Module):
    """One block's weights, named as the JAX package's parameter tree:
    ``in_proj`` (d, 2 d_inner + 2N + H) maps to [z, x, B, C, dt];
    ``conv_w`` (CONV_K, d_inner + 2N) and ``conv_b`` (zeros at init, as
    the JAX package makes them); ``A_log``, ``D``, ``dt_bias`` (H,)
    float32; ``norm`` (d_inner); ``out_proj`` (d_inner, d)."""

    AXES = {"in_proj": ("embed", "heads_flat"), "conv_w": (None, "heads_flat"),
            "conv_b": ("heads_flat",), "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm": ("heads_flat",), "out_proj": ("heads_flat", "embed")}

    def __init__(self, d_model: int, d_state: int = 64, head_dim: int = 64,
                 expand: int = 2, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        d_inner = expand * d_model
        H = d_inner // head_dim
        ch = d_inner + 2 * d_state

        def const(shape, value, dt=dtype):
            return frozen(torch.full(shape, value, dtype=dt, device=device))

        self.in_proj = weight(gen, (d_model, 2 * d_inner + 2 * d_state + H), dtype,
                              device)
        self.conv_w = const((CONV_K, ch), 0.0)
        self.conv_b = const((ch,), 0.0)
        self.A_log = const((H,), 0.0, torch.float32)
        self.D = const((H,), 1.0, torch.float32)
        self.dt_bias = const((H,), -4.6, torch.float32)  # softplus^-1(0.01)
        self.norm = const((d_inner,), 1.0)
        self.out_proj = weight(gen, (d_inner, d_model), dtype, device)


def mamba2_init(gen: torch.Generator, d_model: int, d_state: int = 64,
                head_dim: int = 64, expand: int = 2, dtype=torch.float32) -> Mamba2:
    return Mamba2(d_model, d_state, head_dim, expand, dtype, gen.device, gen)


def mamba2_init_state(batch: int, d_model: int, d_state: int = 64, head_dim: int = 64,
                      expand: int = 2, device="cuda") -> dict:
    """A zero float32 state for ``batch`` sequences on ``device`` (``"cuda"``
    by default; raises without a card)."""
    device = resolve(device)
    d_inner = expand * d_model
    H = d_inner // head_dim
    return {
        "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * d_state),
                            dtype=torch.float32, device=device),
        "ssd": torch.zeros((batch, H, head_dim, d_state), dtype=torch.float32,
                           device=device),
    }


def _split_proj(p: Mamba2, x, d_model, d_state, head_dim, expand):
    d_inner = expand * d_model
    H = d_inner // head_dim
    z, xbc, dt = torch.split(x @ p.in_proj, [d_inner, d_inner + 2 * d_state, H], dim=-1)
    return z, xbc, dt, d_inner, H


def _causal_conv(p: Mamba2, xbc, conv_state):
    """Depthwise causal conv over (b, s, ch); returns (y, new_state)."""
    pad = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    w = p.conv_w.to(xbc.dtype)  # (K, ch)
    s = xbc.shape[1]
    y = sum(pad[:, i:i + s, :] * w[i] for i in range(CONV_K)) + p.conv_b.to(xbc.dtype)
    new_state = pad[:, -(CONV_K - 1):, :].float()
    return F.silu(y.float()).to(xbc.dtype), new_state


def _ssd_chunked(xh, B, C, dt_a, A, s0, chunk: int):
    """Chunked SSD.  xh (b, s, H, P); B, C (b, s, N); dt_a (b, s, H) = dt
    (float32); A (H,) negative.  Returns (y (b, s, H, P), final state (b,
    H, P, N)), float32.  One chunk's (l, l, H) decay tensor at a time."""
    b, s, H, P = xh.shape
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")
    nc = s // chunk

    def cf(a):
        return a.float().reshape(b, nc, chunk, *a.shape[2:])

    xh_c, B_c, C_c, dt_c = cf(xh), cf(B), cf(C), cf(dt_a)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    S = s0
    ys = []
    for c in range(nc):
        x_, B_, C_, dt = xh_c[:, c], B_c[:, c], C_c[:, c], dt_c[:, c]
        cum = torch.cumsum(dt * A, dim=1)  # (b, l, H) inclusive log-decay, <= 0
        # intra-chunk: y_t += sum_{u<=t} C_t.B_u exp(cum_t - cum_u) dt_u x_u
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (b, t, u, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("btn,bun->btu", C_, B_)
        M = cb[..., None] * decay * dt[:, None, :, :]
        y = torch.einsum("btuh,buhp->bthp", M, x_)
        # inter-chunk: y_t += exp(cum_t) C_t . S_in
        y = y + torch.einsum("bth,btn,bhpn->bthp", torch.exp(cum), C_, S)
        # S_out = exp(cum_L) S_in + sum_u exp(cum_L - cum_u) dt_u x_u B_u
        tail = torch.exp(cum[:, -1:, :] - cum) * dt
        S = S * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
            "buh,buhp,bun->bhpn", tail, x_, B_)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, H, P), S


def _inputs(p: Mamba2, x, state, d_state, head_dim, expand):
    """The projections, the conv and the float32 SSD operands of x (b, s,
    d): (z, xh (b, s, H, P), B, C, dt (b, s, H) float32, A (H,), new conv
    state)."""
    b, s, d_model = x.shape
    z, xbc_raw, dt_raw, d_inner, H = _split_proj(p, x, d_model, d_state, head_dim, expand)
    xbc, conv_state = _causal_conv(p, xbc_raw, state["conv"])
    xs, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    xh = xs.reshape(b, s, H, head_dim)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)  # (H,) negative
    return z, xh, B, C, dt, A, conv_state


def _out(p: Mamba2, x, y, xh, z):
    """D skip, the gate in the model's dtype, the norm and ``out_proj``."""
    b, s, _ = x.shape
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(b, s, -1).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p.norm)
    return y @ p.out_proj


def mamba2_apply_seq(p: Mamba2, x: torch.Tensor, state: dict, d_state: int = 64,
                     head_dim: int = 64, expand: int = 2, chunk: int = 128):
    """Full-sequence forward.  x (b, s, d_model).  Returns (y, new_state).
    The chunk is the largest divisor of s not above ``chunk``."""
    s = x.shape[1]
    z, xh, B, C, dt, A, conv_state = _inputs(p, x, state, d_state, head_dim, expand)
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    y, S = _ssd_chunked(xh, B, C, dt, A, state["ssd"], chunk)
    return _out(p, x, y, xh, z), {"conv": conv_state, "ssd": S}


def mamba2_apply_seq_ref(p: Mamba2, x: torch.Tensor, state: dict, d_state: int = 64,
                         head_dim: int = 64, expand: int = 2):
    """Step-by-step scan (the oracle of the chunked form)."""
    z, xh, B, C, dt, A, conv_state = _inputs(p, x, state, d_state, head_dim, expand)
    xf, B, C = xh.float(), B.float(), C.float()
    S = state["ssd"]
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]  # (b, H)
        S = S * torch.exp(dt_t * A)[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt_t, xf[:, t], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", S, C[:, t]))
    return _out(p, x, torch.stack(ys, dim=1), xh, z), {"conv": conv_state, "ssd": S}


def mamba2_apply_step(p: Mamba2, x: torch.Tensor, state: dict, d_state: int = 64,
                      head_dim: int = 64, expand: int = 2):
    """Single-token decode: x (b, 1, d), the scan over one token."""
    return mamba2_apply_seq_ref(p, x, state, d_state, head_dim, expand)

"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, with a
data-dependent decay per channel.  The port of ``repro.models.rwkv6``;
rwkv6-7b is 32 layers, d = 4096, heads of 64, d_ff = 14336.

Time mix runs the WKV6 recurrence per head (state S, hd x hd):

    y_t = r_t @ (S_t + diag(u) k_t v_t^T)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T,   w_t = exp(-exp(decay_t))

as a plain loop over time in float32 (the JAX package's ``lax.scan``; its
chunked parallel form is not in the reference, so not here either).  A
decode step is the same block over one token with the carried state
(token-shift inputs and S).  Plain torch, as the JAX package writes it in
``jnp``.

Types.  The decode state's shift inputs are float32 (``rwkv6_init_state``),
and the port keeps them so: :func:`rwkv6_apply_seq` returns the normed last
token as float32, so a decode state keeps fixed tensors that a CUDA graph
updates in place.  The token-shift mixing therefore runs in float32 at
every step, as the JAX package's runs at the first step from a fresh state
(it returns the shift inputs in the model's dtype, so its later bf16 steps
mix in bf16: ROADMAP C.21).  Products take their input in the weight's
dtype (torch multiplies no bf16 weight by a float32 operand; JAX promotes
the weight instead), and the float32 results the JAX package keeps (the
decay and its sum with the base, the gate, the WKV state) stay float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.device import resolve

from .common import frozen, rms_norm, weight

__all__ = ["RWKV6", "rwkv6_init", "rwkv6_apply_seq", "rwkv6_apply_step",
           "rwkv6_init_state"]

LORA_MIX = 32
LORA_DECAY = 64


class RWKV6(nn.Module):
    """One block's weights, named as the JAX package's parameter tree."""

    AXES = {
        "mu_base": (None, "embed"), "mix_w1": ("embed", None),
        "mix_w2": (None, None, "embed"),
        **{w: ("embed", "heads_flat") for w in ("wr", "wk", "wv", "wg", "cm_wr")},
        "wo": ("heads_flat", "embed"),
        "decay_base": ("embed",), "decay_w1": ("embed", None), "decay_w2": (None, "embed"),
        "bonus_u": (None, None), "ln_x": ("embed",), "cm_mu": (None, "embed"),
        "cm_wk": ("embed", "mlp"), "cm_wv": ("mlp", "embed"),
        "ln1": ("embed",), "ln2": ("embed",),
    }

    def __init__(self, d_model: int, d_ff: int, head_dim: int, dtype, device,
                 gen=None):
        super().__init__()
        H = d_model // head_dim

        def const(shape, value):
            return frozen(torch.full(shape, value, dtype=dtype, device=device))

        def dense(shape):
            return weight(gen, shape, dtype, device)

        # dynamic token-shift mixing (5 targets: w, k, v, r, g)
        self.mu_base = const((5, d_model), 0.0)
        self.mix_w1 = dense((d_model, 5 * LORA_MIX))
        self.mix_w2 = dense((5, LORA_MIX, d_model))
        self.wr = dense((d_model, d_model))
        self.wk = dense((d_model, d_model))
        self.wv = dense((d_model, d_model))
        self.wg = dense((d_model, d_model))
        self.wo = dense((d_model, d_model))
        # data-dependent decay LoRA
        self.decay_base = const((d_model,), -6.0)
        self.decay_w1 = dense((d_model, LORA_DECAY))
        self.decay_w2 = dense((LORA_DECAY, d_model))
        self.bonus_u = const((H, head_dim), 0.0)
        self.ln_x = const((d_model,), 1.0)
        # channel mix
        self.cm_mu = const((2, d_model), 0.0)
        self.cm_wk = dense((d_model, d_ff))
        self.cm_wv = dense((d_ff, d_model))
        self.cm_wr = dense((d_model, d_model))
        # pre-norms
        self.ln1 = const((d_model,), 1.0)
        self.ln2 = const((d_model,), 1.0)


def rwkv6_init(gen: torch.Generator, d_model: int, d_ff: int, head_dim: int = 64,
               dtype=torch.float32) -> RWKV6:
    return RWKV6(d_model, d_ff, head_dim, dtype, gen.device, gen)


def rwkv6_init_state(batch: int, d_model: int, head_dim: int = 64,
                     device="cuda") -> dict:
    """A zero float32 state for ``batch`` sequences on ``device`` (``"cuda"``
    by default; raises without a card)."""
    device = resolve(device)
    H = d_model // head_dim
    return {
        "tm_shift": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "cm_shift": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "wkv": torch.zeros((batch, H, head_dim, head_dim), dtype=torch.float32,
                           device=device),
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with x cast to the weight's dtype."""
    return x.to(w.dtype) @ w


def _mix_inputs(p: RWKV6, x, xx):
    """Finch dynamic token shift: 5 mixed streams (w, k, v, r, g), each
    (b, s, d), stacked as (5, b, s, d)."""
    delta = xx - x
    base = x + delta * p.mu_base[0]
    lora = torch.tanh(_mm(base, p.mix_w1))
    lora = lora.reshape(*lora.shape[:-1], 5, LORA_MIX)
    offs = torch.einsum("bsnm,nmd->nbsd", lora, p.mix_w2)
    mu = p.mu_base[:, None, None, :] + offs
    return x[None] + delta[None] * mu


def _decay(p: RWKV6, xw):
    lora = torch.tanh(_mm(xw, p.decay_w1))
    # the sum in float32: near the base of -6, bf16 steps by 2**-5
    d = p.decay_base.float() + _mm(lora, p.decay_w2).float()
    return torch.exp(-torch.exp(d))  # (b, s, d) in (0, 1)


def _wkv_scan(r, k, v, w, u, s0):
    """Sequential WKV6.  r, k, v, w: (b, s, H, hd); u: (H, hd); s0: (b, H,
    hd, hd).  Returns (y (b, s, H, hd), final state), float32."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        a_t = k[:, t, :, :, None] * v[:, t, :, None, :]  # outer k x v
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * a_t))
        S = w[:, t, :, :, None] * S + a_t
    return torch.stack(ys, dim=1), S


def rwkv6_apply_seq(p: RWKV6, x_in: torch.Tensor, state: dict, head_dim: int = 64):
    """Full-sequence forward with the block's pre-norms and residuals.

    x_in (b, s, d).  Returns (out, new_state): out = x_in + time mix +
    channel mix; the new shift states hold the *normed* last token
    (float32), the new WKV state is S after the last token."""
    b, s, d = x_in.shape
    H = d // head_dim
    # ---- time mix
    x = rms_norm(x_in, p.ln1)
    xx = torch.cat([state["tm_shift"][:, None, :], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _mix_inputs(p, x, xx)
    r = _mm(xr, p.wr).reshape(b, s, H, head_dim)
    k = _mm(xk, p.wk).reshape(b, s, H, head_dim)
    v = _mm(xv, p.wv).reshape(b, s, H, head_dim)
    g = F.silu(_mm(xg, p.wg).float())
    w = _decay(p, xw).reshape(b, s, H, head_dim)
    ys, S = _wkv_scan(r, k, v, w, p.bonus_u.float(), state["wkv"])
    y = rms_norm(ys.reshape(b, s, d), p.ln_x) * g
    y = _mm(y.to(x.dtype), p.wo)
    # ---- channel mix (pre-normed residual branch)
    x_mid = x_in + y
    xc = rms_norm(x_mid, p.ln2)
    cc = torch.cat([state["cm_shift"][:, None, :], xc[:, :-1]], dim=1)
    dlt = cc - xc
    ck = xc + dlt * p.cm_mu[0]
    cr = xc + dlt * p.cm_mu[1]
    kk = torch.square(F.relu(_mm(ck, p.cm_wk).float())).to(x.dtype)
    cv = kk @ p.cm_wv
    out = x_mid + cv * torch.sigmoid(_mm(cr, p.cm_wr).float()).to(x.dtype)
    new_state = {"tm_shift": x[:, -1].float(), "cm_shift": xc[:, -1].float(), "wkv": S}
    return out, new_state


def rwkv6_apply_step(p: RWKV6, x: torch.Tensor, state: dict, head_dim: int = 64):
    """Single-token decode: x (b, 1, d)."""
    return rwkv6_apply_seq(p, x, state, head_dim)

"""The port's AdamW (``repro_torch.optim``) against the JAX package's on
the CPU, on the same numpy parameters, gradients and state.

Tolerances: ``lr_schedule`` within 1e-6 relative at every step (float32
arithmetic in both); ``adamw_update``'s parameters, moments and master
copy within 1e-6 relative of the leaf's largest magnitude after each of
three steps (only float32 rounding and fused multiply-adds differ), in
float32 and bf16 parameters, with ``master_fp32`` on and off and bf16
moments.  bf16 leaves are held to the same limit: they are rounded from
float32 values that agree far more closely than half a bf16 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ja

from repro_torch.optim import adamw as ta

REL = 1e-6
SHAPES = {"embed": (16, 8), "blocks.0.attn.wq": (8, 12), "ln_f.g": (8,),
          "blocks.1.ffn.wo": (12, 8)}


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _as_jax(named: dict, dtype):
    return {k: jnp.asarray(v, _jdt(dtype)) for k, v in named.items()}


def _as_torch(named: dict, dtype):
    """Copies: the port writes its parameters in place, and a JAX array
    made from the same numpy buffer may share its memory."""
    return {k: torch.tensor(np.asarray(v, np.float32)).to(dtype) for k, v in named.items()}


def _draw(seed: int, scale: float) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def close_leaf(got: torch.Tensor, ref, what=""):
    """Within 1e-6 of the reference leaf's largest magnitude."""
    g = got.float().numpy().astype(np.float64)
    r = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert g.shape == r.shape, what
    err = np.abs(g - r).max()
    assert err <= REL * max(np.abs(r).max(), 1e-30), (what, float(err))


def test_lr_schedule_equals_the_reference_at_every_step():
    for cfg_kw in (dict(lr_peak=1e-3, warmup_steps=10, total_steps=100, lr_min_ratio=0.1),
                   dict(lr_peak=3e-4, warmup_steps=1, total_steps=20),
                   dict(lr_peak=3e-3, warmup_steps=0, total_steps=5)):
        tc, jc = ta.OptimConfig(**cfg_kw), ja.OptimConfig(**cfg_kw)
        for step in range(cfg_kw["total_steps"] + 6):
            got = float(ta.lr_schedule(tc, step))
            ref = float(ja.lr_schedule(jc, jnp.asarray(step)))
            assert abs(got - ref) <= REL * max(abs(ref), 1e-12), (cfg_kw, step, got, ref)
            assert float(ta.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))) == got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_and_clip_equal_the_reference(dtype):
    g = _draw(1, 3.0)
    norm = ta.global_norm(_as_torch(g, dtype))
    jnorm = ja.global_norm(_as_jax(g, dtype))
    assert abs(float(norm) - float(jnorm)) <= REL * float(jnorm)
    clipped, n2 = ta.clip_by_global_norm(_as_torch(g, dtype), 1.0)
    jclipped, _ = ja.clip_by_global_norm(_as_jax(g, dtype), 1.0)
    assert float(n2) == float(norm)
    for k in SHAPES:
        assert clipped[k].dtype == dtype  # cast back to the gradient's dtype
        close_leaf(clipped[k], jclipped[k], k)


@pytest.mark.parametrize("dtype,master,moment", [
    (torch.float32, False, torch.float32),
    (torch.bfloat16, False, torch.float32),
    (torch.bfloat16, True, torch.float32),
    (torch.float32, False, torch.bfloat16),
    (torch.bfloat16, True, torch.bfloat16),
])
def test_adamw_update_equals_the_reference(dtype, master, moment):
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10, master_fp32=master)
    tc = ta.OptimConfig(**kw, moment_dtype=moment)
    jc = ja.OptimConfig(**kw, moment_dtype=_jdt(moment))
    # parameters representable in the dtype, so both packages start equal
    p0 = {k: np.asarray(jnp.asarray(v, _jdt(dtype)), np.float32)
          for k, v in _draw(0, 0.5).items()}
    tparams = _as_torch(p0, dtype)
    jparams = _as_jax(p0, dtype)
    tstate, jstate = ta.adamw_init(tparams, tc), ja.adamw_init(jparams, jc)
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 0
    assert all(t.dtype == moment for t in tstate["m"].values())
    assert ("master" in tstate) == master
    for step in range(3):
        grads = _draw(10 + step, 2.0 if step else 0.1)  # clipped, then not
        # the same gradient in the gradient's dtype in both packages
        grads = {k: np.asarray(jnp.asarray(v, _jdt(dtype)), np.float32)
                 for k, v in grads.items()}
        out, tstate, tm = ta.adamw_update(_as_torch(grads, dtype), tstate, tparams, tc)
        assert out is tparams  # written in place
        jparams, jstate, jm = ja.adamw_update(_as_jax(grads, dtype), jstate, jparams, jc)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= REL * float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= REL * float(
            jm["grad_norm"])
        for k in SHAPES:
            assert tparams[k].dtype == dtype and tstate["m"][k].dtype == moment
            close_leaf(tparams[k], jparams[k], f"step {step} param {k}")
            close_leaf(tstate["m"][k], jstate["m"][k], f"step {step} m {k}")
            close_leaf(tstate["v"][k], jstate["v"][k], f"step {step} v {k}")
            if master:
                close_leaf(tstate["master"][k], jstate["master"][k], f"master {k}")

"""The port's RWKV-6 block (``repro_torch.models.rwkv6``) against the JAX
package's (``repro.models.rwkv6``) on the same inputs, on the CPU.

Weights are drawn by ``repro.models.rwkv6.rwkv6_init``; its constant
leaves (the mixing and decay bases, the bonus, the norms), which init sets
to 0, 1 or -6, are replaced by seeded random values on both sides so every
term of the block is exercised.  Inputs and states come from
``numpy.random.default_rng``.  Tolerances, relative to max|ref|: 1e-4 in
float32 (only the order of float32 sums differs); in bf16 5e-2
(``RWKV6_BF16_TOL``, PERF.md §2), not the dense models' 3e-2: where its
token-shift operands are float32 (forward, prefill, a step from a fresh
state) the reference multiplies them by the bf16 weights promoted to
float32, so its bf16 block runs the time mix's products in float32, where
the port's round their operands and results to bf16 (up to 3.7e-2 apart
on the reduced model, in the C.21 case below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models import rwkv6 as jrw
from repro.models.common import KeyGen, split_params

from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trw

F32_TOL = 1e-4
RWKV6_BF16_TOL = 5e-2
CPU = torch.device("cpu")
D, DFF, HD = 64, 128, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in several worker processes at once: keep this file to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol, what=""):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err, np.abs(ref).max())


def rng_f32(seed, shape, scale=1.0, loc=0.0):
    return (loc + np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pair(seed=0):
    """(reference params as numpy, the port's block holding them)."""
    jp, _ = split_params(jrw.rwkv6_init(KeyGen(seed), D, DFF, HD))
    jp = {k: np.array(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed + 100)
    for key, (loc, scale) in {"mu_base": (0.5, 0.3), "cm_mu": (0.5, 0.3),
                              "decay_base": (-4.0, 1.0), "bonus_u": (0.0, 0.5),
                              "ln_x": (1.0, 0.1), "ln1": (1.0, 0.1),
                              "ln2": (1.0, 0.1)}.items():
        jp[key] = (loc + scale * rng.standard_normal(jp[key].shape)).astype(np.float32)
    tp = trw.RWKV6(D, DFF, HD, torch.float32, CPU)
    for key, value in jp.items():
        getattr(tp, key).copy_(torch.as_tensor(value))
    return jp, tp


def _state(seed, b):
    return {"tm_shift": rng_f32(seed, (b, D)), "cm_shift": rng_f32(seed + 1, (b, D)),
            "wkv": rng_f32(seed + 2, (b, D // HD, HD, HD), 0.3)}


def _t(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


def test_mix_inputs_and_decay_match_reference():
    jp, tp = _pair()
    x, xx = rng_f32(1, (2, 7, D)), rng_f32(2, (2, 7, D))
    got = trw._mix_inputs(tp, torch.as_tensor(x), torch.as_tensor(xx))
    assert tuple(got.shape) == (5, 2, 7, D)
    close(got, jrw._mix_inputs(jp, x, xx), F32_TOL, "mix")
    xw = rng_f32(3, (2, 7, D))
    w = trw._decay(tp, torch.as_tensor(xw))
    assert w.dtype == torch.float32 and bool(((w > 0) & (w < 1)).all())
    close(w, jrw._decay(jp, xw), F32_TOL, "decay")


def test_wkv_scan_matches_reference():
    b, s, H = 2, 9, D // HD
    r, k, v = (rng_f32(i, (b, s, H, HD)) for i in (1, 2, 3))
    w = np.random.default_rng(4).uniform(0.5, 1.0, (b, s, H, HD)).astype(np.float32)
    u, s0 = rng_f32(5, (H, HD)), rng_f32(6, (b, H, HD, HD), 0.3)
    ys, S = trw._wkv_scan(*(torch.as_tensor(a) for a in (r, k, v, w, u, s0)))
    jys, jS = jrw._wkv_scan(r, k, v, w, u, s0)
    close(ys, jys, F32_TOL, "y")
    close(S, jS, F32_TOL, "state")


@pytest.mark.parametrize("s", [1, 9])
def test_apply_seq_and_step_match_reference(s):
    """From a random carried state: the block's output and every leaf of
    its new state (s = 1 is ``rwkv6_apply_step``, the decode step)."""
    jp, tp = _pair()
    x = rng_f32(7, (2, s, D))
    st = _state(8, 2)
    fn, jfn = ((trw.rwkv6_apply_step, jrw.rwkv6_apply_step) if s == 1 else
               (trw.rwkv6_apply_seq, jrw.rwkv6_apply_seq))
    out, new = fn(tp, torch.as_tensor(x), _t(st), HD)
    jout, jnew = jfn(jp, x, st, HD)
    close(out, jout, F32_TOL, "out")
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert new[key].dtype == torch.float32, key
        close(new[key], jnew[key], F32_TOL, key)


def test_split_sequence_carries_the_state():
    """Two halves with the carried state equal the whole sequence."""
    tp = trw.rwkv6_init(torch.Generator().manual_seed(1), D, DFF, HD)
    x = torch.as_tensor(rng_f32(9, (2, 24, D), 0.5))
    st = trw.rwkv6_init_state(2, D, HD, device="cpu")
    full, _ = trw.rwkv6_apply_seq(tp, x, st, HD)
    ya, sa = trw.rwkv6_apply_seq(tp, x[:, :10], st, HD)
    yb, _ = trw.rwkv6_apply_seq(tp, x[:, 10:], sa, HD)
    close(torch.cat([ya, yb], dim=1), full.numpy(), F32_TOL, "halves")


def test_prefill_then_decode_steps_equal_forward_in_the_port():
    """The reduced rwkv6-7b in float32: a 13-token prefill and 8 decode
    steps give ``forward``'s logits at every position, and decode updates
    the state's own tensors (a CUDA graph replays on them)."""
    cfg = dataclasses.replace(get_reduced("rwkv6-7b"), dtype=torch.float32)
    model = tlm.init_model(cfg, 5, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (3, 21)).astype(np.int32)
    full, aux = tlm.forward(cfg, model, {"tokens": toks})
    assert aux == 0.0
    st, lg = tlm.prefill(cfg, model, {"tokens": toks[:, :13]}, 32)
    close(lg, full[:, 12].numpy(), F32_TOL, "prefill")
    ptrs = {k: t.data_ptr() for k, t in st["rwkv"].items()}
    for j in range(13, 21):
        st2, lg = tlm.decode_step(cfg, model, st, toks[:, j:j + 1])
        assert st2 is st
        close(lg[:, 0], full[:, j].numpy(), F32_TOL, f"position {j}")
    assert {k: t.data_ptr() for k, t in st["rwkv"].items()} == ptrs


def test_bf16_shift_state_stays_float32_where_the_reference_changes_dtype():
    """ROADMAP C.21.  The reference's decode state starts with float32 shift
    inputs, but its prefill and decode return them in the model's dtype, so
    its bf16 decode mixes in float32 at a step from a fresh state and in
    bf16 after: the two give other logits from the same values.  The port
    keeps float32 shift inputs at every step (fixed tensors, updated in
    place), which is the reference's float32-state arithmetic; the port is
    held to both at ``RWKV6_BF16_TOL``."""
    jcfg = dataclasses.replace(j_get_reduced("rwkv6-7b"), dtype=jnp.bfloat16)
    params, _ = jlm.init_model(jcfg, 0)
    model = lm_params_from_numpy(jcfg, jax.tree.map(np.asarray, params), device="cpu")
    cfg = model.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    assert jlm.init_decode_state(jcfg, 2, 32)["rwkv"]["tm_shift"].dtype == jnp.float32
    jst, _ = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks[:, :12])}, 32)
    tst, _ = tlm.prefill(cfg, model, {"tokens": toks[:, :12]}, 32)
    as_f32 = lambda st: {"rwkv": {k: v.astype(jnp.float32) for k, v in st["rwkv"].items()}}
    for j in range(12, 16):
        for key in ("tm_shift", "cm_shift"):
            assert jst["rwkv"][key].dtype == jnp.bfloat16, key
            assert tst["rwkv"][key].dtype == torch.float32, key
            close(tst["rwkv"][key], jst["rwkv"][key], RWKV6_BF16_TOL, key)
        t = jnp.asarray(toks[:, j:j + 1])
        _, bf_lg = jlm.decode_step(jcfg, params, jst, t)
        jst, f_lg = jlm.decode_step(jcfg, params, as_f32(jst), t)
        assert not np.array_equal(np.asarray(bf_lg), np.asarray(f_lg))
        tst, lg = tlm.decode_step(cfg, model, tst, toks[:, j:j + 1])
        close(lg, f_lg, RWKV6_BF16_TOL, f"float32-state step {j}")
        close(lg, bf_lg, RWKV6_BF16_TOL, f"bf16-state step {j}")

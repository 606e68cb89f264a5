"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``) on the same inputs, on the CPU.

Weights are drawn by ``repro.models.mamba2.mamba2_init`` and perturbed
(:func:`test_torch_hybrid.perturb_mamba`: ``conv_w``, ``conv_b``,
``A_log``, ``dt_bias``), since at init the block is the identity
(ROADMAP C.23).  Inputs and carried states come from
``numpy.random.default_rng``.  Tolerances, relative to max|ref|: 1e-4 in
float32 (only the order of float32 sums differs), 3e-2 in bf16 (the two
frameworks round bf16 at other places; PERF.md §2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro.models.common import KeyGen, split_params

from repro_torch.models import mamba2 as tm2
from test_torch_hybrid import perturb_mamba

F32_TOL = 1e-4
BF16_TOL = 3e-2
D, N, P = 64, 16, 16  # d_model, ssm_state, ssm_head_dim: d_inner 128, 8 heads
CH = 2 * D + 2 * N


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


DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(dtype="float32", seed=0):
    """(reference params as numpy, the port's block holding them), perturbed."""
    jdt, tdt, _ = DTYPES[dtype]
    jp, _ = split_params(jm2.mamba2_init(KeyGen(seed), D, N, P, dtype=jdt))
    jp = perturb_mamba({k: np.array(v) for k, v in jp.items()}, seed + 100)
    tp = tm2.Mamba2(D, N, P, dtype=tdt, device="cpu")
    for key, value in jp.items():
        getattr(tp, key).copy_(torch.as_tensor(np.asarray(value, np.float32)))
    return jp, tp


def _x(seed, s, dtype="float32", b=2):
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    return jnp.asarray(x).astype(DTYPES[dtype][0]), torch.as_tensor(x).to(DTYPES[dtype][1])


def _state(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"conv": (0.5 * rng.standard_normal((b, tm2.CONV_K - 1, CH))).astype(np.float32),
            "ssd": (0.3 * rng.standard_normal((b, 2 * D // P, P, N))).astype(np.float32)}


def _t(state):
    return {k: torch.as_tensor(np.array(v)) for k, v in state.items()}


def _same(out, jout, tol, what):
    (y, st), (jy, jst) = out, jout
    close(y, jy, tol, f"{what} y")
    for key in ("conv", "ssd"):
        assert st[key].dtype == torch.float32, key
        close(st[key], jst[key], tol, f"{what} {key}")


def test_block_layout_keeps_the_float32_leaves_and_the_zero_init():
    tp = tm2.mamba2_init(torch.Generator().manual_seed(0), D, N, P, dtype=torch.bfloat16)
    jp, _ = split_params(jm2.mamba2_init(KeyGen(0), D, N, P, dtype=jnp.bfloat16))
    for key, value in jp.items():
        t = getattr(tp, key)
        assert tuple(t.shape) == value.shape, key
        assert str(t.dtype).split(".")[1] == str(value.dtype), key
        assert not t.requires_grad
    for key in ("A_log", "D", "dt_bias"):
        assert getattr(tp, key).dtype == torch.float32
    for key in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
        assert np.array_equal(getattr(tp, key).float().numpy(),
                              np.asarray(jp[key], np.float32)), key
    st = tm2.mamba2_init_state(3, D, N, P, device="cpu")
    jst = jm2.mamba2_init_state(3, D, N, P)
    for key in ("conv", "ssd"):
        assert tuple(st[key].shape) == jst[key].shape and st[key].dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [64, 31])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_seq_matches_reference(chunk, s, dtype):
    """From a random carried state; s = 31 is prime, so the largest divisor
    of s not above the chunk is 1 at chunks 8 and 16 (the divisor loop)."""
    jp, tp = _pair(dtype)
    jx, tx = _x(1, s, dtype)
    st = _state(2)
    _same(tm2.mamba2_apply_seq(tp, tx, _t(st), N, P, chunk=chunk),
          jm2.mamba2_apply_seq(jp, jx, st, N, P, chunk=chunk), DTYPES[dtype][2],
          f"chunk {chunk} s {s}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_step_scan_matches_reference(dtype):
    jp, tp = _pair(dtype)
    jx, tx = _x(3, 24, dtype)
    st = _state(4)
    _same(tm2.mamba2_apply_seq_ref(tp, tx, _t(st), N, P),
          jm2.mamba2_apply_seq_ref(jp, jx, st, N, P), DTYPES[dtype][2], "ref scan")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_steps_after_a_prefix_match_reference(dtype):
    """A 20-token prefix from a zero state (chunk 16: the divisor 10), then
    four single-token steps on the carried state."""
    jp, tp = _pair(dtype)
    tol = DTYPES[dtype][2]
    jx, tx = _x(5, 24, dtype)
    st0 = {k: np.asarray(v) for k, v in jm2.mamba2_init_state(2, D, N, P).items()}
    out = tm2.mamba2_apply_seq(tp, tx[:, :20], _t(st0), N, P, chunk=16)
    jout = jm2.mamba2_apply_seq(jp, jx[:, :20], st0, N, P, chunk=16)
    _same(out, jout, tol, "prefix")
    st, jst = out[1], jout[1]
    for t in range(20, 24):
        out = tm2.mamba2_apply_step(tp, tx[:, t:t + 1], st, N, P)
        jout = jm2.mamba2_apply_step(jp, jx[:, t:t + 1], jst, N, P)
        _same(out, jout, tol, f"step {t}")
        st, jst = out[1], jout[1]


def test_split_sequence_carries_the_state():
    """Two parts with the carried state equal the whole sequence, in the
    port and against the reference's whole sequence."""
    jp, tp = _pair()
    jx, tx = _x(6, 48)
    st0 = tm2.mamba2_init_state(2, D, N, P, device="cpu")
    full, fst = tm2.mamba2_apply_seq(tp, tx, st0, N, P, chunk=16)
    ya, sa = tm2.mamba2_apply_seq(tp, tx[:, :16], st0, N, P, chunk=16)
    yb, sb = tm2.mamba2_apply_seq(tp, tx[:, 16:], sa, N, P, chunk=16)
    both = torch.cat([ya, yb], dim=1)
    close(both, full.numpy(), F32_TOL, "halves against whole")
    jfull, jst = jm2.mamba2_apply_seq(
        jp, jx, {k: np.asarray(v) for k, v in jm2.mamba2_init_state(2, D, N, P).items()},
        N, P, chunk=16)
    close(both, jfull, F32_TOL, "halves against the reference")
    for key in ("conv", "ssd"):
        close(sb[key], jst[key], F32_TOL, key)
        close(sb[key], fst[key].numpy(), F32_TOL, key)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_form_matches_its_own_step_scan(chunk):
    """The port alone, as the reference's ``test_mamba2_chunked_matches_step_scan``."""
    _, tp = _pair(seed=7)
    _, tx = _x(8, 64)
    st = _t(_state(9))
    y1, s1 = tm2.mamba2_apply_seq(tp, tx, st, N, P, chunk=chunk)
    y2, s2 = tm2.mamba2_apply_seq_ref(tp, tx, st, N, P)
    close(y1, y2.numpy(), F32_TOL, "y")
    for key in ("conv", "ssd"):
        close(s1[key], s2[key].numpy(), F32_TOL, key)

"""The port's hybrid model (zamba2: Mamba-2 layers and one shared attention
block with per-invocation LoRA; ``repro_torch.models.lm``) against the JAX
package's on the same inputs, on the CPU, at ``zamba2-2.7b/reduced`` (4
layers, d 128, period 2, LoRA rank 8, ssm_state 16, ssm_head_dim 16).

The reference's init makes every Mamba-2 layer the identity (``conv_w``
and ``conv_b`` are zeros, so the conv, the SSD and the block's output are
0) and its LoRA zero (``lora_b``): ROADMAP C.23,
:func:`test_unperturbed_mamba2_layers_are_the_identity_in_both_packages`.
So every other hybrid check runs on **perturbed** weights
(:func:`perturbed`): the reference's tree with ``conv_w`` = 0.2·N(0, 1),
``conv_b`` = 0.1·N(0, 1), ``A_log`` = log U(1, 16), ``dt_bias`` =
softplus⁻¹(U(0.001, 0.1)) (Mamba-2's published init ranges) and
``lora_b`` = 0.02·N(0, 1), drawn from a seeded numpy generator and carried
into both packages (``repro_torch.interop.lm_params_from_numpy``).  The
helper belongs to the tests: neither package has such a function.

Tolerances, relative to max|ref|: 1e-4 in float32, 3e-2 in bf16 (PERF.md
§2).  The bcsr shared FFN runs at ``impl="ref"`` and at ``"cuda"`` (on the
CPU the kernel's plain version); the reference runs its Pallas kernel in
interpret mode in float32 and its ``"ref"`` tier in bf16 (ROADMAP C.17).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models import mamba2 as jm2
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig

from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tm2

F32_TOL = 1e-4
BF16_TOL = 3e-2
ARCH = "zamba2-2.7b"


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


# ---------------------------------------------------------------------------
# perturbed weights (every hybrid check but C.23's)
# ---------------------------------------------------------------------------
def perturb_mamba(p: dict, seed: int) -> dict:
    """A copy of Mamba-2 leaves (numpy, any leading axes) whose conv, decay
    and step are live: ``conv_w`` 0.2·N(0, 1), ``conv_b`` 0.1·N(0, 1) (in
    the leaves' dtype), ``A_log`` log U(1, 16), ``dt_bias``
    softplus⁻¹(U(0.001, 0.1)) (float32)."""
    rng = np.random.default_rng(seed)
    out = dict(p)
    for key, scale in (("conv_w", 0.2), ("conv_b", 0.1)):
        out[key] = (scale * rng.standard_normal(p[key].shape)).astype(p[key].dtype)
    out["A_log"] = np.log(rng.uniform(1.0, 16.0, p["A_log"].shape)).astype(np.float32)
    out["dt_bias"] = np.log(np.expm1(rng.uniform(0.001, 0.1, p["dt_bias"].shape))
                            ).astype(np.float32)
    return out


def perturbed(params, seed: int = 0) -> dict:
    """The reference's hybrid tree as numpy with every Mamba-2 layer
    perturbed (:func:`perturb_mamba`) and ``lora_b`` = 0.02·N(0, 1)."""
    params = jax.tree.map(np.array, params)
    params["blocks"]["mamba"] = perturb_mamba(params["blocks"]["mamba"], seed)
    lb = params["lora_b"]
    params["lora_b"] = (0.02 * np.random.default_rng(seed + 1).standard_normal(lb.shape)
                        ).astype(lb.dtype)
    return params


def hybrid_pair(dtype=jnp.float32, ffn="dense", seed=0):
    """(reference config, perturbed reference params, the port's model
    holding them).  ``ffn``: "dense", "bcsr-ref" or "bcsr-cuda" (the port's
    impl; the reference runs Pallas in float32, "ref" in bf16)."""
    sff = None
    if ffn != "dense":
        j_impl = "ref" if ffn == "bcsr-ref" or dtype != jnp.float32 else "pallas"
        sff = JSparseFFNConfig(kind="bcsr", block=(32, 32), impl=j_impl)
    jcfg = dataclasses.replace(j_get_reduced(ARCH), dtype=dtype, sparse_ffn=sff)
    params = perturbed(jlm.init_model(jcfg, seed)[0], seed + 10)
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    if ffn == "bcsr-cuda":
        model.cfg = dataclasses.replace(model.cfg, sparse_ffn=dataclasses.replace(
            model.cfg.sparse_ffn, impl="cuda"))
    return jcfg, params, model


# ---------------------------------------------------------------------------
def test_hybrid_builds_with_the_references_layout_and_dtypes():
    """Parameter names and shapes of the reduced zamba2 match the
    reference's tree (the carrier checks every name), ``A_log``, ``D`` and
    ``dt_bias`` stay float32 in a bf16 model, the decode state has the
    reference's layout and dtypes, and the carrier refuses a tree without
    ``lora_b``."""
    jcfg = j_get_reduced(ARCH)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    cfg = model.cfg
    n_super = cfg.n_layers // cfg.hybrid_period
    assert len(model.blocks) == n_super and all(
        len(g) == cfg.hybrid_period for g in model.blocks)
    assert tlm.param_count(model) == jlm.param_count(params)
    for i in range(n_super):
        for j in range(cfg.hybrid_period):
            m = model.blocks[i][j].mamba
            assert m.in_proj.dtype == torch.bfloat16
            for key in ("A_log", "D", "dt_bias"):
                assert getattr(m, key).dtype == torch.float32, key
                assert np.array_equal(getattr(m, key).numpy(),
                                      params["blocks"]["mamba"][key][i, j])
    assert np.array_equal(model.lora_a.float().numpy(),
                          np.asarray(params["lora_a"], np.float32))
    st, jst = tlm.init_decode_state(cfg, 3, 16, "cpu"), jlm.init_decode_state(jcfg, 3, 16)
    for group in ("kv", "mamba"):
        assert set(st[group]) == set(jst[group])
        for key, t in st[group].items():
            assert tuple(t.shape) == jst[group][key].shape, (group, key)
            assert str(t.dtype).split(".")[1] == str(jst[group][key].dtype), (group, key)
    del params["lora_b"]
    with pytest.raises(ValueError, match="lora_b"):
        lm_params_from_numpy(jcfg, params, device="cpu")


FFNS = ["dense", "bcsr-ref", "bcsr-cuda"]


@pytest.mark.parametrize("ffn", FFNS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_reference(dtype, ffn):
    """Perturbed weights: ``forward``'s logits, ``prefill``'s last logits
    and every state leaf (the shared block's caches, each Mamba-2 layer's
    conv and SSD state), then three ``decode_step``s: their logits and
    caches and conv states, and in float32 their SSD states too.  In bf16 the SSD state
    after a decode step is not compared: the reference's own bf16 SSD state
    strays past 3e-2 from its float32 copy there
    (:func:`test_bf16_ssd_state_strays_past_the_limit_in_the_reference`),
    so that limit cannot tell a fault from rounding; the Mamba-2 block's
    bf16 states are held to the reference's on the same inputs in
    ``tests/test_torch_mamba2.py``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, params, model = hybrid_pair(jdt, ffn)
    cfg = model.cfg
    if ffn != "dense":
        assert cfg.sparse_ffn.impl == ffn.split("-")[1]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 23)).astype(np.int32)
    ref, _ = jlm.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    got, aux = tlm.forward(cfg, model, {"tokens": toks})
    assert got.dtype == getattr(torch, dtype) and aux == 0.0
    close(got, ref, tol, "forward")
    jst, jlg = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks[:, :20])}, 32)
    tst, tlg = tlm.prefill(cfg, model, {"tokens": toks[:, :20]}, 32)
    close(tlg, jlg, tol, "prefill logits")
    for step in range(4):
        for key in ("k", "v"):
            close(tst["kv"][key], jst["kv"][key], tol, f"step {step} cache {key}")
        for key in ("positions", "pos"):
            assert np.array_equal(tst["kv"][key].numpy(), np.asarray(jst["kv"][key]))
        for key in ("conv", "ssd"):
            assert tst["mamba"][key].dtype == torch.float32
            if key == "conv" or step == 0 or dtype == "float32":
                close(tst["mamba"][key], jst["mamba"][key], tol,
                      f"step {step} mamba {key}")
        if step == 3:
            break
        t = toks[:, 20 + step:21 + step]
        jst, jlg = jlm.decode_step(jcfg, params, jst, jnp.asarray(t))
        tst, tlg = tlm.decode_step(cfg, model, tst, t)
        close(tlg, jlg, tol, f"decode {step}")


def test_bf16_ssd_state_strays_past_the_limit_in_the_reference():
    """The reference alone, dense shared FFN, the parity test's weights and
    tokens: after a 20-token prefill and three decode steps, its bf16
    model's SSD state deviates from its float32 copy's (the same weights
    widened) by more than 3e-2 x max|float32 state| at some step (3.6e-2
    at the second), while its logits stay within it.  The bf16 SSD state is
    a sum over tokens of dt x B products of rounded inputs, each decayed:
    bf16 rounding upstream moves it by several per cent."""
    jcfg, params, _ = hybrid_pair(jnp.bfloat16, "dense")
    jcfg_f = dataclasses.replace(jcfg, dtype=jnp.float32)
    params_f = jax.tree.map(
        lambda a: np.asarray(a, np.float32) if "float" in str(a.dtype) else a, params)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 23)).astype(np.int32)
    runs = []
    for cfg_, p_ in ((jcfg, params), (jcfg_f, params_f)):
        st, lg = jlm.prefill(cfg_, p_, {"tokens": jnp.asarray(toks[:, :20])}, 32)
        seen = [(np.asarray(st["mamba"]["ssd"], np.float64), np.asarray(lg, np.float64))]
        for step in range(3):
            st, lg = jlm.decode_step(cfg_, p_, st, jnp.asarray(toks[:, 20 + step:21 + step]))
            seen.append((np.asarray(st["mamba"]["ssd"], np.float64),
                         np.asarray(lg, np.float64)))
        runs.append(seen)
    ssd_dev = [np.abs(b[0] - f[0]).max() / np.abs(f[0]).max() for b, f in zip(*runs)]
    logit_dev = [np.abs(b[1] - f[1]).max() / np.abs(f[1]).max() for b, f in zip(*runs)]
    assert max(ssd_dev) > BF16_TOL, ssd_dev
    assert max(logit_dev) <= BF16_TOL, logit_dev


@pytest.mark.parametrize("ffn", ["dense", "bcsr-cuda"])
def test_decode_matches_forward_in_the_port(ffn):
    """The port alone, float32, perturbed: a 20-token prefill and 6 decode
    steps give ``forward``'s logits at the same positions, and decode
    writes the state's own tensors (a CUDA graph replays on them)."""
    _, _, model = hybrid_pair(jnp.float32, ffn, seed=3)
    cfg = model.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 26)).astype(np.int32)
    full, _ = tlm.forward(cfg, model, {"tokens": toks})
    st, lg = tlm.prefill(cfg, model, {"tokens": toks[:, :20]}, 32)
    close(lg, full[:, 19].numpy(), F32_TOL, "prefill")
    ptrs = {(g, k): t.data_ptr() for g, leaves in st.items() for k, t in leaves.items()}
    for j in range(20, 26):
        st2, lg = tlm.decode_step(cfg, model, st, toks[:, j:j + 1])
        assert st2 is st
        close(lg[:, 0], full[:, j].numpy(), F32_TOL, f"position {j}")
    assert {(g, k): t.data_ptr() for g, leaves in st.items()
            for k, t in leaves.items()} == ptrs


def test_unperturbed_mamba2_layers_are_the_identity_in_both_packages():
    """ROADMAP C.23.  At the reference's init (seed 0, float32) every
    Mamba-2 layer returns exactly 0 on a random input, in ``repro`` and in
    the port, and ``lora_b`` is 0: the hybrid's ``forward`` equals, in each
    package, a dense model of n_super layers that are all the shared block.
    A check on these weights would pass with a wrong SSD, which is why the
    parity tests perturb them; perturbed, every layer's output is not 0."""
    jcfg = dataclasses.replace(j_get_reduced(ARCH), dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    cfg = model.cfg
    n_super, period = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    assert not np.asarray(params["lora_b"]).any()
    x = np.random.default_rng(0).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    st = {k: np.array(v) for k, v in jm2.mamba2_init_state(2, cfg.d_model, N, P).items()}
    live = perturb_mamba(params["blocks"]["mamba"], 5)
    for i in range(n_super):
        for j in range(period):
            layer = {k: v[i, j] for k, v in params["blocks"]["mamba"].items()}
            jy, _ = jm2.mamba2_apply_seq(layer, x, st, N, P, chunk=cfg.ssm_chunk)
            ty, _ = tm2.mamba2_apply_seq(model.blocks[i][j].mamba, torch.as_tensor(x),
                                         {k: torch.as_tensor(v) for k, v in st.items()},
                                         N, P, chunk=cfg.ssm_chunk)
            assert float(np.abs(np.asarray(jy)).max()) == 0.0, (i, j)
            assert float(ty.abs().max()) == 0.0, (i, j)
            jy, _ = jm2.mamba2_apply_seq({k: v[i, j] for k, v in live.items()}, x, st, N,
                                         P, chunk=cfg.ssm_chunk)
            assert float(np.abs(np.asarray(jy)).max()) > 0.0, (i, j)
    # the same model with its Mamba-2 layers removed: the shared block n_super times
    dense_cfg = dataclasses.replace(jcfg, family="dense", ssm_kind=None, n_layers=n_super,
                                    hybrid_period=0, lora_rank=0)
    dense = {"embed": params["embed"], "unembed": params["unembed"],
             "ln_f": params["ln_f"],
             "blocks": jax.tree.map(lambda a: np.stack([a] * n_super), params["shared"])}
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jgot = np.asarray(jlm.forward(jcfg, params, {"tokens": jnp.asarray(toks)})[0])
    jref = np.asarray(jlm.forward(dense_cfg, dense, {"tokens": jnp.asarray(toks)})[0])
    assert np.array_equal(jgot, jref)
    dense_model = lm_params_from_numpy(dense_cfg, dense, device="cpu")
    got = tlm.forward(cfg, model, {"tokens": toks})[0]
    assert torch.equal(got, tlm.forward(dense_model.cfg, dense_model, {"tokens": toks})[0])

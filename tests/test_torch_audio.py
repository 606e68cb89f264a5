"""The port's audio model (whisper: an encoder over precomputed frame
embeddings and a decoder with cross-attention; ``repro_torch.models.lm``)
against the JAX package's on the same inputs, on the CPU, at
``whisper-tiny/reduced`` (2 encoder and 2 decoder layers, d 64, 4 heads,
d_ff 128, 24 frames, layernorm, GELU).

At init every norm is the same function (gain 1, bias 0) and every bias
0, so a decoder that used ``ln1`` where it should use ``lnx``, or dropped
a bias, would pass.  Every parity check therefore runs on weights whose
norm gains, norm biases and FFN and attention biases are drawn from a
seeded numpy generator (:func:`perturb_affine`) and carried into both
packages (``repro_torch.interop.lm_params_from_numpy``).  Frames are
N(0, 1) float32 from ``numpy.random.default_rng``, as the JAX package's
data pipeline draws them.

Tolerances, relative to max|ref|: 1e-4 in float32, 3e-2 in bf16 (PERF.md
§2).  The bcsr FFN runs the reference's Pallas kernel in interpret mode in
float32 (every width here is under 128) and its ``"ref"`` tier in bf16
(ROADMAP C.17); the port's ``"cuda"`` tier, which on the CPU is the
kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import lm as tlm

F32_TOL = 1e-4
BF16_TOL = 3e-2
ARCH = "whisper-tiny"
AFFINE = {"g": 1.0, "b": 0.0, "bi": 0.0, "bo": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0}


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


def perturb_affine(params, seed: int) -> dict:
    """The reference's tree as numpy with every norm gain ``g`` = 1 + 0.2·N(0, 1)
    and every norm, FFN and attention bias (``b``, ``bi``, ``bo``, ``bq``,
    ``bk``, ``bv``) = 0.2·N(0, 1), in the leaves' dtype."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = walk(value)
            elif key in AFFINE:
                value = np.asarray(value)
                out[key] = (AFFINE[key] + 0.2 * rng.standard_normal(value.shape)
                            ).astype(value.dtype)
            else:
                out[key] = np.array(value)
        return out

    return walk(params)


def audio_pair(dtype=jnp.float32, bcsr=False, seed=0):
    """(reference config, perturbed reference params, the port's model
    holding them).  ``bcsr``: (32, 32) blocks, the reference at Pallas in
    float32 and at "ref" in bf16, the port at "cuda"."""
    sff = None
    if bcsr:
        sff = JSparseFFNConfig(kind="bcsr", block=(32, 32),
                               impl="pallas" if dtype == jnp.float32 else "ref")
    jcfg = dataclasses.replace(j_get_reduced(ARCH), dtype=dtype, sparse_ffn=sff)
    params = perturb_affine(jlm.init_model(jcfg, seed)[0], seed + 10)
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    if bcsr:
        model.cfg = dataclasses.replace(model.cfg, sparse_ffn=dataclasses.replace(
            model.cfg.sparse_ffn, impl="cuda"))
    return jcfg, params, model


def frames_for(cfg, b: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def test_audio_builds_with_the_references_layout():
    """The reduced and full whisper-tiny build; the carrier unstacks
    ``enc_blocks`` and ``dec_blocks`` by name and shape (and refuses a tree
    without ``ln_enc``); the parameter counts and the decode state's
    groups, shapes and dtypes are the reference's (``cross`` (L, B,
    enc_frames, kvh, hd) in the model's dtype)."""
    jcfg = j_get_reduced(ARCH)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    cfg = model.cfg
    assert (len(model.enc_blocks), len(model.dec_blocks)) == (cfg.enc_layers, cfg.n_layers)
    assert not hasattr(model, "blocks")
    assert tlm.param_count(model) == jlm.param_count(params)
    for i in range(cfg.n_layers):
        assert np.array_equal(model.dec_blocks[i].xattn.wk.float().numpy(),
                              np.asarray(params["dec_blocks"]["xattn"]["wk"][i], np.float32))
    st, jst = tlm.init_decode_state(cfg, 3, 16, "cpu"), jlm.init_decode_state(jcfg, 3, 16)
    assert set(st) == set(jst) == {"kv", "cross"}
    for group in st:
        assert set(st[group]) == set(jst[group])
        for key, t in st[group].items():
            assert tuple(t.shape) == jst[group][key].shape, (group, key)
            assert str(t.dtype).split(".")[1] == str(jst[group][key].dtype), (group, key)
    full = get_config(ARCH)
    m = tlm.init_model(full, 0, device="cpu")
    assert (full.enc_layers, full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.enc_frames, full.vocab_padded) == (4, 4, 384, 6, 1536, 1500, 51968)
    assert abs(tlm.param_count(m) - 56.46e6) < 0.01e6
    del params["ln_enc"]
    with pytest.raises(ValueError, match="ln_enc"):
        lm_params_from_numpy(jcfg, params, device="cpu")


@pytest.mark.parametrize("bcsr", [False, True], ids=["dense", "bcsr"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_reference(dtype, bcsr):
    """Perturbed weights, 2 sequences: ``forward``'s logits over 14 tokens,
    ``prefill``'s last logits and every state leaf (the self-attention
    caches and each decoder layer's cross keys and values), then 8
    ``decode_step``s: their logits and caches."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, params, model = audio_pair(jdt, bcsr)
    cfg = model.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    frames = frames_for(cfg, 2)
    ref, _ = jlm.forward(jcfg, params, {"tokens": jnp.asarray(toks),
                                        "frames": jnp.asarray(frames)})
    got, aux = tlm.forward(cfg, model, {"tokens": toks, "frames": frames})
    assert got.dtype == getattr(torch, dtype) and aux == 0.0
    close(got, ref, tol, "forward")
    jst, jlg = jlm.prefill(jcfg, params, {"tokens": jnp.asarray(toks[:, :6]),
                                          "frames": jnp.asarray(frames)}, 32)
    tst, tlg = tlm.prefill(cfg, model, {"tokens": toks[:, :6], "frames": frames}, 32)
    close(tlg, jlg, tol, "prefill logits")
    for key in ("k", "v"):
        assert tst["cross"][key].dtype == getattr(torch, dtype)
        close(tst["cross"][key], jst["cross"][key], tol, f"cross {key}")
    for step in range(9):
        for key in ("k", "v"):
            close(tst["kv"][key], jst["kv"][key], tol, f"step {step} cache {key}")
        for key in ("positions", "pos"):
            assert np.array_equal(tst["kv"][key].numpy(), np.asarray(jst["kv"][key]))
        if step == 8:
            break
        t = toks[:, 6 + step:7 + step]
        jst, jlg = jlm.decode_step(jcfg, params, jst, jnp.asarray(t))
        tst, tlg = tlm.decode_step(cfg, model, tst, t)
        close(tlg, jlg, tol, f"decode {step}")


@pytest.mark.parametrize("bcsr", [False, True], ids=["dense", "bcsr"])
def test_decode_matches_forward_in_the_port(bcsr):
    """The port alone, float32, perturbed: a 6-token prefill and 8 decode
    steps give ``forward``'s logits at the same positions, decode writes
    the state's own tensors (a CUDA graph replays on them) and leaves the
    cross keys and values as prefill wrote them."""
    _, _, model = audio_pair(jnp.float32, bcsr, seed=3)
    cfg = model.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    frames = frames_for(cfg, 2, seed=4)
    full, _ = tlm.forward(cfg, model, {"tokens": toks, "frames": frames})
    st, lg = tlm.prefill(cfg, model, {"tokens": toks[:, :6], "frames": frames}, 32)
    close(lg, full[:, 5].numpy(), F32_TOL, "prefill")
    cross = {k: t.clone() for k, t in st["cross"].items()}
    ptrs = {(g, k): t.data_ptr() for g, leaves in st.items() for k, t in leaves.items()}
    for j in range(6, 14):
        st2, lg = tlm.decode_step(cfg, model, st, toks[:, j:j + 1])
        assert st2 is st
        close(lg[:, 0], full[:, j].numpy(), F32_TOL, f"position {j}")
    assert {(g, k): t.data_ptr() for g, leaves in st.items()
            for k, t in leaves.items()} == ptrs
    assert all(torch.equal(st["cross"][k], t) for k, t in cross.items())


def test_encoder_and_frames_move_the_logits_in_both_packages():
    """A witness that the parity checks see the encoder: other frames move
    the decoder's logits by far more than the float32 limit in both
    packages, and a forward pass without frames is refused (the reference
    raises ``KeyError``, the port ``ValueError``)."""
    jcfg, params, model = audio_pair(jnp.float32)
    cfg = model.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    a, b = frames_for(cfg, 2, seed=3), frames_for(cfg, 2, seed=4)
    for run in (lambda f: np.asarray(jlm.forward(jcfg, params, {
                    "tokens": jnp.asarray(toks), "frames": jnp.asarray(f)})[0]),
                lambda f: tlm.forward(cfg, model, {"tokens": toks, "frames": f})[0].numpy()):
        la, lb = run(a), run(b)
        assert np.abs(la - lb).max() > 100 * F32_TOL * np.abs(la).max()
    with pytest.raises(KeyError, match="frames"):
        jlm.forward(jcfg, params, {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="frames"):
        tlm.forward(cfg, model, {"tokens": toks})

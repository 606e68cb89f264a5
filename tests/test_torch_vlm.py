"""The port's VLM (Qwen2-VL: M-RoPE and precomputed vision embeddings over
the first ``n_vision_tokens`` slots; ``repro_torch.models.lm``) against
the JAX package's on the same inputs, on the CPU, at
``qwen2-vl-72b/reduced`` (2 layers, d 128, 4 heads of 32 over 2 kv heads,
M-RoPE sections (8, 4, 4), 8 vision slots).

With equal streams M-RoPE is plain RoPE, so a wrong section split would
pass every check on ``arange`` positions (the JAX package's data pipeline
makes those).  Every check here uses positions in Qwen2-VL's layout
(``repro_torch.data.modality.qwen2_vl_positions``: vision slot i at (0,
i // w, i % w) on its grid, text after the largest vision position on all
three streams), and two witnesses show that the check can fail: a wrong
split moves ``apply_mrope``, and these positions move the logits away
from ``arange``'s, each by far more than the limit.  Norm gains are
perturbed (``tests/test_torch_audio.py::perturb_affine``).

Tolerances, relative to max|ref|: 1e-4 in float32, 3e-2 in bf16 (PERF.md
§2); the bcsr FFN as in ``tests/test_torch_audio.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig

from repro_torch.configs import get_config
from repro_torch.data.modality import qwen2_vl_positions
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from test_torch_audio import close, perturb_affine

F32_TOL = 1e-4
BF16_TOL = 3e-2
ARCH = "qwen2-vl-72b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in several worker processes at once: keep this file to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vlm_pair(dtype=jnp.float32, bcsr=False, seed=0):
    """(reference config, perturbed reference params, the port's model)."""
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


def vlm_batch(cfg, b: int, s: int, seed: int = 1, layout: bool = True) -> dict:
    """b prompts of s tokens (the first n_vision_tokens vision slots),
    their vision embeddings and (3, b, s) positions: Qwen2-VL's layout, or
    ``arange`` on all three streams."""
    rng = np.random.default_rng(seed)
    n = cfg.n_vision_tokens
    pos = (qwen2_vl_positions(n, s - n) if layout
           else np.broadcast_to(np.arange(s, dtype=np.int32), (3, s)))
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "vision_embeds": rng.standard_normal((b, n, cfg.d_model)).astype(np.float32),
            "positions": np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s)))}


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def cut(batch: dict, s: int) -> dict:
    return {**batch, "tokens": batch["tokens"][:, :s], "positions": batch["positions"][..., :s]}


def test_qwen2_vl_positions_layout():
    """256 slots on a 16 x 16 grid, then text from 16 on all three streams;
    the reduced config's 8 slots on a 3-column grid, text from 3."""
    p = qwen2_vl_positions(256, 32)
    assert p.shape == (3, 288) and p.dtype == np.int32
    i = np.arange(256)
    assert np.array_equal(p[:, :256], np.stack([0 * i, i // 16, i % 16]))
    assert np.array_equal(p[:, 256:], np.broadcast_to(np.arange(16, 48), (3, 32)))
    q = qwen2_vl_positions(8, 2)
    assert q.tolist() == [[0, 0, 0, 0, 0, 0, 0, 0, 3, 4], [0, 0, 0, 1, 1, 1, 2, 2, 3, 4],
                          [0, 1, 2, 0, 1, 2, 0, 1, 3, 4]]


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((8, 4, 4), 32)])
def test_apply_mrope_matches_reference_and_a_wrong_split_fails(sections, hd):
    """``apply_mrope`` on Qwen2-VL-layout positions within 1e-4 of the
    reference's, in float32 and bf16 (the same rounding); the split read
    the other way round moves it by far more than the limit, and on equal
    streams it equals ``apply_rope`` (why the layout matters)."""
    b, s = 2, 40
    x = np.random.default_rng(0).standard_normal((b, s, 4, hd)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(qwen2_vl_positions(24, s - 24)[:, None],
                                               (3, b, s)))
    for theta in (10000.0, 1e6):
        ref = np.asarray(jcommon.apply_mrope(x, pos, sections, theta))
        got = tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections, theta)
        close(got, ref, F32_TOL, f"theta {theta}")
        bf = tcommon.apply_mrope(torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(pos),
                                 sections, theta)
        assert bf.dtype == torch.bfloat16
        close(bf, ref, BF16_TOL, "bf16")
        wrong = tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                                    sections[::-1], theta).numpy()
        assert np.abs(wrong - ref).max() > 100 * F32_TOL * np.abs(ref).max()
        flat = np.ascontiguousarray(np.broadcast_to(np.arange(s)[None, None], (3, b, s)))
        cos, sin = tcommon.rope(torch.as_tensor(flat[0]), hd, theta)
        assert torch.allclose(tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(flat),
                                                  sections, theta),
                              tcommon.apply_rope(torch.as_tensor(x), cos, sin))
    with pytest.raises(ValueError, match="sum"):
        tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (8, 8, 8))


def test_vlm_builds_with_the_references_layout():
    """Reduced: the reference's parameter count and decode state; full
    qwen2-vl-72b on the meta device (no storage): 80 layers of 877.7 M
    parameters, 72.71 G in all; a config whose sections do not split
    head_dim // 2 is refused."""
    jcfg = j_get_reduced(ARCH)
    params = perturb_affine(jlm.init_model(jcfg, 0)[0], 0)
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    assert tlm.param_count(model) == jlm.param_count(params)
    st, jst = tlm.init_decode_state(model.cfg, 3, 16, "cpu"), jlm.init_decode_state(jcfg, 3, 16)
    assert set(st) == set(jst) == {"kv"}
    for key, t in st["kv"].items():
        assert tuple(t.shape) == jst["kv"][key].shape, key
    full = get_config(ARCH)
    meta = tlm.init_model(full, 0, device="meta")
    assert meta.device.type == "meta" and len(meta.blocks) == 80
    d, f, (qd, kvd) = full.d_model, full.d_ff, full.qkv_dims
    layer = 2 * d * qd + 2 * d * kvd + 3 * d * f + 2 * d
    assert layer == 877_674_496 and sum(t.numel() for t in meta.blocks[0].parameters()) == layer
    assert tlm.param_count(meta) == 80 * layer + 2 * full.vocab_padded * d + d
    with pytest.raises(ValueError, match="sections"):
        tlm.init_model(dataclasses.replace(full, mrope_sections=(16, 24, 16)), device="meta")


@pytest.mark.parametrize("bcsr", [False, True], ids=["dense", "bcsr"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_reference(dtype, bcsr):
    """Perturbed norms, 2 prompts of 8 vision slots and 12 text tokens at
    Qwen2-VL-layout positions: ``forward``'s logits over 20 tokens,
    ``prefill`` of the first 12 (its last logits and caches), then 8
    ``decode_step``s (the reference continues every stream at the cache's
    position, ROADMAP C.26, and so does the port)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, params, model = vlm_pair(jdt, bcsr)
    cfg = model.cfg
    batch = vlm_batch(cfg, 2, 20)
    ref, _ = jlm.forward(jcfg, params, jbatch(batch))
    got, aux = tlm.forward(cfg, model, batch)
    assert got.dtype == getattr(torch, dtype) and aux == 0.0
    close(got, ref, tol, "forward")
    jst, jlg = jlm.prefill(jcfg, params, jbatch(cut(batch, 12)), 32)
    tst, tlg = tlm.prefill(cfg, model, cut(batch, 12), 32)
    close(tlg, jlg, tol, "prefill logits")
    toks = batch["tokens"]
    for step in range(9):
        for key in ("k", "v"):
            close(tst["kv"][key], jst["kv"][key], tol, f"step {step} cache {key}")
        for key in ("positions", "pos"):
            assert np.array_equal(tst["kv"][key].numpy(), np.asarray(jst["kv"][key]))
        if step == 8:
            break
        t = toks[:, 12 + step:13 + step]
        jst, jlg = jlm.decode_step(jcfg, params, jst, jnp.asarray(t))
        tst, tlg = tlm.decode_step(cfg, model, tst, t)
        close(tlg, jlg, tol, f"decode {step}")


def test_decode_matches_forward_at_the_decode_positions():
    """The port alone, float32: prefill of 12 tokens and 8 decode steps
    equal ``forward`` over the same tokens at the positions decode gives
    them (the prompt's, then s, s + 1, ... on all three streams)."""
    _, _, model = vlm_pair(jnp.float32, seed=3)
    cfg = model.cfg
    batch = vlm_batch(cfg, 2, 20, seed=2)
    pos = batch["positions"].copy()
    pos[..., 12:] = np.arange(12, 20)
    full, _ = tlm.forward(cfg, model, {**batch, "positions": pos})
    st, lg = tlm.prefill(cfg, model, cut(batch, 12), 32)
    close(lg, full[:, 11].numpy(), F32_TOL, "prefill")
    for j in range(12, 20):
        st, lg = tlm.decode_step(cfg, model, st, batch["tokens"][:, j:j + 1])
        close(lg[:, 0], full[:, j].numpy(), F32_TOL, f"position {j}")


def test_layout_positions_and_vision_embeds_move_the_logits_in_both_packages():
    """Witnesses for the parity checks: Qwen2-VL-layout positions move the
    logits away from ``arange`` positions, and other vision embeddings
    move them, by far more than the float32 limit, in both packages."""
    jcfg, params, model = vlm_pair(jnp.float32)
    cfg = model.cfg
    laid, flat = vlm_batch(cfg, 2, 20), vlm_batch(cfg, 2, 20, layout=False)
    other = {**laid, "vision_embeds": vlm_batch(cfg, 2, 20, seed=9)["vision_embeds"]}
    for run in (lambda bt: np.asarray(jlm.forward(jcfg, params, jbatch(bt))[0]),
                lambda bt: tlm.forward(cfg, model, bt)[0].numpy()):
        base = run(laid)
        for moved in (run(flat), run(other)):
            assert np.abs(base - moved).max() > 100 * F32_TOL * np.abs(base).max()


def test_short_prompt_and_missing_vision_embeds_are_refused():
    """ROADMAP C.27.  A prompt shorter than the vision slots: the
    reference's splice makes n_vision_tokens positions out of it and fails
    deeper, in M-RoPE, broadcasting those against positions of the prompt's
    length; the port refuses it with a ``ValueError`` that says why before
    any layer runs, and refuses a batch without vision embeddings."""
    jcfg, params, model = vlm_pair(jnp.float32)
    cfg = model.cfg
    short = cut(vlm_batch(cfg, 1, cfg.n_vision_tokens + 4), cfg.n_vision_tokens - 3)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jlm.forward(jcfg, params, jbatch(short))
    with pytest.raises(ValueError, match="shorter than"):
        tlm.forward(cfg, model, short)
    with pytest.raises(ValueError, match="shorter than"):
        tlm.prefill(cfg, model, short, 32)
    full = vlm_batch(cfg, 1, 12)
    del full["vision_embeds"]
    with pytest.raises(ValueError, match="vision_embeds"):
        tlm.forward(cfg, model, full)

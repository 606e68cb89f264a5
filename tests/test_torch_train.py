"""The port's training (``repro_torch.models.lm.loss_fn``,
``repro_torch.runtime.trainer``, ``repro_torch.launch.train``) against the
JAX package's on the CPU, on the same numpy weights (carried by
``lm_params_from_numpy``) and the same batches (the two data pipelines are
equal: ``tests/test_torch_data.py``).

Tolerances (float32 unless stated; only the order of float32 sums
differs):

* ``loss_fn`` for every ``ARCH_ID``'s reduced config at float32: the loss
  and ``ce`` within 1e-5 relative, ``aux`` within 1e-5 absolute (0
  outside MoE), each gradient leaf within 1e-4 · max|ref leaf|, through
  the reference's layer-stacked layout (``interop.stack_params``).  The
  hybrid's Mamba-2 layers and LoRA are perturbed first (ROADMAP C.23).
* ``make_train_step`` with ``n_micro`` 1 and 4 at lr 1e-3, two steps: the
  metrics within 1e-5 relative, the parameters within 2e-5 absolute (the
  reference's own limits for grad accumulation, ``tests/test_runtime.py``).
* bf16: ``adamw_update`` on the reference's own bf16 gradients, whose
  clipped copies both packages round back to bf16: every new parameter
  within one bf16 ulp of the reference's.
* ``train_loop``'s crash and resume: the same steps run, every step's loss
  within 1e-4 relative of the reference's run.
* Learning: the reference's own criteria (the loss falls by 1.0 and below
  log 64 - 1 on the Markov chain in 50 steps; by 0.8 for the structured
  sparse FFN in 40).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import tree_paths as j_tree_paths
from repro.configs import ARCH_IDS, get_reduced as j_get_reduced
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.optim import adamw as ja
from repro.runtime import trainer as jt

from repro_torch.core.formats import bcsr_from_csr, csr_from_dense, sell_from_csr
from repro_torch.data.pipeline import MarkovTokens, SyntheticTokens, make_batch
from repro_torch.interop import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    port_config,
    stack_params,
    unstack_params,
)
from repro_torch.kernels import ops
from repro_torch.kernels.spmspv import spmspv_prepare, spmspv_scatter, stage_sparse
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import default_rules
from repro_torch.models import lm as tlm
from repro_torch.models.ffn import SparseFFNConfig
from repro_torch.optim import adamw as ta
from repro_torch.runtime import trainer as tt
from repro_torch.runtime.sharded import ShardedModel

from test_torch_hybrid import perturbed

LOSS_REL = 1e-5
AUX_ABS = 1e-5
GRAD_TOL = 1e-4
PARAM_ABS = 2e-5
JTINY = jlm.ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                        dtype=jnp.float32, remat="none", attn_chunk=16)
TINY = port_config(JTINY)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep this file
    to one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_close(got, ref, rel, what=""):
    got, ref = float(got), float(ref)
    assert np.isfinite(got), what
    assert abs(got - ref) <= rel * max(abs(ref), 1e-30), (what, got, ref)


def ref_params(jcfg, seed=0):
    params = numpy_tree(jlm.init_model(jcfg, seed)[0])
    return perturbed(params, seed + 10) if jcfg.family == "hybrid" else params


def port_grads(cfg, model, batch):
    params = tlm.trainable(model)
    loss, metrics = tlm.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    named = {name: (g if g is not None else torch.zeros_like(p)).detach().numpy()
             for (name, p), g in zip(params.items(), grads)}
    return loss.detach(), metrics, named


# ---------------------------------------------------------------------------
# loss and gradients, every architecture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_the_reference(arch):
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=jnp.float32)
    params = ref_params(jcfg)
    batch = make_batch(jcfg, B, S, step=0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = port_config(jcfg)
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    loss, metrics, named = port_grads(cfg, model, batch)
    rel_close(loss, jloss, LOSS_REL, "loss")
    rel_close(metrics["ce"], jm["ce"], LOSS_REL, "ce")
    rel_close(metrics["z_loss"], jm["z_loss"], LOSS_REL, "z_loss")
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= AUX_ABS
    assert (float(jm["aux"]) > 0) == (cfg.moe is not None)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == B * S
    ref, got = j_tree_paths(numpy_tree(jgrads)), j_tree_paths(stack_params(cfg, named))
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        err = np.abs(got[key].astype(np.float64) - r).max()
        assert err <= GRAD_TOL * max(np.abs(r).max(), 1e-30), (key, err, np.abs(r).max())
    assert any(np.abs(r).max() > 0 for r in ref.values())


def test_remat_full_recomputes_blocks_with_the_same_gradients():
    params = ref_params(JTINY)
    batch = make_batch(JTINY, B, S, step=1)
    grads = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(TINY, remat=remat)
        model = lm_params_from_numpy(cfg, params, device="cpu")
        grads[remat] = port_grads(cfg, model, batch)[2]
    for name, g in grads["none"].items():
        np.testing.assert_allclose(grads["full"][name], g, rtol=0, atol=1e-7 * max(
            np.abs(g).max(), 1e-30), err_msg=name)


def test_forward_follows_grad_mode_and_the_decode_path_stays_no_grad():
    model = tlm.init_model(TINY, 0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())  # built to serve
    params = tlm.trainable(model)
    assert set(params) == {n for n, _ in model.named_parameters()}
    batch = make_batch(TINY, B, S, step=0)
    logits, _ = tlm.forward(TINY, model, batch)
    assert logits.requires_grad
    with torch.no_grad():
        assert not tlm.forward(TINY, model, batch)[0].requires_grad
    state, last = tlm.prefill(TINY, model, batch, max_seq=32)
    assert not last.requires_grad
    _, step_logits = tlm.decode_step(TINY, model, state, batch["tokens"][:, -1:])
    assert not step_logits.requires_grad


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_the_reference(n_micro):
    params = ref_params(JTINY)
    data = SyntheticTokens(vocab=64, batch=8, seq=16, seed=1)
    jopt_cfg = ja.OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    topt_cfg = ta.OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jt.make_train_step(JTINY, jopt_cfg, n_micro))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = ja.adamw_init(jp, jopt_cfg)
    model = lm_params_from_numpy(JTINY, params, device="cpu")
    topt = ta.adamw_init(tlm.trainable(model), topt_cfg)
    tstep = tt.make_train_step(TINY, topt_cfg, n_micro)
    for step in range(2):
        batch = data.batch_at(step)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        model, topt, tm = tstep(model, topt, batch)
        keys = {"loss", "lr", "grad_norm"} | ({"ce", "z_loss", "aux"} if n_micro == 1
                                              else set())
        assert set(tm) == set(jm) == keys
        for key in keys - {"aux"}:
            rel_close(tm[key], jm[key], LOSS_REL, f"step {step} {key}")
        ref, got = j_tree_paths(numpy_tree(jp)), j_tree_paths(lm_params_to_numpy(TINY, model))
        for key, r in ref.items():
            np.testing.assert_allclose(got[key], r, rtol=0, atol=PARAM_ABS, err_msg=key)
        assert int(topt["count"]) == step + 1


def test_microbatched_equals_single_batch_gradients():
    """The reference's ``test_microbatched_equals_single_batch_gradients``,
    twinned: grad accumulation must not change the update."""
    batch = SyntheticTokens(vocab=64, batch=8, seq=16, seed=1).batch_at(0)
    opt_cfg = ta.OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for n_micro in (1, 4):
        model = tlm.init_model(TINY, 0, device="cpu")
        opt = ta.adamw_init(tlm.trainable(model), opt_cfg)
        runs.append(tt.make_train_step(TINY, opt_cfg, n_micro)(model, opt, batch))
    (m1, _, met1), (m4, _, met4) = runs
    assert abs(float(met1["loss"]) - float(met4["loss"])) < 1e-4
    for (name, a), b in zip(m1.state_dict().items(), m4.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=PARAM_ABS, msg=name)


def test_bf16_update_on_the_references_gradients_rounds_the_clipped_gradient():
    """A bf16 step with n_micro = 1: both packages round the clipped
    gradient back to bf16 before the float32 update."""
    jcfg = dataclasses.replace(JTINY, dtype=jnp.bfloat16)
    params = jax.tree.map(jnp.asarray, numpy_tree(jlm.init_model(jcfg, 0)[0]))
    batch = {k: jnp.asarray(v) for k, v in SyntheticTokens(64, 4, 16, seed=3).batch_at(0).items()}
    jgrads = jax.jit(jax.grad(lambda p: jlm.loss_fn(jcfg, p, batch)[0]))(params)
    kw = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    jnew, _, jm = jax.jit(lambda g, st, p: ja.adamw_update(g, st, p, ja.OptimConfig(**kw)))(
        jgrads, ja.adamw_init(params, ja.OptimConfig(**kw)), params)
    assert float(jm["grad_norm"]) > 1.0  # the clip scales, so its rounding matters
    cfg = port_config(jcfg)
    model = lm_params_from_numpy(jcfg, numpy_tree(params), device="cpu")
    tparams = tlm.trainable(model)
    grads = {name: torch.as_tensor(np.asarray(g, np.float32)).to(torch.bfloat16)
             for name, g in unstack_params(cfg, numpy_tree(jgrads)).items()}
    clipped, _ = ta.clip_by_global_norm(grads, 1.0)
    assert all(g.dtype == torch.bfloat16 for g in clipped.values())
    _, _, tm = ta.adamw_update(grads, ta.adamw_init(tparams, ta.OptimConfig(**kw)), tparams,
                               ta.OptimConfig(**kw))
    rel_close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
    ref = j_tree_paths(numpy_tree(jnew))
    got = j_tree_paths(lm_params_to_numpy(cfg, model))
    for key, r in ref.items():
        r = r.astype(np.float64)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0**-126))) - 7)
        assert np.all(np.abs(got[key] - r) <= ulp), key


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def test_train_loop_crash_and_resume_match_the_reference(tmp_path, monkeypatch):
    params = ref_params(JTINY)
    monkeypatch.setattr(tt, "init_model", lambda cfg, seed, device: lm_params_from_numpy(
        cfg, params, device=device))
    runs = {}
    for name, mod, opt in (("ref", jt, ja), ("port", tt, ta)):
        crashed = []

        def fault(step, crashed=crashed):
            if step == 15 and not crashed:
                crashed.append(step)
                raise RuntimeError("injected")

        tc = mod.TrainConfig(steps=30, ckpt_every=10, ckpt_dir=str(tmp_path / name),
                             log_every=1000)
        kw = {} if mod is jt else {"device": "cpu"}
        _, _, hist = mod.train_loop(
            JTINY if mod is jt else TINY,
            opt.OptimConfig(lr_peak=1e-3, warmup_steps=2, total_steps=30), tc,
            SyntheticTokens(vocab=64, batch=4, seq=16, seed=2), fault_hook=fault,
            log=lambda s: None, **kw)
        assert crashed == [15]
        runs[name] = hist
    steps = [h["step"] for h in runs["port"]]
    assert steps == [h["step"] for h in runs["ref"]]
    assert steps[-1] == 29 and steps.count(15) == 1 and steps.count(11) == 2
    for got, ref in zip(runs["port"], runs["ref"]):
        rel_close(got["loss"], ref["loss"], GRAD_TOL, f"step {got['step']}")


def test_training_learns_the_markov_chain(tmp_path):
    data = MarkovTokens(vocab=64, batch=8, seq=32, branch=4, seed=0)
    tc = tt.TrainConfig(steps=50, ckpt_every=0, ckpt_dir=str(tmp_path), log_every=1000)
    _, _, hist = tt.train_loop(TINY, ta.OptimConfig(lr_peak=3e-3, warmup_steps=10,
                                                    total_steps=50),
                               tc, data, log=lambda s: None, device="cpu")
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 1.0
    assert losses[-1] < np.log(64) - 1.0


def test_structured_sparse_ffn_lm_trains(tmp_path):
    cfg = dataclasses.replace(TINY, arch_id="sparse-lm", sparse_ffn=SparseFFNConfig(
        kind="structured", n_groups=4, band=1))
    tc = tt.TrainConfig(steps=40, ckpt_every=0, ckpt_dir=str(tmp_path), log_every=1000)
    _, _, hist = tt.train_loop(cfg, ta.OptimConfig(lr_peak=3e-3, warmup_steps=5,
                                                   total_steps=40),
                               tc, MarkovTokens(vocab=64, batch=8, seq=32, branch=4, seed=0),
                               log=lambda s: None, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.8


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen1.5-4b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--markov", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    summary = train_cli.main(argv)
    assert summary["steps"] == 3 and summary["tokens_per_step"] == 32
    assert np.isfinite(summary["last_loss"]) and summary["peak_allocated_bytes"] is None
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("step     0 loss") and json.loads(out[-1]) == summary
    assert train_cli.main(argv)["steps"] == 0  # resumed after the last step
    assert "[restore] resuming from checkpoint step 2" in capsys.readouterr().out
    # a mesh trains, resuming the single-device checkpoint in the logical layout
    on_mesh = train_cli.main(argv + ["--data", "2", "--steps", "5"])
    assert on_mesh["steps"] == 2 and on_mesh["mesh"] == {"data": 2, "model": 1}
    assert "[restore] resuming from checkpoint step 2" in capsys.readouterr().out
    sm, _, hist = tt.train_loop(TINY, ta.OptimConfig(), tt.TrainConfig(
        steps=2, ckpt_dir=str(tmp_path / "mesh")), SyntheticTokens(64, 4, 16, seed=0),
        mesh=make_mesh(1, 2, 4, device="cpu"), rules=default_rules(False),
        log=lambda s: None, device="cpu")
    assert isinstance(sm, ShardedModel) and [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)


# ---------------------------------------------------------------------------
# no silent detach: kernels refuse autograd
# ---------------------------------------------------------------------------
def _bcsr_cfg(impl):
    return dataclasses.replace(TINY, arch_id="bcsr-lm", sparse_ffn=SparseFFNConfig(
        kind="bcsr", block=(16, 16), density=0.5, impl=impl))


def test_cuda_tier_ffn_refuses_autograd_and_the_ref_tier_trains():
    batch = make_batch(TINY, B, S, step=0)
    model = tlm.init_model(_bcsr_cfg("cuda"), 0, device="cpu")
    params = tlm.trainable(model)
    assert not any("_rows" in n or "_cols" in n or "indptr" in n for n in params)
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        tlm.loss_fn(_bcsr_cfg("cuda"), model, batch)[0].backward()
    with torch.no_grad():  # serving is untouched
        assert torch.isfinite(tlm.forward(_bcsr_cfg("cuda"), model, batch)[0]).all()
    cfg = _bcsr_cfg("ref")
    opt_cfg = ta.OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    before = model.blocks[0].ffn.w1_blocks.detach().clone()
    _, _, metrics = tt.make_train_step(cfg, opt_cfg)(model, ta.adamw_init(params, opt_cfg),
                                                    batch)
    assert float(metrics["grad_norm"]) > 0
    assert not torch.equal(model.blocks[0].ffn.w1_blocks, before)


def test_reference_cannot_differentiate_its_pallas_ffn_or_a_bcsr_tree():
    """Where the port raises, the reference raises too (ROADMAP C.29): its
    ``jax.grad`` through the Pallas tier, and its train step over a bcsr
    model, whose int32 block indices are leaves of the differentiated tree."""
    jcfg = dataclasses.replace(JTINY, sparse_ffn=jffn.SparseFFNConfig(
        kind="bcsr", block=(16, 16), density=0.5, impl="pallas"))
    params = jlm.init_model(jcfg, 0)[0]
    p = jax.tree.map(lambda a: a[0], params["blocks"]["ffn"])
    x = jnp.ones((1, 4, 64), jnp.float32)

    def ffn_sum(w1, impl):
        c = dataclasses.replace(jcfg.sparse_ffn, impl=impl)
        return jffn.sparse_ffn_apply({**p, "w1_blocks": w1}, x, c, jcfg.d_ff).sum()

    with pytest.raises(NotImplementedError):
        jax.grad(ffn_sum)(p["w1_blocks"], "pallas")
    assert float(jnp.abs(jax.grad(ffn_sum)(p["w1_blocks"], "ref")).sum()) > 0
    batch = {k: jnp.asarray(v) for k, v in make_batch(JTINY, B, S, 0).items()}
    with pytest.raises(TypeError, match="int32"):
        jax.grad(lambda q: jlm.loss_fn(jcfg, q, batch)[0])(params)


def _wrapper_calls():
    """The four kernel wrappers on small CPU operands: (name, call(x))
    where x is the dense operand that may require grad."""
    rng = np.random.default_rng(0)
    dense = (rng.random((64, 64)) < 0.1) * rng.standard_normal((64, 64))
    a = csr_from_dense(dense.astype(np.float32))
    sell = ops.sell_prepare(sell_from_csr(a, C=8, sigma=16), device="cpu")
    slabs = ops.sell_prepare_blocked_stacked(a, 2, device="cpu")
    bcsr = ops.bcsr_prepare(bcsr_from_csr(a, (8, 8)), device="cpu")
    sp = spmspv_prepare(a, device="cpu")
    staged = stage_sparse(sp, np.array([1, 5, 9], np.int32),
                          np.array([1.0, -2.0, 0.5], np.float32))
    return (
        ("sell_spmv", torch.ones(64), lambda x: ops.sell_spmv(sell, x)),
        ("sell_spmv_blocked", torch.ones(64),
         lambda x: ops.sell_spmv_blocked_stacked(slabs, x)),
        ("bcsr_spmm", torch.ones(64, 3), lambda x: ops.bcsr_spmm(bcsr, x)),
        ("spmspv_scatter", staged["xv"].clone(),
         lambda x: spmspv_scatter(sp, staged["xi"], x, staged["flags"], staged["plan"])),
    )


@pytest.mark.parametrize("which", range(4))
def test_every_kernel_wrapper_refuses_an_operand_that_requires_grad(which):
    name, x, call = _wrapper_calls()[which]
    y = call(x)  # grad mode on, nothing requires grad: runs
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match=name):
        call(x)
    with torch.no_grad():
        assert torch.equal(call(x), y)

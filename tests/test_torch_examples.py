"""The four example twins (``examples/*_torch.py``) against the JAX
package's functions on the same seeded numpy inputs, on the CPU.

Each twin is loaded from its path and its ``main([..., "--device",
"cpu"])`` run; what it returns is held against ``repro``'s functions, not
against ``repro``'s example scripts (which would run Pallas in interpret
mode):

* quickstart: the metrics and RCM exactly; y, Y and every kernel, tuned
  and engine product within 1e-5 (|A| |x|)_i of ``repro``'s ``spmv_csr`` /
  ``spmm_csr`` and of a float64 oracle; a cache hit; no supervisor event;
* serve_decode, at a reduced width: the greedy tokens at 1, 4 and 8 slots
  equal ``repro``'s ``BatchedServer`` on the same weights (carried by
  ``interop.lm_params_from_numpy``); the engine's results at 1e-5;
* sparse_eigensolver ``--smoke``: the Ritz values within 1e-4 relative of
  ``repro``'s ``block_power``, and the example's own 5 % assertion;
* train_lm at a tiny config over 3 steps: every loss within 1e-5 relative
  of ``repro``'s ``train_loop`` and the parameters within 2e-5 (PERF.md
  §2's training limits), on the same initial weights and data; over 60
  steps, past the warmup, every loss within 1e-5 relative.
Without ``--device cpu`` each twin raises on a machine with no card.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import tree_paths as j_tree_paths
from repro.core import csr_to_dense as j_csr_to_dense
from repro.core import matrix_bandwidth as j_bandwidth
from repro.core import rcm as j_rcm
from repro.core import spmm_csr as j_spmm_csr
from repro.core import spmv_csr as j_spmv_csr
from repro.core import symmetrize as j_symmetrize
from repro.core import ucld as j_ucld
from repro.core import utd as j_utd
from repro.data.pipeline import MarkovTokens as JMarkovTokens
from repro.data.suite import generate as j_generate
from repro.models import lm as jlm
from repro.optim import adamw as ja
from repro.runtime import trainer as jt
from repro.runtime.server import BatchedServer as JServer
from repro.runtime.server import Request as JRequest
from repro.runtime.solver import SparseSolver as JSolver
from repro.tune import PlanCache as JPlanCache

from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.runtime import trainer as tt
from repro_torch.tune import PlanCache
from repro_torch.tune import plan as tplan

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOSS_REL = 1e-5
PARAM_ABS = 2e-5
TWINS = ("quickstart", "serve_decode", "sparse_eigensolver", "train_lm")
WITNESS_STEPS = 60  # past the example's 20 warmup steps


@pytest.fixture(autouse=True)
def _quiet_state(monkeypatch):
    """One intra-op thread (the suite runs in several workers at once), and
    an in-memory default plan cache (the eigensolver builds on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tplan, "_default", PlanCache())
    yield
    torch.set_num_threads(n)


def load(name: str):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float64)


def within(got, ref, scale, what):
    err = np.abs(_np(got) - _np(ref))
    assert err.shape == scale.shape, (what, err.shape, scale.shape)
    assert np.all(err <= TOL * scale), (what, float((err - TOL * scale).max()))


def test_quickstart_matches_repro():
    out = load("quickstart").main(["--device", "cpu"])
    a = j_generate("cant", scale=1 / 64)
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(out["a"], key), getattr(a, key))
    assert (out["ucld"], out["utd"], out["bandwidth"]) == (j_ucld(a), j_utd(a),
                                                          j_bandwidth(a))
    perm = j_rcm(a)
    np.testing.assert_array_equal(out["rcm"], perm)
    ar = a.permuted(perm)
    assert (out["ucld_rcm"], out["bandwidth_rcm"]) == (j_ucld(ar), j_bandwidth(ar))

    m, n = a.shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, 16)).astype(np.float32)
    np.testing.assert_array_equal(out["x"].numpy(), x)
    np.testing.assert_array_equal(out["X"].numpy(), X)
    A = j_csr_to_dense(a).astype(np.float64)
    y_ref = j_spmv_csr(a.device(), jnp.asarray(x), n_rows=m)
    Y_ref = j_spmm_csr(a.device(), jnp.asarray(X), n_rows=m)
    sx, sX = np.abs(A) @ np.abs(x), np.abs(A) @ np.abs(X)
    for key in ("y", "y_k", "y_t"):
        within(out[key], y_ref, sx, f"{key} against repro")
        within(out[key], A @ x, sx, f"{key} against float64")
    for key in ("Y", "Y_k"):
        within(out[key], Y_ref, sX, f"{key} against repro")
        within(out[key], A @ X, sX, f"{key} against float64")
    assert out["from_cache"]
    assert out["engine"]["requests"] == 9 and out["engine"]["failed_requests"] == 0
    assert not {"batch_failed", "demote", "batch_abandoned"} & set(out["engine_events"])
    for xi, yi in zip(out["engine_xs"], out["engine_ys"]):
        within(yi, A @ xi, np.abs(A) @ np.abs(xi), "engine request")


def test_serve_decode_tokens_equal_the_reference_server(monkeypatch):
    mod = load("serve_decode")
    dims = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    monkeypatch.setattr(mod, "DEMO_DIMS", dims)
    jcfg = jlm.ModelConfig(arch_id="serve-demo", family="dense", dtype=jnp.float32,
                           remat="none", attn_chunk=64, **dims)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    monkeypatch.setattr(mod, "init_model", lambda cfg, seed, device: lm_params_from_numpy(
        jcfg, params, device=device))
    out = mod.main(["--device", "cpu"])

    srv = JServer(jcfg, params, batch_slots=4, max_seq=128)
    rng = np.random.default_rng(0)
    reqs = [JRequest(rid=i, prompt=rng.integers(0, dims["vocab"], 4).astype(np.int32),
                     max_new=16) for i in range(8)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    ref = [list(r.out) for r in reqs]
    assert all(len(t) == 16 for t in ref)
    for slots in (1, 4, 8):
        assert out["lm"][slots]["tokens"] == ref, slots
        assert out["lm"][slots]["prefills"] == 8
    assert (out["lm"][4]["steps"], out["lm"][4]["occupancy"]) == (srv.steps, srv.occupancy)

    eng = out["engine"]
    A = j_csr_to_dense(j_generate("cant", scale=1 / 128)).astype(np.float64)
    assert eng["summary"]["requests"] == 32 and not eng["events"]
    for xi, yi in zip(eng["xs"], eng["ys"]):
        xi = xi.numpy()
        within(yi, A @ xi, np.abs(A) @ np.abs(xi), "engine request")


def test_eigensolver_smoke_ritz_values_match_repro():
    out = load("sparse_eigensolver").main(["--smoke", "--device", "cpu"])
    a = j_symmetrize(j_generate("2cubes_sphere", scale=1 / 256))
    ref = JSolver(a, cache=JPlanCache(), warmup=0, timed=1).block_power(
        8, tol=1e-4, maxiter=60, seed=0)
    assert out["result"].iterations == ref.iterations
    np.testing.assert_allclose(out["ritz"], np.sort(np.abs(ref.eigenvalues))[::-1],
                               rtol=1e-4)
    assert out["rel_err"] < 0.05


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "structured"])
def test_train_lm_losses_and_parameters_match_repro(monkeypatch, tmp_path, sparse):
    mod = load("train_lm")
    dims = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=64)
    monkeypatch.setattr(mod, "SMALL_DIMS", dims)
    monkeypatch.setattr(mod, "BATCH", 4)
    monkeypatch.setattr(mod, "SEQ", 16)
    jsff = None
    if sparse:
        from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig

        jsff = JSparseFFNConfig(kind="structured", n_groups=8, band=1)
    jcfg = jlm.ModelConfig(arch_id="example-lm", family="dense", dtype=jnp.float32,
                           remat="none", attn_chunk=128, sparse_ffn=jsff, **dims)
    params = jax.tree.map(np.asarray, jlm.init_model(jcfg, 0)[0])
    monkeypatch.setattr(tt, "init_model", lambda cfg, seed, device: lm_params_from_numpy(
        jcfg, params, device=device))
    argv = ["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")]
    out = mod.main(argv + (["--sparse"] if sparse else []))

    jparams, _, jhist = jt.train_loop(
        jcfg, ja.OptimConfig(lr_peak=6e-4, warmup_steps=20, total_steps=3),
        jt.TrainConfig(steps=3, microbatches=2, ckpt_every=50,
                       ckpt_dir=str(tmp_path / "ref"), log_every=10),
        JMarkovTokens(vocab=64, batch=4, seq=16, branch=8, seed=0), log=lambda s: None)
    hist = out["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2]
    for got, want in zip(hist, jhist):
        assert abs(got["loss"] - float(want["loss"])) <= LOSS_REL * abs(float(want["loss"]))
    ref = j_tree_paths(jax.tree.map(np.asarray, jparams))
    got = j_tree_paths(lm_params_to_numpy(out["cfg"], out["model"]))
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=0, atol=PARAM_ABS, err_msg=key)
    assert out["entropy_floor"] == pytest.approx(
        JMarkovTokens(vocab=64, batch=4, seq=16, branch=8, seed=0).entropy_floor())


def test_train_lm_losses_track_repro_past_warmup(tmp_path):
    """The example's schedule run on past its 20 warmup steps, at a tiny
    size: every loss within 1e-5 relative of ``repro``'s ``train_loop``
    (``witness_train_lm.py`` runs the same comparison at the example's
    width over 300 steps)."""
    from witness_train_lm import curves

    dims = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=64)
    res = curves(dims, WITNESS_STEPS, 4, 16, tmp_path)
    assert len(res["port"]) == len(res["repro"]) == WITNESS_STEPS
    assert res["max_rel"] <= LOSS_REL, (res["max_rel"], res["max_rel_step"])
    assert res["last20"]["repro"] < res["first5"]["repro"]


@pytest.mark.parametrize("name", TWINS)
def test_each_twin_raises_without_a_card_by_default(name, tmp_path):
    if torch.cuda.is_available():
        return  # on a card the default device is there
    argv = ["--steps", "1", "--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv + (["--smoke"] if name == "sparse_eigensolver" else []))

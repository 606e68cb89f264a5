"""The port's iterative solvers (``repro_torch.runtime.solver``) and the
tuner's ``solver_step`` kind against the JAX package's, on ``device="cpu"``.

Inputs are made with numpy from a seed and go through ``repro`` and
``repro_torch`` alike.  Tolerances, each with its reason:

* byte-model estimates and candidate keys: equal (the same arithmetic);
* CG x against ``repro``'s x: 1e-5 relative to max|x|, and the iteration
  counts within 2: both are float32 CG on the same operator, and only the
  summation order of the products and dots differs;
* the port's device-decided loop against its own host loop: the same
  count and flag, x within atol 1e-6 (both run the same step functions);
* Ritz values against ``numpy.linalg.eigvalsh``: as ``tests/test_solver.py``
  holds ``repro`` (1e-3 relative at the extremes).
"""
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core import csr_from_dense as j_csr_from_dense
from repro.core import spd_shift as j_spd_shift
from repro.data.suite import generate as j_generate
from repro.runtime import faults as jfaults
from repro.runtime import supervisor as jsup
from repro.runtime.solver import SparseSolver as JSolver
from repro.tune.operator import solver_step_probe as j_probe

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.core.spmv import spd_shift
from repro_torch.data.suite import generate
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.solver import (
    SparseSolver,
    block_power_host_loop,
    cg_host_loop,
    tridiag_eigvalsh,
)
from repro_torch.runtime.supervisor import Supervisor

torch.set_num_threads(1)

SUP_KW = dict(backoff_base_s=0.0, backoff_cap_s=0.0)


def dense_spd(seed=0, n=200, density=0.03):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, n)) < density) * rng.standard_normal((n, n))).astype(
        np.float32)


def random_spd(seed=0, n=200):
    """The same SPD operator on both sides: (repro's, the port's)."""
    d = dense_spd(seed, n)
    return j_spd_shift(j_csr_from_dense(d)), spd_shift(csr_from_dense(d))


def todense(a):
    out = np.zeros(a.shape)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    np.add.at(out, (rows, a.indices), a.data.astype(np.float64))
    return out


def solver(a, cache=None, **kw):
    return SparseSolver(a, cache=cache if cache is not None else tt.PlanCache(),
                        warmup=0, timed=1, device="cpu", **kw)


def jsolver(a, cache=None, **kw):
    return JSolver(a, cache=cache if cache is not None else jt.PlanCache(),
                   warmup=0, timed=1, **kw)


def rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def ported(key):
    return key.replace("/pallas", "/cuda")


# The port's k = 1 solver_step space on the operator of the candidate test.
_SPACE_1 = [c.key() for c in tt.enumerate_candidates(
    tt.extract(random_spd(seed=5)[1], k=1), "solver_step", k=1)]


# -- the tuner's solver_step kind ---------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 8])
def test_solver_step_keys_and_fused_costs_match_repro(k):
    for name in ("shallow_water1", "cant"):
        ja, ta = j_generate(name, scale=1 / 256), generate(name, scale=1 / 256)
        jfe, tfe = jt.extract(ja, k=k), tt.extract(ta, k=k)
        jc = jt.enumerate_candidates(jfe, "solver_step", k=k)
        tc = tt.enumerate_candidates(tfe, "solver_step", k=k)
        assert [c.key() for c in tc] == [ported(c.key()) for c in jc]
        assert all(c.impl != "scalar" for c in tc)
        by_key = {ported(c.key()): c for c in jc}
        for c in tc:
            for on_cpu in (True, False):
                for fused in (True, False):
                    assert tt.estimate_cost(ta, c, tfe, k=k, on_cpu=on_cpu,
                                            fused=fused) == jt.estimate_cost(
                        ja, by_key[c.key()], jfe, k=k, on_cpu=on_cpu, fused=fused
                    ), (name, c.key(), on_cpu, fused)
    assert (tt.SOLVER_STEP_AMORTIZE, tt.SOLVER_VEC_PASSES) == (
        jt.candidates.SOLVER_STEP_AMORTIZE, jt.candidates.SOLVER_VEC_PASSES)


@pytest.mark.parametrize("k", [1, 4])
def test_solver_step_probe_matches_repro(k):
    """The timed composite computes the JAX package's probe (1e-5 relative:
    the summation order of the product and the dots differs)."""
    ja, ta = random_spd(seed=21)
    n = ta.shape[1]
    x = np.random.default_rng(22).standard_normal((n,) if k == 1 else (n, k)).astype(
        np.float32)
    jcand = jt.make("csr", "vector")
    jrun = jt.operator.runner(ja, jcand, jt.prepare(ja, jcand), k=k)
    trun = tt.runner(ta, tt.make("csr", "vector"),
                     tt.prepare(ta, tt.make("csr", "vector"), device="cpu"), k=k)
    want = np.asarray(j_probe(jrun, k)(x))
    got = tt.solver_step_probe(trun, k)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_solver_step_build_refuses_a_sparse_rhs():
    _, ta = random_spd(seed=2, n=64)
    with pytest.raises(ValueError, match="mutually exclusive with k=/solver_step="):
        tt.SparseOperator.build(ta, solver_step=True, x_nnz=4, device="cpu")


def test_solver_plans_cached_as_solver_step_and_reloaded(tmp_path):
    _, a = random_spd(seed=18)
    path = tmp_path / "plans.json"
    s = SparseSolver(a, cache=tt.PlanCache(path), warmup=0, timed=1, device="cpu")
    b = np.ones(a.shape[0], np.float32)
    s.cg(b, maxiter=50)
    s.block_power(4, maxiter=5)
    assert not s.from_cache
    assert {s.op(k).plan.kind for k in (1, 4)} == {"solver_step"}
    assert [s.op(k).plan.k for k in (1, 4)] == [1, 4]
    s2 = SparseSolver(a, cache=tt.PlanCache(path), device="cpu")
    r2 = s2.cg(b, maxiter=50)
    s2.block_power(4, maxiter=5)
    assert s2.from_cache
    assert r2.plan == s.op(1).plan.candidate.key()
    # A plain SpMV build is not shadowed by the solver-step plan.
    op = tt.SparseOperator.build(a, cache=tt.PlanCache(path), warmup=0, timed=1,
                                 device="cpu")
    assert not op.from_cache and op.plan.kind == "spmv"


# -- CG against repro, under every candidate ---------------------------------
@pytest.mark.parametrize("key", _SPACE_1)
def test_cg_matches_repro_under_every_solver_step_candidate(key):
    ja, ta = random_spd(seed=5)
    b = rhs(ta.shape[0], 6)
    tcand = next(c for c in tt.enumerate_candidates(tt.extract(ta, k=1),
                                                    "solver_step", k=1)
                 if c.key() == key)
    jcand = next(c for c in jt.enumerate_candidates(jt.extract(ja, k=1),
                                                    "solver_step", k=1)
                 if ported(c.key()) == key)
    ref = jsolver(ja, candidates=[jcand]).cg(b, tol=1e-6, maxiter=600)
    res = solver(ta, candidates=[tcand]).cg(b, tol=1e-6, maxiter=600)
    assert res.plan == key and ported(ref.plan) == key
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 2
    x_ref = np.asarray(ref.x, np.float64)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-5 * np.abs(x_ref).max()
    x64 = np.linalg.solve(todense(ta), b.astype(np.float64))
    assert np.abs(res.x.numpy() - x64).max() <= 1e-4 * np.abs(x64).max()


@pytest.mark.parametrize("name", ["shallow_water1", "2cubes_sphere", "scircuit"])
def test_tuned_cg_on_spd_suite_matches_repro_and_the_direct_solve(name):
    ja = j_spd_shift(j_generate(name, scale=1 / 256))
    ta = spd_shift(generate(name, scale=1 / 256))
    b = rhs(ta.shape[0], 0)
    ref = jsolver(ja).cg(b, tol=1e-6, maxiter=600)
    res = solver(ta).cg(b, tol=1e-6, maxiter=600)
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 2
    x_ref = np.asarray(ref.x, np.float64)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-5 * np.abs(x_ref).max()
    dense = todense(ta)
    x64 = np.linalg.solve(dense, b.astype(np.float64))
    assert np.abs(res.x.numpy() - x64).max() <= 1e-4 * np.abs(x64).max()
    # the recursive residual the solve reports is close to the true one
    true = np.linalg.norm(dense @ res.x.numpy().astype(np.float64) - b)
    assert res.residual <= 2.0 * true + 1e-4


# -- the device-decided loop against the host loop ---------------------------
@pytest.mark.parametrize("block", [1, 16])
def test_device_loop_equals_host_loop(block):
    _, a = random_spd(seed=9)
    s = solver(a, block=block)
    b = rhs(a.shape[0], 10)
    # converged; a fixed budget of 37 (no multiple of 16); capped at 5
    for tol, maxiter in ((1e-6, 400), (-1.0, 37), (1e-12, 5)):
        fused = s.cg(b, tol=tol, maxiter=maxiter)
        host = cg_host_loop(s.op(1)._run, b, tol=tol, maxiter=maxiter, device="cpu")
        assert (fused.iterations, fused.converged) == (host.iterations, host.converged)
        assert fused.residual == host.residual
        np.testing.assert_allclose(fused.x.numpy(), host.x.numpy(), rtol=0, atol=1e-6)
        assert fused.syncs < host.syncs or block == 1
    assert not fused.converged and fused.iterations == 5
    v0 = np.random.default_rng(12).standard_normal((a.shape[0], 4)).astype(np.float32)
    for tol, maxiter in ((1e-4, 400), (1e-9, 21)):
        fused = s.block_power(4, tol=tol, maxiter=maxiter, v0=v0)
        host = block_power_host_loop(s.op(4)._run, v0, tol=tol, maxiter=maxiter,
                                     device="cpu")
        assert (fused.iterations, fused.converged) == (host.iterations, host.converged)
        np.testing.assert_allclose(fused.eigenvalues, host.eigenvalues, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(fused.eigenvectors.numpy(),
                                   host.eigenvectors.numpy(), rtol=0, atol=1e-6)
    assert fused.iterations == 21 and not fused.converged


def test_one_read_per_block():
    """Blocks grow 1, 2, 4, ... up to ``block``; the host reads the flag
    after every block but one that spends the budget, then the final
    state once."""
    _, a = random_spd(seed=9)
    b = rhs(a.shape[0], 10)
    # 40 iterations: 40 blocks of 1; 1+2+4*9+1 (12 blocks); 1+2+4+8+16+9 (6)
    for block, syncs in ((1, 40), (4, 12), (16, 6)):
        res = solver(a, block=block).cg(b, tol=-1.0, maxiter=40)
        assert res.iterations == 40 and res.syncs == syncs
    host = cg_host_loop(solver(a).op(1)._run, b, tol=-1.0, maxiter=40, device="cpu")
    assert host.syncs == 43
    # converged after 8 iterations: after blocks of 1, 2, 4 and 8 the flag
    # reads active, active, active, done; 7 masked iterations ran
    res = solver(a, block=16).cg(b, tol=1e-6, maxiter=400)
    assert res.converged and res.iterations == 8 and res.syncs == 4 + 1


def test_negative_tol_is_fixed_budget_and_maxiter_caps():
    _, a = random_spd(seed=19)
    s = solver(a)
    b = np.ones(a.shape[0], np.float32)
    for n_it in (11, 40):
        res = s.cg(b, tol=-1.0, maxiter=n_it)
        host = cg_host_loop(s.op(1)._run, b, tol=-1.0, maxiter=n_it, device="cpu")
        assert res.iterations == host.iterations == n_it
        assert not res.converged and not host.converged
    capped = s.cg(b, tol=1e-12, maxiter=3)  # an unreachable tol in float32
    assert capped.iterations == 3 and not capped.converged and capped.residual > 0
    v0 = np.random.default_rng(20).standard_normal((a.shape[0], 4)).astype(np.float32)
    bp = s.block_power(4, tol=-1.0, maxiter=7, v0=v0)
    hbp = block_power_host_loop(s.op(4)._run, v0, tol=-1.0, maxiter=7, device="cpu")
    assert bp.iterations == hbp.iterations == 7
    assert not bp.converged and not hbp.converged


# -- eigensolvers -------------------------------------------------------------
def test_lanczos_extreme_ritz_values_match_eigvalsh_and_repro():
    ja, a = random_spd(seed=7)
    w = np.linalg.eigvalsh(todense(a))
    res = solver(a).lanczos(num_steps=80, seed=1)
    assert res.iterations == 80 and res.alphas.shape == (80,) and res.syncs == 1
    assert abs(res.eigenvalues[-1] - w[-1]) / abs(w[-1]) < 1e-3
    assert abs(res.eigenvalues[0] - w[0]) / abs(w[-1]) < 1e-2
    ref = jsolver(ja).lanczos(num_steps=80, seed=1)
    assert abs(res.eigenvalues[-1] - ref.eigenvalues[-1]) / abs(w[-1]) < 1e-5


def test_block_power_top_k_matches_eigvalsh_and_repro():
    ja, a = random_spd(seed=8)
    w = np.linalg.eigvalsh(todense(a))
    res = solver(a).block_power(4, tol=1e-6, maxiter=800, seed=2)
    got = np.sort(res.eigenvalues)[::-1]
    np.testing.assert_allclose(got[:2], w[::-1][:2], rtol=1e-3)
    assert tuple(res.eigenvectors.shape) == (a.shape[0], 4)
    vtv = (res.eigenvectors.T @ res.eigenvectors).numpy()
    np.testing.assert_allclose(vtv, np.eye(4), atol=1e-4)
    ref = jsolver(ja).block_power(4, tol=1e-6, maxiter=800, seed=2)
    np.testing.assert_allclose(got[:2], np.sort(ref.eigenvalues)[::-1][:2], rtol=1e-5)


def test_tridiag_eigvalsh_matches_dense():
    rng = np.random.default_rng(3)
    al = rng.standard_normal(12)
    be = np.abs(rng.standard_normal(11)) + 0.1
    t = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
    np.testing.assert_allclose(tridiag_eigvalsh(al, be), np.linalg.eigvalsh(t),
                               atol=1e-10)


# -- supervision --------------------------------------------------------------
def test_injected_dispatch_fault_retries_then_demotes_as_repro():
    ja, a = random_spd(seed=23)
    b = rhs(a.shape[0], 24)
    spec = "solver.dispatch:n=3"
    tsup = Supervisor(max_retries=2, **SUP_KW)
    jsupv = jsup.Supervisor(max_retries=2, **SUP_KW)
    res = solver(a, faults=FaultPlan(spec), supervisor=tsup, name="s").cg(
        b, tol=1e-6, maxiter=400)
    ref = jsolver(ja, faults=jfaults.FaultPlan(spec), supervisor=jsupv, name="s").cg(
        b, tol=1e-6, maxiter=400)
    kinds = [e.kind for e in tsup.events]
    assert kinds == [e.kind for e in jsupv.events] == [
        "solver_attempt_failed"] * 3 + ["demote", "solver_recovered"]
    (dem,) = tsup.events_of("demote")
    assert dem.info["tier"] == "csr/vector" and dem.info["k"] == 1
    assert (tsup.retries, tsup.demotions) == (jsupv.retries, jsupv.demotions) == (2, 1)
    assert res.plan == ref.plan == "csr/vector"
    assert res.converged and abs(res.iterations - ref.iterations) <= 2
    x_ref = np.asarray(ref.x, np.float64)
    assert np.abs(res.x.numpy() - x_ref).max() <= 1e-5 * np.abs(x_ref).max()


def test_a_fault_on_every_dispatch_walks_the_chain_and_raises():
    _, a = random_spd(seed=25, n=64)
    sup = Supervisor(max_retries=1, **SUP_KW)
    s = solver(a, faults=FaultPlan("solver.dispatch"), supervisor=sup)
    with pytest.raises(tfaults.InjectedFault):
        s.block_power(4, maxiter=5)
    assert [e.info["tier"] for e in sup.events_of("demote")] == ["csr/vector", "sell/ref"]
    assert [e.kind for e in sup.events][-1] == "solver_failed" and sup.failures == 1


def test_nan_guard_demotes_a_plan_that_returns_non_finite_values():
    _, a = random_spd(seed=28, n=64)
    b = np.ones(64, np.float32)
    for guard in (False, True):
        sup = Supervisor(max_retries=1, **SUP_KW)
        s = solver(a, supervisor=sup, nan_guard=guard)
        sick = tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"),
                                                device="cpu")
        sick._run = lambda x: x * float("nan")
        s._ops[1] = sick
        res = s.cg(b, tol=1e-6, maxiter=50)
        if not guard:  # unguarded, the non-finite state comes back as it is
            assert np.isnan(res.residual) and not res.converged
            assert sup.events == []
            continue
        assert [e.kind for e in sup.events] == [
            "solver_attempt_failed", "solver_attempt_failed", "demote",
            "solver_recovered"]
        assert "NonFiniteOutput" in sup.events[0].info["error"]
        assert res.plan == "csr/vector" and res.converged


def test_the_env_plan_arms_solver_dispatch(monkeypatch):
    monkeypatch.setattr(tfaults, "_active", None)
    monkeypatch.setattr(tfaults, "_env_checked", False)
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "solver.dispatch:n=1")
    try:
        _, a = random_spd(seed=26, n=64)
        sup = Supervisor(max_retries=2, **SUP_KW)
        res = solver(a, supervisor=sup).cg(np.ones(64, np.float32), maxiter=50)
        assert res.converged
        assert [e.kind for e in sup.events] == ["solver_attempt_failed",
                                                "solver_recovered"]
        assert tfaults.active_plan().fired("solver.dispatch") == 1
    finally:
        tfaults.set_active(None)


def test_unfaulted_solves_record_no_event_and_mesh_raises():
    """Unfaulted solves record nothing.  Mesh solves are ported: what still
    raises is a mesh whose first device is not the solver's ``device``
    (a CPU mesh asked to solve on a card)."""
    from repro_torch.launch.mesh import make_spmm_mesh

    _, a = random_spd(seed=27, n=64)
    s = solver(a)
    s.cg(np.ones(64, np.float32), maxiter=50)
    s.lanczos(num_steps=8)
    assert s.supervisor.events == [] and s.supervisor.demotions == 0
    mesh = make_spmm_mesh(2, device="cpu")
    ms = SparseSolver(a, mesh=mesh, cache=tt.PlanCache(), warmup=0, timed=1)
    ms.cg(np.ones(64, np.float32), maxiter=50)
    assert ms.supervisor.events == [] and ms.op(1).plan.fmt == "dist"
    with pytest.raises((ValueError, RuntimeError)):
        SparseSolver(a, mesh=mesh, device="cuda")

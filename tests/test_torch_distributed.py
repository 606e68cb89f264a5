"""The port's row-partitioned and mesh serving against the JAX package's and
a float64 dense oracle, on ``device="cpu"``.

The JAX package runs here at P = 1 (this process has one jax device, so its
``shard_map`` collectives are degenerate) and, once per file, at P = 4 in a
subprocess started with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(as ``tests/test_distributed.py`` does) that writes every reference output
to one ``.npz``.  The port runs in this process at P in {1, 2, 3, 4}: a CPU
mesh puts every shard on the CPU.

Tolerances, each with its reason:

* products (both schedules, ``stacked_spmm``, the engines): per row
  ``1e-5 (|A| |x|)_i`` against the float64 oracle and against ``repro``:
  only the summation order differs;
* byte-model estimates, candidate keys, plan keys: equal;
* solvers: as ``tests/test_torch_solver.py`` holds the single-device ones
  (CG counts within 2 and x within 1e-5 of max|x|; Ritz values 1e-5).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.tune as jt
from repro.core import distributed as jd
from repro.core import spd_shift as j_spd_shift
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.core.partition import rows_balanced as j_rows_balanced
from repro.core.partition import stack_csr_shards as j_stack_csr_shards
from repro.data.suite import generate as j_generate
from repro.launch.mesh import make_spmm_mesh as j_make_spmm_mesh
from repro.runtime.engine import SparseEngine as JEngine
from repro.runtime.solver import SparseSolver as JSolver

import repro_torch.tune as tt
from repro_torch.core import distributed as td
from repro_torch.core.distributed import Mesh
from repro_torch.core.formats import csr_from_dense
from repro_torch.core.partition import rows_balanced, stack_csr_shards
from repro_torch.core.spmv import spd_shift
from repro_torch.data.suite import generate
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_spmm_mesh
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.solver import SparseSolver
from repro_torch.runtime.supervisor import Supervisor
from repro_torch.tune import plan as tplan
from repro_torch.tune.predict import predict_candidate

torch.set_num_threads(1)

TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SUP_KW = dict(backoff_base_s=0.0, backoff_cap_s=0.0, repair_interval_s=0.005)
K_WIDTHS = (1, 3, 8)
SCHED_CASE = (37, 41, 0.2, 3)  # (m, n, density, seed): n not divisible by 2, 3, 4
ENGINE_CASE = (64, 64, 0.08, 4)
SOLVER_CASE = (60, 0.05, 7)  # (n, density, seed) of spd_shift


def dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32)


def rhs(n, k, seed):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return x[:, 0] if k == 1 else x


def assert_rowtol(got, d, x, want=None):
    """|got - want| <= 1e-5 (|A| |x|)_i, want the float64 product."""
    d64, x64 = d.astype(np.float64), np.asarray(x, np.float64)
    want = d64 @ x64 if want is None else np.asarray(want, np.float64)
    scale = np.abs(d64) @ np.abs(x64)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert np.shape(got) == want.shape
    assert np.all(err <= TOL * scale), float((err - TOL * scale).max())


# -- the JAX package at P = 4, once per file -----------------------------------
_REFERENCE = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.core import spd_shift
from repro.core.distributed import (SCHEDULES, build_mesh_operand, mesh_spmm_runner,
                                    place_mesh_operand, psum_dot_runner)
from repro.core.formats import csr_from_dense
from repro.launch.mesh import make_spmm_mesh
from repro.runtime.engine import SparseEngine
from repro.runtime.solver import SparseSolver
from repro.tune import PlanCache

path, spec = sys.argv[1], json.loads(sys.argv[2])
P = spec["P"]
mesh = make_spmm_mesh(P)
out, meta = {}, {}

def dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)

def rhs(n, k, seed):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return x[:, 0] if k == 1 else x

m, n, dens, seed = spec["sched"]
a = csr_from_dense(dense(m, n, dens, seed))
for sched in SCHEDULES:
    fn = mesh_spmm_runner(mesh, "shard",
                          place_mesh_operand(build_mesh_operand(a, P, sched), mesh, "shard"))
    for k in spec["k"]:
        out[f"y/{sched}/{k}"] = np.asarray(fn(jnp.asarray(rhs(n, k, seed + k))))

m, n, dens, seed = spec["engine"]
a = csr_from_dense(dense(m, n, dens, seed))
eng = SparseEngine(a, ks=(4,), mesh=mesh, cache=PlanCache(), warmup=0, timed=1)
xs = [jnp.asarray(rhs(n, 1, 100 + i)) for i in range(6)]
out["engine"] = np.stack([np.asarray(y) for y in eng.run(xs)])
meta["engine_plans"] = {str(k): [op.plan.fmt, op.plan.impl, op.plan.mesh_shape]
                        for k, op in eng.ops.items()}

ns, dens, seed = spec["solver"]
sa = spd_shift(csr_from_dense(dense(ns, ns, dens, seed)))
s = SparseSolver(sa, mesh=mesh, cache=PlanCache(), warmup=0, timed=1)
b = rhs(ns, 1, seed + 1)
r = s.cg(jnp.asarray(b), tol=1e-6, maxiter=400)
out["cg_x"] = np.asarray(r.x)
meta["cg"] = [int(r.iterations), bool(r.converged)]
r = s.lanczos(num_steps=12, seed=1)
out["lanczos_ritz"] = np.asarray(r.eigenvalues)
r = s.block_power(4, tol=1e-4, maxiter=150, seed=2)
out["power_theta"] = np.asarray(r.eigenvalues)
meta["power"] = [int(r.iterations), bool(r.converged)]
dot = psum_dot_runner(mesh, "shard", ns)
out["dot"] = np.asarray(dot(jnp.asarray(b), jnp.asarray(b[::-1].copy())))
np.savez(path, **out)
with open(path + ".json", "w") as f:
    json.dump(meta, f)
"""


@pytest.fixture(scope="module")
def ref4(tmp_path_factory):
    """``repro``'s outputs at P = 4 (four forced host devices)."""
    path = str(tmp_path_factory.mktemp("ref4") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    spec = {"P": 4, "sched": SCHED_CASE, "k": list(K_WIDTHS), "engine": ENGINE_CASE,
            "solver": SOLVER_CASE}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), path,
                          json.dumps(spec)], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path + ".json") as f:
        meta = json.load(f)
    return dict(np.load(path)), meta


def repro_schedule_p1(a, schedule, x):
    """``repro``'s mesh product at P = 1, in this process."""
    mesh = j_make_spmm_mesh(1)
    prep = jd.place_mesh_operand(jd.build_mesh_operand(a, 1, schedule), mesh, "shard")
    return np.asarray(jd.mesh_spmm_runner(mesh, "shard", prep)(jnp.asarray(x)))


# -- the schedules -------------------------------------------------------------
@pytest.mark.parametrize("k", K_WIDTHS)
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("schedule", td.SCHEDULES)
def test_schedule_matches_oracle_and_repro(schedule, P, k, ref4):
    m, n, dens, seed = SCHED_CASE
    d = dense(m, n, dens, seed)
    a = csr_from_dense(d)
    x = rhs(n, k, seed + k)
    mesh = make_spmm_mesh(P, device="cpu")
    prep = td.place_mesh_operand(td.build_mesh_operand(a, P, schedule), mesh, "shard")
    fn = td.mesh_spmm_runner(mesh, "shard", prep)
    y = fn(torch.as_tensor(x)).numpy()
    assert_rowtol(y, d, x)
    if P == 1:
        assert_rowtol(y, d, x, want=repro_schedule_p1(j_csr_from_dense(d), schedule, x))
    if P == 4:
        assert_rowtol(y, d, x, want=ref4[0][f"y/{schedule}/{k}"])
    again = fn(torch.as_tensor(x)).numpy()
    assert np.array_equal(y, again)  # the same bits on a second run


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_stacked_spmm_matches_repro_and_oracle(P):
    """One pass over every shard equals the oracle, and ``repro``'s vmap
    at P in {1, 4}."""
    m, n, dens, seed = SCHED_CASE
    d = dense(m, n, dens, seed)
    ta, ja = csr_from_dense(d), j_csr_from_dense(d)
    part = rows_balanced(ta, P)
    st = td.place_stacked(stack_csr_shards(part.shards), "cpu")
    jpart = j_rows_balanced(ja, P)
    jst = {key: jnp.asarray(v) for key, v in j_stack_csr_shards(jpart.shards).items()
           if key != "n_rows"}
    for k in K_WIDTHS:
        X = rhs(n, k, seed + k).reshape(n, k)
        ys = td.stacked_spmm(st, torch.as_tensor(X))
        assert tuple(ys.shape) == (P, int(np.diff(part.bounds).max()), k)
        y = td.assemble_rows(ys, np.diff(part.bounds)).numpy()
        assert_rowtol(y, d, X)
        if P in (1, 4):
            want = np.asarray(jd.assemble_rows(jd.stacked_spmm(jst, jnp.asarray(X)),
                                               np.diff(jpart.bounds)))
            assert_rowtol(y, d, X, want=want)


def test_stacked_spmm_with_empty_shards_and_rows():
    """More shards than rows, and empty rows: empty shards and padding rows
    come out zero and are dropped, as ``repro``'s are."""
    d = dense(3, 10, 0.5, 13)
    d[1] = 0.0
    ta, ja = csr_from_dense(d), j_csr_from_dense(d)
    X = rhs(10, 3, 14)
    part = rows_balanced(ta, 5)
    assert 0 in np.diff(part.bounds)
    ys = td.stacked_spmm(td.place_stacked(stack_csr_shards(part.shards), "cpu"),
                         torch.as_tensor(X))
    y = td.assemble_rows(ys, np.diff(part.bounds)).numpy()
    assert_rowtol(y, d, X)
    jpart = j_rows_balanced(ja, 5)
    jst = {key: jnp.asarray(v) for key, v in j_stack_csr_shards(jpart.shards).items()
           if key != "n_rows"}
    want = jd.assemble_rows(jd.stacked_spmm(jst, jnp.asarray(X)), np.diff(jpart.bounds))
    assert_rowtol(y, d, X, want=np.asarray(want))


@pytest.mark.parametrize("schedule", td.SCHEDULES)
def test_local_spmm_reads_only_stored_entries(schedule):
    """A shard (or ring cell) sums its stored entries only: poisoning its
    padding, which the ring has most of, changes nothing, and its padded
    rows come out zero."""
    d = dense(9, 12, 0.4, 11)
    d[:, 6:] = 0.0  # the ring's second column slab holds nothing: all padding
    a = csr_from_dense(d)
    P = 2
    op = td.build_mesh_operand(a, P, schedule)
    placed = td.place_mesh_operand(op, make_spmm_mesh(P, device="cpu"), "shard")["placed"]
    X = torch.as_tensor(rhs(12, 3, 12))
    n_rows = op["arrays"]["indptr"].shape[-1] - 1
    for p, rows in enumerate(op["shard_rows"]):
        lo = int(np.sum(op["shard_rows"][:p]))
        cells = [placed[p]] if schedule == "allgather" else placed[p]
        y = 0
        for j, cell in enumerate(cells):
            cell["data"][cell["nnz"]:] = float("nan")  # the padding
            xs = X if schedule == "allgather" else X[j * 6:(j + 1) * 6]
            part = td.local_spmm(cell, xs)
            assert tuple(part.shape) == (n_rows, 3)
            y = y + part
        assert_rowtol(y[:rows].numpy(), d[lo:lo + rows], X.numpy())
        assert not y[rows:].any()
    if schedule == "ring":
        assert int(op["arrays"]["indptr"][:, 1, -1].sum()) == 0
        assert op["arrays"]["indices"].shape[-1] > 0


@pytest.mark.parametrize("P", [1, 3, 4])
def test_psum_dot_matches_float64_and_repro(P, ref4):
    ns, dens, seed = SOLVER_CASE
    b = rhs(ns, 1, seed + 1)
    rev = b[::-1].copy()
    dot = td.psum_dot_runner(make_spmm_mesh(P, device="cpu"), "shard", ns)
    got = float(dot(torch.as_tensor(b), torch.as_tensor(rev)))
    want = float(b.astype(np.float64) @ rev.astype(np.float64))
    assert abs(got - want) <= TOL * float(np.abs(b).astype(np.float64) @ np.abs(rev))
    if P == 4:
        assert abs(got - float(ref4[0]["dot"])) <= TOL * float(np.abs(b) @ np.abs(rev))
    V = torch.as_tensor(rhs(ns, 3, 5))
    W = torch.as_tensor(rhs(ns, 3, 6))
    np.testing.assert_allclose(dot(V, W).numpy(), (V * W).sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_mesh_devices_and_refusals(monkeypatch):
    """A CPU mesh puts every shard on the CPU; a CUDA mesh places shard p on
    card p mod count and counts distinct cards; types never mix; a CUDA
    mesh without a card raises."""
    cpu = make_spmm_mesh(3, device="cpu")
    assert cpu.devices == (torch.device("cpu"),) * 3 and cpu.n_devices == 1
    assert cpu.shape == {"shard": 3} and cpu.axis_names == ("shard",)
    shared = Mesh([torch.device("cuda", 0)] * 4)
    spread = Mesh([torch.device("cuda", p) for p in range(4)])
    assert (shared.n_devices, spread.n_devices) == (1, 4)
    with pytest.raises(ValueError, match="never mixes"):
        Mesh(["cpu", torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="index"):
        Mesh(["cuda", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spmm_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseEngine(csr_from_dense(dense(8, 8, 0.5, 0)), mesh=shared)


# -- the tuner -----------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4, 16])
def test_mesh_candidates_and_costs_match_repro(k):
    for name in ("cant", "webbase-1M"):
        ja, ta = j_generate(name, scale=1 / 256), generate(name, scale=1 / 256)
        jfe, tfe = jt.extract(ja, k=k), tt.extract(ta, k=k)
        for P in (1, 2, 4, 8):
            jc = jt.enumerate_mesh_candidates(jfe, P)
            tc = tt.candidates.enumerate_mesh_candidates(tfe, P)
            assert [c.key() for c in tc] == [c.key() for c in jc]
            for c, j in zip(tc, jc):
                for on_cpu in (True, False):
                    for fused in (True, False):
                        assert tt.estimate_cost(ta, c, tfe, k=k, on_cpu=on_cpu,
                                                fused=fused) == jt.estimate_cost(
                            ja, j, jfe, k=k, on_cpu=on_cpu, fused=fused), (name, P)
    assert tt.candidates.RING_STEP_OVERHEAD_BYTES == jt.candidates.RING_STEP_OVERHEAD_BYTES
    assert tt.candidates.SCHEDULES == jt.candidates.SCHEDULES


def _plan(mesh_shape, backend, k=1, impl="allgather"):
    return tt.Plan(fingerprint="f" * 16, kind="spmv" if k == 1 else "spmm",
                   fmt="dist" if mesh_shape else "csr",
                   impl=impl if mesh_shape else "vector",
                   params={"n_shards": mesh_shape[0]} if mesh_shape else {},
                   est_cost=1.0, measured_s=1e-4, n_candidates=2, n_measured=2, k=k,
                   backend=backend, scale=[8, 8, 20], mesh_shape=list(mesh_shape))


def test_plan_mesh_key_and_matches(tmp_path):
    """Mesh plans are keyed per shape (the JAX package's key), never match
    a single device nor the reverse, and a plan measured with P shards on
    one card is a miss for P shards on P cards (ROADMAP C.15)."""
    for shape, k in (((), 1), ((4,), 1), ((4,), 16), ((2,), 4)):
        assert tt.PlanCache._key("fp", "spmv", k, shape) == jt.PlanCache._key(
            "fp", "spmv", k, shape)
    shared = Mesh([torch.device("cuda", 0)] * 4)
    spread = Mesh([torch.device("cuda", p) for p in range(4)])
    card = "cuda:NVIDIA H100 80GB HBM3"
    b_shared = tplan.mesh_backend(card, shared.n_devices)
    b_spread = tplan.mesh_backend(card, spread.n_devices)
    assert b_shared != b_spread and card not in (b_shared, b_spread)
    cache = tt.PlanCache(tmp_path / "plans.json")
    cache.put(_plan((4,), b_shared))
    cache.put(_plan((), card))
    scale = [8, 8, 20]
    assert cache.get("f" * 16, "spmv", 1, backend=b_shared, scale=scale,
                     mesh_shape=[4]).fmt == "dist"
    assert cache.get("f" * 16, "spmv", 1, backend=b_spread, scale=scale,
                     mesh_shape=[4]) is None
    assert cache.get("f" * 16, "spmv", 1, backend=b_shared, scale=scale,
                     mesh_shape=[2]) is None
    assert cache.get("f" * 16, "spmv", 1, backend=card, scale=scale).fmt == "csr"
    reloaded = tt.PlanCache(tmp_path / "plans.json")
    assert len(reloaded) == 2
    p = reloaded.get("f" * 16, "spmv", 1, backend=b_shared, scale=scale, mesh_shape=[4])
    assert p.mesh_shape == [4] and not p.matches(b_shared, scale)
    assert not _plan((), card).matches(card, scale, [4])


def test_cache_files_without_a_mesh_shape_load(tmp_path):
    """An entry written before plans carried ``mesh_shape`` loads as a
    single-device plan."""
    d = _plan((), "cpu").to_json()
    d.pop("mesh_shape")
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"f" * 16 + ":spmv:k1": d}))
    p = tt.PlanCache(path).get("f" * 16, "spmv", 1, backend="cpu", scale=[8, 8, 20])
    assert p is not None and p.mesh_shape == []


def test_predictor_filters_the_pool_by_mesh_shape():
    """Plans of another mesh shape never train a prediction, as in the JAX
    package: the same two caches give the same picks."""
    names = ("cant", "shallow_water1", "webbase-1M", "scircuit")
    jc, tc = jt.PlanCache(), tt.PlanCache()
    for i, name in enumerate(names):
        ja, ta = j_generate(name, scale=1 / 256), generate(name, scale=1 / 256)
        mesh = [4] if i % 2 else []
        fmt, impl, params = (("dist", "ring", {"n_shards": 4}) if mesh
                             else ("sell", "ref", {"C": 8, "sigma": 64}))
        common = dict(fingerprint=f"{i:016d}", kind="spmv", fmt=fmt, impl=impl,
                      params=params, est_cost=1.0, measured_s=1e-4, n_candidates=2,
                      n_measured=2, k=1, backend="cpu",
                      scale=[int(ta.shape[0]), int(ta.shape[1]), int(ta.nnz)],
                      mesh_shape=mesh)
        jc.put(jt.Plan(**common, features=jt.extract(ja, k=1).to_dict()))
        tc.put(tt.Plan(**common, features=tt.extract(ta, k=1).to_dict()))
    ja, ta = j_generate("hood", scale=1 / 256), generate("hood", scale=1 / 256)
    for shape in ((), (4,), (2,)):
        jpred = jt.predict.predict_candidate(ja, "spmv", 1, jc, backend="cpu",
                                             mesh_shape=shape, radius=10.0)
        tpred = predict_candidate(ta, "spmv", 1, tc, backend="cpu", mesh_shape=shape,
                                  radius=10.0, device="cpu")
        assert tpred.n_neighbors == jpred.n_neighbors == {(): 2, (4,): 2, (2,): 0}[shape]
        assert tpred.candidate.key() == jpred.candidate.key()
        assert tpred.source == jpred.source
        if shape == (4,):
            assert tpred.candidate.fmt == "dist"
        elif shape == ():
            assert tpred.candidate.fmt == "sell"


def test_sparse_rhs_over_a_mesh_is_refused():
    a = csr_from_dense(dense(16, 16, 0.3, 1))
    mesh = make_spmm_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="SpMSpV"):
        tt.SparseOperator.build(a, x_nnz=4, mesh=mesh, cache=tt.PlanCache())


# -- the engines -----------------------------------------------------------------
def engine_inputs():
    m, n, dens, seed = ENGINE_CASE
    d = dense(m, n, dens, seed)
    return d, csr_from_dense(d), [rhs(n, 1, 100 + i) for i in range(6)]


def mesh_engine(a, P, cache=None, **kw):
    return SparseEngine(a, ks=(1, 4), mesh=make_spmm_mesh(P, device="cpu"),
                        cache=cache if cache is not None else tt.PlanCache(),
                        warmup=0, timed=1, **kw)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_mesh_engine_matches_repro_and_oracle(P, ref4):
    d, a, xs = engine_inputs()
    eng = mesh_engine(a, P)
    assert eng.n_shards == P and eng.device == torch.device("cpu")
    for k, op in eng.ops.items():
        assert op.plan.fmt == "dist" and op.plan.impl in td.SCHEDULES, (k, op.plan)
        assert op.plan.mesh_shape == [P] and op.plan.backend == "cpu/1dev"
    ys = [y.numpy() for y in eng.run(xs)]
    assert eng.stats.n_requests == 6 and eng.pending == 0
    if P == 1:
        jeng = JEngine(j_csr_from_dense(d), ks=(1, 4), mesh=j_make_spmm_mesh(1),
                       cache=jt.PlanCache(), warmup=0, timed=1)
        assert all(op.plan.fmt == "dist" and op.plan.mesh_shape == [1]
                   for op in jeng.ops.values())
        want = [np.asarray(y) for y in jeng.run([jnp.asarray(x) for x in xs])]
    elif P == 4:
        assert all(p[0] == "dist" and p[2] == [4] for p in ref4[1]["engine_plans"].values())
        want = list(ref4[0]["engine"])
    else:
        want = [None] * len(xs)
    for y, x, w in zip(ys, xs, want):
        assert_rowtol(y, d, x)
        if w is not None:
            assert_rowtol(y, d, x, want=w)
    eng.close()
    assert eng.supervisor.events == []


def test_shard_engine_matches_repro_and_oracle():
    d, a, xs = engine_inputs()
    eng = SparseEngine(a, ks=(1, 4), n_shards=3, device="cpu")
    assert eng.ops == {} and eng.n_shards == 3
    jeng = JEngine(j_csr_from_dense(d), ks=(1, 4), n_shards=3)
    want = [np.asarray(y) for y in jeng.run([jnp.asarray(x) for x in xs])]
    reqs = [eng.submit(x) for x in xs[:1]]
    eng.step()  # bucket 1, then 4 of the 5 pending, then the last alone
    reqs += [eng.submit(x) for x in xs[1:]]
    eng.drain()
    assert [r.bucket for r in reqs] == [1, 4, 4, 4, 4, 1]
    for r, x, w in zip(reqs, xs, want):
        assert_rowtol(r.result().numpy(), d, x)
        assert_rowtol(r.result().numpy(), d, x, want=np.ravel(w))


def test_mesh_engine_async_equals_sync_bitwise():
    d, a, xs = engine_inputs()
    cache = tt.PlanCache()
    runs = []
    for depth in (2, 0):
        eng = mesh_engine(a, 4, cache=cache, async_depth=depth)
        runs.append([y.numpy() for y in eng.run(xs)])
    assert all(np.array_equal(p, q) for p, q in zip(*runs))


def test_mesh_engine_reloads_plan_table_per_topology(tmp_path):
    """A restart on the same mesh is a full cache hit; the single-device
    table of the same matrix is kept apart, as is another shard count."""
    d, a, _ = engine_inputs()
    path = tmp_path / "plans.json"
    eng = mesh_engine(a, 4, cache=tt.PlanCache(path))
    assert not eng.from_cache
    eng2 = mesh_engine(a, 4, cache=tt.PlanCache(path))
    assert eng2.from_cache
    assert all(eng2.ops[k].plan.candidate == eng.ops[k].plan.candidate for k in (1, 4))
    eng3 = SparseEngine(a, ks=(1,), cache=tt.PlanCache(path), warmup=0, timed=1,
                        device="cpu")
    assert not eng3.from_cache and eng3.ops[1].plan.fmt != "dist"
    eng4 = mesh_engine(a, 2, cache=tt.PlanCache(path))
    assert not eng4.from_cache and eng4.ops[1].plan.mesh_shape == [2]


def test_engine_topology_arguments_exclude_each_other():
    d, a, _ = engine_inputs()
    mesh = make_spmm_mesh(2, device="cpu")
    op = tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"), device="cpu")
    with pytest.raises(ValueError, match="ops="):
        SparseEngine(a, ks=(1,), ops={1: op}, mesh=mesh)
    with pytest.raises(ValueError, match="ops="):
        SparseEngine(a, ks=(1,), ops={1: op}, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        SparseEngine(a, ks=(1,), mesh=mesh, n_shards=2)


def test_mesh_and_shard_engines_refuse_submit_sparse():
    d, a, _ = engine_inputs()
    for eng in (mesh_engine(a, 2), SparseEngine(a, ks=(1,), n_shards=2, device="cpu")):
        with pytest.raises(NotImplementedError, match="SpMSpV"):
            eng.submit_sparse(np.array([0, 3]), np.ones(2, np.float32))


def test_demoted_mesh_bucket_serves_single_device_then_repromotes():
    """A faulted mesh bucket demotes to the single-device csr/vector
    fallback on the mesh's first device, serves within tolerance, and the
    repair thread re-promotes its collective schedule."""
    import time

    d, a, xs = engine_inputs()
    plan = FaultPlan({"engine.dispatch": {"n": 2, "bucket": 4}})
    eng = mesh_engine(a, 4, faults=plan, supervisor=Supervisor(max_retries=1, **SUP_KW))
    tuned = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    reqs = [eng.submit(x) for x in xs[:4]]
    eng.drain()
    for r, x in zip(reqs, xs):
        assert not r.failed
        assert_rowtol(r.result().numpy(), d, x)
    # The demotion is read from its recorded event: by now the repair thread
    # may already have re-promoted bucket 4, so eng.ops[4] can show either plan.
    demote = eng.supervisor.events_of("demote")
    assert len(demote) == 1
    assert demote[0].info["tier"] == "csr/vector" and demote[0].info["bucket"] == 4
    # the fallback's placement, fixed in the event when it was installed
    assert demote[0].info["n_devices"] == 1
    assert demote[0].info["device"] == str(eng.mesh.devices[0])
    deadline = time.perf_counter() + 5.0
    while eng.supervisor.promotions < 1:
        assert time.perf_counter() < deadline, "the repair never re-promoted"
        time.sleep(0.002)
    reqs = [eng.submit(x) for x in xs[:4]]
    eng.drain()
    for r, x in zip(reqs, xs):
        assert_rowtol(r.result().numpy(), d, x)
    assert {k: op.plan.candidate.key() for k, op in eng.ops.items()} == tuned
    assert eng.ops[4].plan.fmt == "dist" and not eng._demoted
    eng.close()


# -- the solvers -------------------------------------------------------------------
def solver_inputs():
    ns, dens, seed = SOLVER_CASE
    d = dense(ns, ns, dens, seed)
    return j_spd_shift(j_csr_from_dense(d)), spd_shift(csr_from_dense(d)), rhs(
        ns, 1, seed + 1)


@pytest.mark.parametrize("P", [1, 4])
def test_mesh_solvers_match_repro(P, ref4):
    """CG, Lanczos and block power over a mesh give ``repro``'s counts
    (CG within 2, as the single-device tests allow) and its values."""
    ja, ta, b = solver_inputs()
    s = SparseSolver(ta, mesh=make_spmm_mesh(P, device="cpu"), cache=tt.PlanCache(),
                     warmup=0, timed=1)
    cg = s.cg(b, tol=1e-6, maxiter=400)
    lz = s.lanczos(num_steps=12, seed=1)
    bp = s.block_power(4, tol=1e-4, maxiter=150, seed=2)
    assert {s.op(k).plan.fmt for k in (1, 4)} == {"dist"}
    assert s.op(1).plan.kind == "solver_step" and s.op(4).plan.mesh_shape == [P]
    if P == 1:
        js = JSolver(ja, mesh=j_make_spmm_mesh(1), cache=jt.PlanCache(), warmup=0,
                     timed=1)
        jcg = js.cg(jnp.asarray(b), tol=1e-6, maxiter=400)
        ref = {"cg_x": np.asarray(jcg.x),
               "lanczos_ritz": np.asarray(js.lanczos(num_steps=12, seed=1).eigenvalues)}
        jbp = js.block_power(4, tol=1e-4, maxiter=150, seed=2)
        ref["power_theta"] = np.asarray(jbp.eigenvalues)
        meta = {"cg": [jcg.iterations, jcg.converged],
                "power": [jbp.iterations, jbp.converged]}
    else:
        ref, meta = ref4
    assert cg.converged and meta["cg"][1]
    assert abs(cg.iterations - meta["cg"][0]) <= 2
    x_ref = np.asarray(ref["cg_x"], np.float64)
    assert np.abs(cg.x.numpy() - x_ref).max() <= 1e-5 * np.abs(x_ref).max()
    ritz = np.asarray(ref["lanczos_ritz"])
    assert np.abs(lz.eigenvalues - ritz).max() <= 1e-5 * np.abs(ritz).max()
    assert bp.converged == meta["power"][1]
    assert abs(bp.iterations - meta["power"][0]) <= 2
    theta = np.sort(np.asarray(ref["power_theta"]))
    np.testing.assert_allclose(np.sort(bp.eigenvalues)[-2:], theta[-2:], rtol=1e-5)


def test_mesh_solve_counts_equal_the_single_device_solve():
    _, ta, b = solver_inputs()
    one = SparseSolver(ta, cache=tt.PlanCache(), warmup=0, timed=1, device="cpu")
    mesh = SparseSolver(ta, mesh=make_spmm_mesh(3, device="cpu"), cache=tt.PlanCache(),
                        warmup=0, timed=1)
    r1, r3 = one.cg(b, tol=1e-5), mesh.cg(b, tol=1e-5)
    assert r1.iterations == r3.iterations and r1.converged and r3.converged
    assert np.abs(r1.x.numpy() - r3.x.numpy()).max() <= 1e-5 * np.abs(r1.x.numpy()).max()


def test_mesh_solve_never_demotes():
    """A fault on every dispatch: the mesh solver retries, then raises,
    where a single-device one would walk the fallback chain."""
    _, ta, b = solver_inputs()
    s = SparseSolver(ta, mesh=make_spmm_mesh(2, device="cpu"), cache=tt.PlanCache(),
                     warmup=0, timed=1, faults=FaultPlan({"solver.dispatch": {}}),
                     supervisor=Supervisor(max_retries=1, **SUP_KW))
    with pytest.raises(Exception, match="injected"):
        s.cg(b, tol=1e-5)
    assert s.supervisor.demotions == 0 and s.supervisor.retries == 1
    assert s.op(1).plan.fmt == "dist"


# -- the serve CLI -------------------------------------------------------------------
@pytest.mark.parametrize("flags, path", [(["--mesh-shards", "4"], "mesh-sharded over 4"),
                                          (["--shards", "3"], "row-partitioned")])
def test_serve_cli_shard_flags(flags, path, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    stats = tmp_path / "stats.json"
    tserve.main(["--sparse", "cant", "--scale", str(1 / 256), "--device", "cpu",
                 "--requests", "12", "--stats-json", str(stats)] + flags)
    out = capsys.readouterr().out
    assert "served 12/12" in out and path in out
    rec = json.loads(stats.read_text())
    assert rec["served"] == 12 and rec["n_devices"] == 1
    assert rec["shards"] == int(flags[1]) and rec["mesh"] == (flags[0] == "--mesh-shards")
    if rec["mesh"]:
        assert "1 distinct device(s)" in out
        assert all(v.startswith("dist/") for v in rec["plans"].values())


def test_serve_cli_shard_flags_are_one_of_two(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tserve.main(["--sparse", "cant", "--device", "cpu", "--shards", "2",
                     "--mesh-shards", "2"])

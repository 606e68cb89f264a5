"""Compiled execution in the port on the CPU: ``SparseOperator.aot``,
``runtime.executable``, ``BatchedServer(captured=True)``, the solvers'
blocks and ``kernels._build``'s capture tally.

On a card these paths run as CUDA graphs; on the CPU the same entry points
run eagerly, and here they are held against the JAX package's compiled
ones (``aot``, the jitted server) on the same numpy inputs.  The launch
accounting of a capture is held against a simulated one (a stub of
``torch.cuda.is_current_stream_capturing``).  The graphs themselves are
tested on a card: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.
"""
import collections
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.configs import get_reduced as j_get_reduced
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.models import lm as jlm
from repro.models.ffn import SparseFFNConfig as JSparseFFNConfig
from repro.runtime.server import BatchedServer as JServer
from repro.runtime.server import Request as JRequest

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.core.spmv import spd_shift
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_spmm_mesh
from repro_torch.runtime import executable
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.server import BatchedServer, Request
from repro_torch.runtime.solver import SparseSolver
from test_torch_hybrid import perturbed

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and the suite runs
    in several worker processes at once: keep this file to one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def launches():
    """``_build.LAUNCHES`` and this thread's capture tally, empty before
    and after the test."""
    _build.reset_launches()
    _build.take_tally()
    yield _build.LAUNCHES
    _build.reset_launches()
    _build.take_tally()


def _dense(seed=0, m=112, n=96, density=0.08):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    d[9] = 0.0  # an empty row
    return d


def assert_rowtol(got, want, d, x):
    """|got - want| <= 1e-5 (|A| |x|)_i per row (and column of x)."""
    scale = np.abs(d.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert np.all(err <= TOL * scale), float((err - TOL * scale).max())


# -- SparseOperator.aot -------------------------------------------------------
PLAIN_CANDIDATES = {
    "csr/vector": ("csr", "vector", {}),
    "sell/ref": ("sell", "ref", {"C": 8, "sigma": 64}),
    "bcsr/ref": ("bcsr", "ref", {"block": (8, 8)}),
}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("cand", list(PLAIN_CANDIDATES))
def test_aot_matches_the_reference_aot(cand, k):
    """``op.aot()`` of a pinned plain candidate against ``repro``'s
    ``from_candidate(...).aot()`` and a float64 oracle: within 1e-5
    (|A| |x|)_i, the same executable on a second call of ``aot``, and a
    result that a later call leaves alone."""
    fmt, impl, params = PLAIN_CANDIDATES[cand]
    d = _dense()
    kk = None if k == 1 else k
    jop = jt.SparseOperator.from_candidate(j_csr_from_dense(d),
                                           jt.make(fmt, impl, **params), k=kk)
    top = tt.SparseOperator.from_candidate(csr_from_dense(d),
                                           tt.make(fmt, impl, **params), k=kk,
                                           device="cpu")
    rng = np.random.default_rng(k)
    shape = (d.shape[1],) if k == 1 else (d.shape[1], k)
    x, x2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jop.aot()(jnp.asarray(x)))
    exe = top.aot()
    assert exe is top.aot() and exe is top.aot(donate_rhs=True)
    got = exe(torch.as_tensor(x))
    kept = got.clone()
    exe(torch.as_tensor(x2))
    assert torch.equal(got, kept)
    assert_rowtol(got.numpy(), want, d, x)
    assert_rowtol(got.numpy(), d.astype(np.float64) @ x, d, x)


def test_aot_of_sparse_and_mesh_plans_is_the_bound_runner():
    """A sparse-RHS plan and a mesh plan return their bound runner, as
    ``repro``'s ``aot`` does for both."""
    d = _dense(seed=3)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    jsp = jt.SparseOperator.from_candidate(ja, jt.make("spmspv", "ref"), x_nnz=4)
    assert jsp.aot() is jsp._run
    tsp = tt.SparseOperator.from_candidate(ta, tt.make("spmspv", "ref"), x_nnz=4,
                                           device="cpu")
    assert tsp.aot() is tsp._run and tsp.aot(donate_rhs=True) is tsp._run
    mesh = make_spmm_mesh(2, device="cpu")
    top = tt.SparseOperator.build(ta, k=4, cache=tt.PlanCache(), mesh=mesh,
                                  warmup=0, timed=1)
    assert top.plan.fmt == "dist"
    assert top.aot() is top._run and top.aot(donate_rhs=True) is top._run


def test_executables_run_eagerly_on_the_cpu():
    """``aot_compile`` hands back the function itself on the CPU, and a
    bucket closure is the eager one (no graph, no executable)."""
    fn = lambda x: 2 * x  # noqa: E731
    assert executable.aot_compile(fn, torch.zeros(3)) is fn
    run = lambda s: s.sum(dim=-1)  # noqa: E731
    one = executable.fused_batch_executable(run, bucket=1, n=5,
                                            device=torch.device("cpu"))
    assert one is run
    four = executable.fused_batch_executable(run, bucket=4, n=5,
                                             device=torch.device("cpu"), guard=True)
    xs = [torch.full((5,), float(i)) for i in range(4)]
    ys, ok = four(*xs)
    assert torch.equal(ys, torch.stack(xs, 1).sum(-1)) and bool(ok)
    assert not hasattr(four, "executable") and four.slab.shape == (5, 4)


def test_a_capture_refuses_to_start_without_the_pool_calls(monkeypatch):
    """Closing a failed capture needs two private calls of torch; where a
    torch lacks either, every capture raises a clear error before it
    begins, and nothing is launched or captured."""
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", lambda *a: None,
                        raising=False)
    monkeypatch.delattr(torch._C, "_cuda_releasePool", raising=False)
    ran = []
    with pytest.raises(RuntimeError, match="_cuda_releasePool.*torch 2.11"):
        executable.capture(lambda x: ran.append(x), torch.zeros(3))
    assert ran == []


def test_captured_replay_holds_its_pool_lock_until_the_outputs_are_copied():
    """A replay of a :class:`Captured` and the copies of its outputs run
    under its pool's lock (two threads replaying graphs of one pool onto
    one stream cannot interleave), and the copies are fresh tensors."""

    class Pool:
        lock = threading.Lock()

    class FakeGraph:
        def replay(self):
            assert Pool.lock.locked()

    exe = executable.Captured.__new__(executable.Captured)
    exe.pool, exe.graph = Pool(), FakeGraph()
    exe.outputs = (torch.arange(3.0), torch.tensor(True))
    ys, ok = exe.replay()
    assert not Pool.lock.locked()
    assert torch.equal(ys, exe.outputs[0]) and ys.data_ptr() != exe.outputs[0].data_ptr()
    assert bool(ok) and ok.data_ptr() != exe.outputs[1].data_ptr()


def test_engine_and_solver_take_captured_on_the_cpu():
    """``captured=`` is accepted everywhere and changes nothing on the CPU:
    an engine's closures stay eager and serve the same bits as with
    ``captured=False``; a solver captures no graph and gives the same x."""
    d = _dense(seed=5, m=96, n=96)
    a = csr_from_dense(d)
    ops = {k: tt.SparseOperator.from_candidate(
        a, tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8) if k == 1
        else tt.make("bcsr", "cuda", block=(8, 8)), k=None if k == 1 else k,
        device="cpu") for k in (1, 4)}
    rng = np.random.default_rng(6)
    xs = [torch.as_tensor(rng.standard_normal(96).astype(np.float32)) for _ in range(5)]
    out = []
    for captured in (True, False):
        eng = SparseEngine(a, ks=(1, 4), ops=ops, device="cpu", captured=captured)
        out.append(eng.run(xs))
        assert not any(hasattr(fn, "executable") for fn in eng._execs.values())
        eng.close()
    assert all(torch.equal(p, q) for p, q in zip(*out))
    spd = spd_shift(a)
    b = rng.standard_normal(96).astype(np.float32)
    res = []
    for captured in (True, False):
        s = SparseSolver(spd, cache=tt.PlanCache(), device="cpu", captured=captured,
                         candidates=[tt.make("csr", "vector")])
        res.append(s.cg(b, tol=1e-6))
        assert s.n_graphs == 0
    assert res[0].iterations == res[1].iterations and torch.equal(res[0].x, res[1].x)


def test_engine_asks_for_graphs_only_up_to_the_output_size_limit(monkeypatch):
    """A bucket whose output (rows x bucket float32) is larger than
    ``CAPTURE_MAX_OUTPUT_BYTES`` is bound eager; the others, and none with
    ``captured=False``, are asked for a graph (which the CPU runs eagerly)."""
    from repro_torch.runtime import engine as engine_mod

    asked = {}
    real = engine_mod.fused_batch_executable

    def spy(run, *, bucket, captured, **kw):
        asked[bucket] = captured
        return real(run, bucket=bucket, captured=captured, **kw)

    monkeypatch.setattr(engine_mod, "fused_batch_executable", spy)
    monkeypatch.setattr(engine_mod, "CAPTURE_MAX_OUTPUT_BYTES", 96 * 4 * 4)
    a = csr_from_dense(_dense(seed=5, m=96, n=96))
    ops = {k: tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"),
                                               k=None if k == 1 else k, device="cpu")
           for k in (1, 4, 16)}
    for captured, want in ((True, {1: True, 4: True, 16: False}),
                           (False, {1: False, 4: False, 16: False})):
        eng = SparseEngine(a, ks=(1, 4, 16), ops=ops, device="cpu", captured=captured)
        asked.clear()
        for k in (1, 4, 16):
            eng._exec(k)
        assert asked == want
        eng.close()


# -- BatchedServer(captured=True) ---------------------------------------------
def _prompts(n, vocab, seed=0, lens=(5, 9, 3, 12, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _serve(server_cls, request_cls, cfg, params, prompts, slots, **kw):
    srv = server_cls(cfg, params, batch_slots=slots, max_seq=32, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    return srv, reqs


@pytest.mark.parametrize("bcsr", [False, True], ids=["dense", "bcsr-ref"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "h2o-danube-3-4b", "zamba2-2.7b"])
def test_captured_server_tokens_equal_the_reference_server(arch, bcsr):
    """``BatchedServer(..., captured=True)`` on the CPU (its explicit eager
    path: no graph, no warm-up) gives ``repro``'s jitted server's greedy
    tokens, float32, five requests through 2 slots.  zamba2 runs on
    perturbed weights (``tests/test_torch_hybrid.py::perturbed``)."""
    sff = JSparseFFNConfig(kind="bcsr", block=(32, 32), impl="ref") if bcsr else None
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=jnp.float32, sparse_ffn=sff)
    params, _ = jlm.init_model(jcfg, 0)
    params = (perturbed(params) if jcfg.family == "hybrid"
              else jax.tree.map(np.asarray, params))
    model = lm_params_from_numpy(jcfg, params, device="cpu")
    prompts = _prompts(5, jcfg.vocab)
    jsrv, jreqs = _serve(JServer, JRequest, jcfg, params, prompts, 2)
    tsrv, treqs = _serve(BatchedServer, Request, model.cfg, model, prompts, 2,
                         captured=True)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert (tsrv.prefills, tsrv.steps) == (jsrv.prefills, jsrv.steps)
    assert not tsrv.captured and (tsrv.graphs, tsrv.warmups, tsrv.capture_s) == (0, 0, 0.0)


# -- the capture tally ----------------------------------------------------------
@pytest.fixture
def simulated_capture(monkeypatch):
    """``flag.on = True`` makes the calling thread's stream "capture"."""
    flag = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(flag, "on", False))
    return flag


def test_captured_launches_count_at_each_replay_not_at_capture(launches,
                                                               simulated_capture):
    simulated_capture.on = True
    for name in ("sell_spmv", "bcsr_spmm", "bcsr_spmm"):
        _build.count(name)
    simulated_capture.on = False
    assert dict(launches) == {}  # nothing ran
    tally = _build.take_tally()
    assert tally == {"sell_spmv": 1, "bcsr_spmm": 2}
    assert _build.take_tally() == {}

    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = executable.Graph(FakeGraph(), None, tally)
    for _ in range(3):
        graph.replay()
    assert graph.graph.replays == 3
    assert dict(launches) == {"sell_spmv": 3, "bcsr_spmm": 6}
    _build.count("sell_spmv")  # an eager launch
    assert dict(launches) == {"sell_spmv": 4, "bcsr_spmm": 6}


def test_capture_tallies_are_per_thread(launches, simulated_capture):
    """Two threads: one captures while the other launches eagerly, then the
    other captures too; neither counts the other's launches."""
    simulated_capture.on = True
    _build.count("bcsr_spmm_bf16")
    seen = {}

    def other():
        for _ in range(3):
            _build.count("sell_spmv")  # eager: this thread is not capturing
        seen["eager"] = dict(launches)
        simulated_capture.on = True
        _build.count("spmspv_scatter")
        seen["tally"] = _build.take_tally()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen["eager"] == {"sell_spmv": 3}
    assert seen["tally"] == collections.Counter({"spmspv_scatter": 1})
    assert _build.take_tally() == collections.Counter({"bcsr_spmm_bf16": 1})
    assert dict(launches) == {"sell_spmv": 3}

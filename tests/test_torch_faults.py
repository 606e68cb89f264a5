"""Fault injection and supervision in the port, on ``device="cpu"``: the
fault plan (held against ``repro``'s on the same call sequences), the torn
plan cache, failure-propagating futures, retry -> demote -> repair ->
promote (dense and sparse buckets), plan swaps against the synchronous
path, and a search that passes over a candidate whose prepare raised.

Every fault is injected through ``repro_torch.runtime.faults``; the
assertions are about policy: futures always resolve, degraded serving stays
correct, and repair re-promotes.  Every wait is bounded."""
import glob
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro.runtime import faults as jfaults

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.faults import FaultPlan, InjectedFault, set_active
from repro_torch.runtime.supervisor import (
    FALLBACK_TIERS,
    NonFiniteOutput,
    Supervisor,
    injected,
)
from repro_torch.tune.operator import search_skips

torch.set_num_threads(1)

# Zero backoff + fast repair: the tests exercise policy, not pacing.
SUP_KW = dict(backoff_base_s=0.0, backoff_cap_s=0.0, repair_interval_s=0.005)
WAIT_S = 5.0


def small(seed=0, m=128, density=0.06):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, m)) < density) * rng.standard_normal((m, m))).astype(
        np.float32
    )
    return d, csr_from_dense(d)


def engine(a, ks=(1, 4, 16), cache=None, **kw):
    cache = cache if cache is not None else tt.PlanCache()
    return SparseEngine(a, ks=ks, cache=cache, warmup=0, timed=1, device="cpu", **kw)


def xs_for(a, count, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(a.shape[1]).astype(np.float32) for _ in range(count)]


def wait_for(cond, what):
    deadline = time.perf_counter() + WAIT_S
    while not cond():
        assert time.perf_counter() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


# -- FaultPlan ---------------------------------------------------------------
def test_fault_plan_spec_parse_match_and_log():
    plan = FaultPlan("engine.dispatch:n=2:engine=bad;plan_cache.read:p=0.5;seed=9")
    assert plan.seed == 9
    # Context mismatch never fires and never consumes the armed count.
    assert not plan.should_fire("engine.dispatch", engine="good")
    assert plan.should_fire("engine.dispatch", engine="bad")
    with pytest.raises(InjectedFault, match="engine.dispatch"):
        plan.fire("engine.dispatch", engine="bad")
    assert not plan.should_fire("engine.dispatch", engine="bad")  # n spent
    assert plan.fired("engine.dispatch") == 2 and plan.fired() == 2
    assert [e.seq for e in plan.log] == [0, 1]
    assert not plan.should_fire("engine.nan")
    one_shot = FaultPlan({"prepare.oom": {"n": 1}})
    with pytest.raises(MemoryError):
        one_shot.fire("prepare.oom", exc=MemoryError)
    torn = FaultPlan({"plan_cache.read": {"n": 1}}, seed=3)
    text = "x" * 100
    out = torn.corrupt_text("plan_cache.read", text)
    assert 1 <= len(out) < len(text) and text.startswith(out)
    with pytest.raises(ValueError, match="plan option"):
        FaultPlan("bogus=1")
    with pytest.raises(ValueError, match="malformed"):
        FaultPlan("engine.dispatch:n")


@pytest.mark.parametrize("spec,seed", [
    ("engine.dispatch:p=0.3;engine.nan:p=0.5:bucket=4;seed=11", 0),
    ({"engine.dispatch": {"p": 0.7, "n": 9}, "plan_cache.read": {"p": 0.5}}, 5),
    ("engine.overload:delay_s=0.25:p=0.4;prepare.oom:n=2", 3),
])
def test_fault_plan_fires_at_the_same_calls_as_repro(spec, seed):
    jplan, tplan = jfaults.FaultPlan(spec, seed=seed), tfaults.FaultPlan(spec, seed=seed)
    assert tplan.seed == jplan.seed
    rng = np.random.default_rng(seed)
    text = "".join(chr(97 + i % 26) for i in range(500))
    sites = ["engine.dispatch", "engine.nan", "engine.overload", "plan_cache.read",
             "prepare.oom", "unarmed"]
    for _ in range(300):
        site = sites[int(rng.integers(len(sites)))]
        ctx = {"bucket": int(rng.choice([1, 4, 16]))}
        if site == "engine.overload":
            assert tplan.delay(site, **ctx) == jplan.delay(site, **ctx)
        elif site == "plan_cache.read":
            assert tplan.corrupt_text(site, text, **ctx) == jplan.corrupt_text(
                site, text, **ctx)
        else:
            assert tplan.should_fire(site, **ctx) == jplan.should_fire(site, **ctx)
    assert [(e.site, e.seq, e.ctx) for e in tplan.log] == [
        (e.site, e.seq, e.ctx) for e in jplan.log]
    assert tplan.fired() > 0


def test_fault_env_variable_is_the_ports_own(monkeypatch):
    monkeypatch.setattr(tfaults, "_active", None)
    monkeypatch.setattr(tfaults, "_env_checked", False)
    monkeypatch.setenv("REPRO_FAULTS", "engine.dispatch:n=1")
    monkeypatch.delenv("REPRO_TORCH_FAULTS", raising=False)
    assert tfaults.active_plan() is None  # the JAX package's plan does not arm it
    monkeypatch.setattr(tfaults, "_env_checked", False)
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "engine.dispatch:n=2;seed=4")
    plan = tfaults.active_plan()
    assert plan is not None and plan.seed == 4
    assert set_active(None) is plan and tfaults.active_plan() is None


# -- PlanCache quarantine ----------------------------------------------------
def test_torn_plan_cache_quarantined_at_many_offsets(tmp_path):
    d, a = small(seed=1, m=64)
    src = tmp_path / "seed" / "plans.json"
    tt.SparseOperator.build(a, cache=tt.PlanCache(src), warmup=0, timed=1, device="cpu")
    text = src.read_text()
    for i, frac in enumerate((0.01, 0.3, 0.6, 0.99)):
        path = tmp_path / f"tear{i}" / "plans.json"
        path.parent.mkdir()
        torn = text[: max(1, int(frac * len(text)))]
        path.write_text(torn)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cache = tt.PlanCache(path)
        assert len(cache) == 0  # empty table, never a crash
        assert not path.exists()  # moved aside, not overwritten in place
        corrupt = glob.glob(f"{path}.corrupt-*")
        assert len(corrupt) == 1
        assert any("quarantined" in str(w.message) for w in caught)
        assert open(corrupt[0]).read() == torn
        tt.SparseOperator.build(a, cache=cache, warmup=0, timed=1, device="cpu")
        assert len(tt.PlanCache(path)) >= 1
        json.loads(path.read_text())


def test_torn_read_site_quarantines_on_load_and_on_put(tmp_path):
    d, a = small(seed=2, m=64)
    good = tmp_path / "good" / "plans.json"
    tt.SparseOperator.build(a, cache=tt.PlanCache(good), warmup=0, timed=1, device="cpu")
    # Load: the armed site tears the read of a valid file.
    plan = FaultPlan({"plan_cache.read": {"n": 1}}, seed=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cache = tt.PlanCache(good, faults=plan)
    assert plan.fired("plan_cache.read") == 1 and len(cache) == 0
    assert glob.glob(f"{good}.corrupt-*") and not good.exists()
    assert any("quarantined" in str(w.message) for w in caught)
    # Put: init saw no file (no fire consumed); the merge read is torn.
    path = tmp_path / "plans.json"
    cache = tt.PlanCache(path, faults=FaultPlan({"plan_cache.read": {"n": 1}}))
    assert cache._faults.fired("plan_cache.read") == 0
    path.write_text(json.dumps({"not": "valid plan schema"}) + "{{{")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tt.SparseOperator.build(a, cache=cache, warmup=0, timed=1, device="cpu")
    assert any("quarantined" in str(w.message) for w in caught)
    assert glob.glob(f"{path}.corrupt-*")
    assert len(tt.PlanCache(path)) >= 1


# -- engine supervision ------------------------------------------------------
def test_injected_dispatch_failure_fails_futures_fifo_for_survivors():
    d, a = small(seed=3)
    plan = FaultPlan({"engine.dispatch": {"n": 3}})
    eng = engine(a, ks=(4,), faults=plan,
                 supervisor=Supervisor(max_retries=0, **SUP_KW))
    xs = xs_for(a, 8)
    reqs = [eng.submit(x) for x in xs]
    eng.drain()
    # Batch 1 ate the whole chain (tuned, csr/vector, sell/ref: 3 fires).
    for r in reqs[:4]:
        assert r.done and r.failed
        with pytest.raises(InjectedFault):
            r.result()
    for r, x in zip(reqs[4:], xs[4:]):
        assert r.done and not r.failed
        np.testing.assert_allclose(r.result().numpy(), d @ x, atol=2e-3)
    assert eng.stats.failed_requests == 4 and eng.stats.failed_batches == 1
    assert eng.stats.demotions == 2 == len(FALLBACK_TIERS)
    assert plan.fired("engine.dispatch") == 3
    kinds = [e.kind for e in eng.supervisor.events]
    assert kinds[:4] == ["batch_failed", "demote", "demote", "batch_abandoned"]
    eng.close()


def test_retry_budget_recovers_without_demotion():
    d, a = small(seed=4)
    plan = FaultPlan({"engine.dispatch": {"n": 2}})
    eng = engine(a, ks=(4,), faults=plan,
                 supervisor=Supervisor(max_retries=2, **SUP_KW))
    xs = xs_for(a, 4)
    reqs = [eng.submit(x) for x in xs]
    eng.drain()
    for r, x in zip(reqs, xs):
        np.testing.assert_allclose(r.result().numpy(), d @ x, atol=2e-3)
    assert eng.stats.retries == 2 and eng.stats.demotions == 0
    assert eng.stats.failed_requests == 0
    eng.close()


def test_nan_guard_demotes_recovers_and_repromotes():
    d, a = small(seed=5)
    plan = FaultPlan({"engine.nan": {"n": 2}})
    eng = engine(a, ks=(1, 4), faults=plan, nan_guard=True,
                 supervisor=Supervisor(max_retries=0, **SUP_KW))
    tuned = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    xs = xs_for(a, 4)
    reqs = [eng.submit(x) for x in xs]
    eng.drain()
    for r, x in zip(reqs, xs):  # poisoned twice, recovered on sell/ref
        assert not r.failed
        np.testing.assert_allclose(r.result().numpy(), d @ x, atol=2e-3)
    assert eng.stats.demotions == 2
    assert isinstance(eng.supervisor.events_of("batch_failed")[0].info["error"], str)
    assert "NonFiniteOutput" in eng.supervisor.events_of("batch_failed")[0].info["error"]
    assert "engine.nan fault site" in eng.supervisor.events_of("batch_failed")[0].info["error"]
    wait_for(lambda: eng.supervisor.promotions >= 1, "the repair to re-promote")
    reqs2 = [eng.submit(x) for x in xs]  # the swap is adopted at dispatch
    eng.drain()
    for r, x in zip(reqs2, xs):
        np.testing.assert_allclose(r.result().numpy(), d @ x, atol=2e-3)
    assert eng.stats.promotions >= 1 and not eng._demoted and not eng._promoting
    assert {k: op.plan.candidate.key() for k, op in eng.ops.items()} == tuned
    kinds = [e.kind for e in eng.supervisor.events]
    assert kinds.index("batch_failed") < kinds.index("demote") < kinds.index("promote")
    eng.close()
    assert eng._repair_thread is None or not eng._repair_thread.is_alive()


def test_sparse_bucket_demotes_to_the_densified_fallback():
    d, a = small(seed=8)
    plan = FaultPlan({"engine.dispatch": {"n": 1, "engine": "sp"}})
    eng = engine(a, ks=(1,), faults=plan, name="sp", x_nnz_buckets=(8,),
                 supervisor=Supervisor(max_retries=0, **SUP_KW))
    idx = np.array([3, 17, 40, 99], np.int64)
    val = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    r = eng.submit_sparse(idx, val)
    x = np.zeros(a.shape[1], np.float32)
    x[idx] = val
    np.testing.assert_allclose(r.result(timeout=WAIT_S).numpy(), d @ x, atol=2e-3)
    (dem,) = eng.supervisor.events_of("demote")
    assert dem.info["bucket"] == ("spmspv", 8) and dem.info["tier"] == "csr/vector"
    assert eng._sparse_ops[8].plan.kind == "spmspv"
    eng.close()


def test_sparse_bucket_repromotes_after_a_clean_probe():
    d, a = small(seed=8)
    plan = FaultPlan({"engine.dispatch": {"n": 1, "engine": "sp"}})
    eng = engine(a, ks=(1,), faults=plan, name="sp", x_nnz_buckets=(8,),
                 supervisor=Supervisor(max_retries=0, **SUP_KW))
    idx = np.array([3, 17, 40, 99], np.int64)
    val = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    x = np.zeros(a.shape[1], np.float32)
    x[idx] = val
    np.testing.assert_allclose(eng.submit_sparse(idx, val).result(timeout=WAIT_S).numpy(),
                               d @ x, atol=2e-3)
    tuned = eng._demote_saved[("spmspv", 8)][0]
    assert tuned is not None and eng._sparse_ops[8] is not tuned
    wait_for(lambda: eng.stats.promotions >= 1, "the sparse bucket's promotion")
    r = eng.submit_sparse(idx, val)  # adopts the staged bucket first
    np.testing.assert_allclose(r.result(timeout=WAIT_S).numpy(), d @ x, atol=2e-3)
    assert eng._sparse_ops[8] is tuned
    assert not eng._demoted and not eng._demote_saved
    (pro,) = eng.supervisor.events_of("promote")
    assert pro.info["bucket"] == ("spmspv", 8)
    eng.close()


def test_a_sick_sparse_closure_stays_demoted_and_heals_only_through_a_product():
    """The repair probe of a sparse bucket runs a product: a tuned closure
    that fails whenever it computes one (as a kernel that faults on launch
    would; an empty x computes nothing) stays demoted through many repair
    passes, and once healed it is promoted after a probe whose x carried a
    real entry."""
    d, a = small(seed=8)
    eng = engine(a, ks=(1,), name="sp", x_nnz_buckets=(8,),
                 supervisor=Supervisor(max_retries=0, **SUP_KW))
    idx = np.array([3, 17, 40, 99], np.int64)
    val = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    x = np.zeros(a.shape[1], np.float32)
    x[idx] = val
    eng.submit_sparse(idx, val).result(timeout=WAIT_S)  # binds the tuned closure
    tuned = eng._sparse_execs[8]
    healed = threading.Event()
    probes = []  # (real entries of x, healed) per call after the demotion

    def sick(sx):
        real = int((np.asarray(sx[0]) < a.shape[1]).sum())
        probes.append((real, healed.is_set()))
        if real and not healed.is_set():
            raise RuntimeError("the tuned sparse kernel faults when it computes")
        return tuned(sx)

    eng._sparse_execs[8] = sick
    r = eng.submit_sparse(idx, val)  # fails on sick, served by the fallback
    np.testing.assert_allclose(r.result(timeout=WAIT_S).numpy(), d @ x, atol=2e-3)
    assert eng._demoted == {("spmspv", 8): 1}
    wait_for(lambda: len(probes) >= 6, "five repair probes of the sick closure")
    assert eng.stats.promotions == 0 and ("spmspv", 8) in eng._demoted
    assert all(real == 1 for real, _ in probes[1:])  # one real entry per probe
    healed.set()
    wait_for(lambda: eng.stats.promotions >= 1, "the healed bucket's promotion")
    assert probes[-1] == (1, True)
    r = eng.submit_sparse(idx, val)  # adopts the staged bucket
    np.testing.assert_allclose(r.result(timeout=WAIT_S).numpy(), d @ x, atol=2e-3)
    assert not eng._demoted and eng._sparse_execs[8] is sick
    eng.close()


def test_a_fallback_batch_failing_before_adoption_keeps_the_saved_plan():
    """A promotion is staged while a batch on the fallback tier is still in
    flight; that batch then fails.  Its bucket demotes one tier further,
    the saved tuned plan stays the one the adoption installs, and the
    adoption clears the demotion."""
    d, a = small(seed=13)
    sup = Supervisor(max_retries=0, backoff_base_s=0.0, backoff_cap_s=0.0,
                     repair_interval_s=60.0)  # the test stages the promotion
    eng = engine(a, ks=(4,), nan_guard=True, supervisor=sup,
                 faults=FaultPlan({"engine.dispatch": {"n": 1}}))
    tuned = eng.ops[4]
    xs = xs_for(a, 8)
    eng.run(xs[:4])  # launch fails; demoted to csr/vector, served there
    assert eng._demoted == {4: 1} and eng._demote_saved[4][0] is tuned
    eng.faults = FaultPlan({"engine.nan": {"n": 1}})
    reqs = [eng.submit(x) for x in xs[4:]]
    eng.step()  # a poisoned csr/vector batch, still in flight
    assert eng.in_flight == 1
    op, fn = eng._demote_saved[4]
    eng._promote(4, op, fn if fn is not None else eng._make_exec(4, op))
    assert eng._promoting == {4}
    eng.flush()  # the fallback batch fails, demotes to sell/ref, is served
    assert [e.info["level"] for e in sup.events_of("demote")] == [1, 2]
    assert eng._demote_saved[4][0] is tuned
    for r, x in zip(reqs, xs[4:]):
        np.testing.assert_allclose(r.result().numpy(), d @ x, atol=2e-3)
    eng.run(xs[:4])  # adopts the staged tuned plan
    assert eng.ops[4] is tuned
    assert not eng._demoted and not eng._demote_saved and not eng._promoting
    eng.close()


def test_only_plan_faults_count_as_injected():
    """On a card the engine retries and demotes only what ``injected``
    accepts; every other failure fails its batch's futures."""
    assert injected(InjectedFault("x"))
    assert injected(NonFiniteOutput("poisoned", injected=True))
    assert not injected(NonFiniteOutput("real"))
    for exc in (ValueError("misaligned"), RuntimeError("CUDA error"), MemoryError()):
        assert not injected(exc)
    assert not injected(torch.cuda.OutOfMemoryError("oom"))


def test_a_fault_on_every_launch_fails_the_batch_and_stops():
    d, a = small(seed=9)
    plan = FaultPlan({"engine.dispatch": {}})  # every launch, every tier
    sup = Supervisor(max_retries=1, **SUP_KW)
    eng = engine(a, ks=(4,), faults=plan, supervisor=sup)
    reqs = [eng.submit(x) for x in xs_for(a, 3)]
    eng.drain()
    assert all(r.failed for r in reqs)
    # tuned: 1 + 1 retry; each fallback tier: 1 + 1 retry, then abandoned.
    assert eng.stats.retries == 1 + 2 * len(FALLBACK_TIERS)
    assert [e.kind for e in sup.events_of("batch_abandoned")] == ["batch_abandoned"]
    eng.close()  # joins the repair thread, whose probes keep failing
    assert eng._repair_thread is None or not eng._repair_thread.is_alive()


def test_hot_swap_applies_at_the_next_dispatch_and_legacy_path_agrees():
    """The swapped table serves exactly as a synchronous engine
    (``async_depth=0``, the baseline path) built on it."""
    d, a = small(seed=10)
    eng = engine(a, ks=(1, 4))
    xs = xs_for(a, 5)
    before = eng.run(xs)
    table = {k: tt.SparseOperator.from_candidate(
        a, tt.make("sell", "ref", C=8, sigma=1), k=None if k == 1 else k, device="cpu")
        for k in (1, 4)}
    eng.hot_swap(table)
    assert eng.ops[4] is not table[4]  # staged, not adopted
    after = eng.run(xs)
    assert eng.ops[4] is table[4] and eng.ops[1] is table[1]
    legacy = SparseEngine(a, ks=(1, 4), ops=table, device="cpu", async_depth=0)
    via_legacy = legacy.run(xs)
    assert legacy.stats.summary()["by_bucket"] == {1: 1, 4: 1}
    for y0, y1, y2, x in zip(before, after, via_legacy, xs):
        np.testing.assert_allclose(y0.numpy(), d @ x, atol=2e-3)
        np.testing.assert_array_equal(y1.numpy(), y2.numpy())
    with pytest.raises(ValueError, match="missing buckets"):
        eng.hot_swap({1: table[1]})
    eng.close()
    legacy.close()


class _NeverDone:
    def query(self):
        return False

    def synchronize(self):  # pragma: no cover - never reached
        raise AssertionError


def test_result_timeout_raises_with_context():
    d, a = small(seed=6)
    eng = engine(a, ks=(4,), name="stuck")
    req = eng.submit(xs_for(a, 1)[0])
    # Wedge the engine: the head in-flight batch never completes.
    eng._queue.clear()
    eng._inflight.append((None, None, _NeverDone(), [req], 4, 1))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="stuck"):
        req.result(timeout=0.05)
    assert time.perf_counter() - t0 < WAIT_S
    eng._inflight.clear()
    assert not req.done  # the timeout resolves the call, not the future


def test_submit_on_closed_engine_raises():
    d, a = small(seed=7)
    eng = engine(a, ks=(1, 4))
    r = eng.submit(xs_for(a, 1)[0])
    eng.close()  # drains first
    assert r.done and not r.failed
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(xs_for(a, 1)[0])
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_sparse(np.array([0, 3], np.int64), np.array([1.0, 2.0], np.float32))


# -- measured search under prepare failure -----------------------------------
def test_build_skips_candidate_whose_prepare_raises():
    d, a = small(seed=15, m=96)
    prev = set_active(FaultPlan({"prepare.oom": {"n": 1}}))
    try:
        op = tt.SparseOperator.build(a, cache=tt.PlanCache(), warmup=0, timed=1,
                                     force_search=True, device="cpu")
    finally:
        set_active(prev)
    assert sum(1 for v in op.measurements.values() if v == float("inf")) >= 1
    (key, exc), = op.search_failures.items()
    assert isinstance(exc, MemoryError)
    x = xs_for(a, 1, seed=16)[0]
    np.testing.assert_allclose((op @ torch.as_tensor(x)).numpy(), d @ x, atol=2e-3)


@pytest.mark.parametrize("exc,stage,skips", [
    (MemoryError("injected"), "prepare", True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "prepare", True),
    (RuntimeError("CUDA error 700"), "prepare", False),
    (MemoryError("host"), "run", False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), "run", False),
    (tt.NoSpMMTier("k > 1"), "run", True),
])
def test_a_card_search_passes_over_only_oom_at_prepare_and_missing_spmm(exc, stage, skips):
    assert search_skips(exc, torch.device("cuda"), stage=stage) is skips
    assert search_skips(exc, torch.device("cpu"), stage=stage) is True


def test_nonfinite_output_is_a_runtime_error():
    assert issubclass(NonFiniteOutput, RuntimeError)
    assert issubclass(InjectedFault, RuntimeError)

"""SparseFleet in the port, on ``device="cpu"``: twins of the JAX package's
fleet tests (transfer-tuned admission, hot-swap atomicity, residency and
eviction, scheduling, the circuit breaker, the retune queue, fair share,
the shared brownout), and the port held against ``repro``'s fleet on the
same training cache: the same ``admitted_from`` per bucket, served y within
1e-5 * (|A| |x|)_i of ``repro``'s and of float64, the same summary keys.

No test here reads wall time for a decision it asserts: the breaker's
cooldown and the fair-share test run on a patched clock and count dispatch
steps.  Every wait on the retune thread is bounded."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import repro.tune as jt
from repro.data.suite import generate as jgen
from repro.runtime.fleet import SparseFleet as JFleet
from repro.tune import plan as jplan

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.data.suite import generate
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import fleet as tfleet
from repro_torch.runtime import overload as toverload
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.faults import FaultPlan, InjectedFault
from repro_torch.runtime.fleet import CircuitOpenError, SparseFleet, _table_bytes
from repro_torch.runtime.overload import (
    BROWNOUT,
    HEALTHY,
    BrownoutController,
    OverloadError,
)

torch.set_num_threads(1)

TOL = 1e-5
WAIT_S = 120.0
SUP_KW = dict(backoff_base_s=0.0, backoff_cap_s=0.0, repair_interval_s=0.005)


def small(seed=0, m=128, density=0.06):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, m)) < density) * rng.standard_normal((m, m))).astype(
        np.float32
    )
    return d, csr_from_dense(d)


def fleet(cache=None, **kw):
    kw.setdefault("ks", (1, 4))
    kw.setdefault("retune", False)  # tests opt in to the background thread
    kw.setdefault("retune_kwargs", dict(warmup=0, timed=1))
    return SparseFleet(cache=cache if cache is not None else tt.PlanCache(),
                       device="cpu", **kw)


def xs_for(a, count, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32))
            for _ in range(count)]


def assert_rowtol(y, a, x):
    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape)
    x64 = np.asarray(x, np.float64)
    err = np.abs(np.asarray(y, np.float64) - a64 @ x64)
    lim = TOL * (abs(a64) @ np.abs(x64))
    assert np.all(err <= lim), float((err - lim).max())


def serve_all(fl, reqs):
    while not all(r.done for r in reqs):
        if fl.step() == 0:
            fl.flush()


class Clock:
    """A patched ``time`` for the fleet's decisions: ``perf_counter`` is
    advanced by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def advance(self, dt):
        self.t += dt

    def sleep(self, _dt):
        pass


# -- engine hot swap ------------------------------------------------------------
def test_hot_swap_in_flight_futures_resolve_on_old_plan_bitwise():
    d, a = small(seed=4)
    ks = (1, 4)
    old = {k: tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"),
                                               k=None if k == 1 else k, device="cpu")
           for k in ks}
    new = {k: tt.SparseOperator.from_candidate(a, tt.make("sell", "ref", C=8, sigma=64),
                                               k=None if k == 1 else k, device="cpu")
           for k in ks}
    xs = xs_for(a, 16)
    eng = SparseEngine(a, ks=ks, ops=old, async_depth=2, device="cpu")
    reference = SparseEngine(a, ks=ks, ops=dict(old), async_depth=2, device="cpu")
    ref_ys = [y.clone() for y in reference.run(xs[:8])]

    reqs = [eng.submit(x) for x in xs[:8]]
    assert eng.step() == 4 and eng.step() == 4
    assert eng.in_flight == 2
    execs = {k: eng._make_exec(k, new[k]) for k in ks}
    for k in ks:
        execs[k](*([torch.zeros(a.shape[1])] * k))
    assert execs[4].slab.shape == (a.shape[1], 4)  # the closure's own slab
    eng.hot_swap(new, execs=execs)
    assert eng.swaps_applied == 0  # staged, not applied: no dispatch yet

    late = [eng.submit(x) for x in xs[8:]]
    eng.drain()
    assert eng.swaps_applied == 1
    assert eng.ops[1] is new[1]
    for r, y_ref in zip(reqs, ref_ys):
        assert torch.equal(r.y, y_ref)  # in flight: the old plan, bit for bit
    for r, x in zip(late, xs[8:]):
        assert_rowtol(r.y.numpy(), a, x.numpy())


def test_hot_swap_rejects_missing_buckets_and_ops_injection_validates():
    _, a = small(seed=5)
    op1 = tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"), device="cpu")
    eng = SparseEngine(a, ks=(1,), ops={1: op1}, device="cpu")
    with pytest.raises(ValueError, match="missing buckets"):
        eng.hot_swap({})
    with pytest.raises(ValueError, match="missing buckets"):
        SparseEngine(a, ks=(1, 4), ops={1: op1}, device="cpu")


# -- admission + background retune --------------------------------------------
def test_admission_is_predicted_and_retune_hot_swaps():
    d, a = small(seed=6)
    fl = fleet(retune=True)
    t = fl.add_tenant("t", a, max_wait_s=0.0)
    assert all(src == "byte_model" for src in t.admitted_from.values())
    assert t.engine is not None and fl.stats_fleet.predicted_admissions == 1
    for op in t.engine.ops.values():
        assert op.plan.measured_s == 0.0
        assert op.plan.predicted_from == "byte_model"

    xs = xs_for(a, 6)
    reqs = [fl.submit("t", x) for x in xs]
    serve_all(fl, reqs)
    for r, x in zip(reqs, xs):
        assert_rowtol(r.y.numpy(), a, x.numpy())

    assert fl.wait_retunes(timeout=WAIT_S), "background retune did not finish"
    assert fl.stats_fleet.retunes_done == 1
    assert len(fl.cache) == len(fl.ks)  # the measured plans entered the cache
    r = fl.submit("t", xs[0])
    serve_all(fl, [r])
    assert t.engine.swaps_applied == 1 and t.retuned
    assert all(op.plan.measured_s > 0 for op in t.engine.ops.values())
    assert_rowtol(r.y.numpy(), a, xs[0].numpy())
    fl.close()


def test_second_tenant_transfers_from_first_after_retune():
    _, a1 = small(seed=7)
    _, a2 = small(seed=8)  # same generator family, another pattern
    fl = fleet(retune=True)
    t1 = fl.add_tenant("t1", a1)
    assert fl.wait_retunes(timeout=WAIT_S)
    t2 = fl.add_tenant("t2", a2, retune=False)
    assert any(src == t1.fp for src in t2.admitted_from.values()), t2.admitted_from
    assert fl.stats_fleet.transferred_buckets >= 1
    fl.close()


# -- residency budget ---------------------------------------------------------
def test_tenant_sized_exactly_at_budget_is_admitted_without_eviction():
    _, a1 = small(seed=9)
    fl = fleet()
    t1 = fl.add_tenant("t1", a1)
    fl.budget_bytes = fl.resident_bytes  # <= budget is in budget
    assert t1.resident and fl.stats_fleet.evictions == 0
    _, a2 = small(seed=10)
    t2 = fl.add_tenant("t2", a2)
    assert t2.resident and not t1.resident  # t1 was idle: evicted
    assert fl.stats_fleet.evictions == 1 and fl.stats_fleet.bytes_evicted > 0


def test_zero_traffic_tenant_evicted_before_active_one():
    _, a1 = small(seed=11)
    _, a2 = small(seed=12)
    # t3 is sparser (smaller prepared dicts), so one eviction makes room.
    _, a3 = small(seed=13, density=0.02)
    fl = fleet()
    t1 = fl.add_tenant("t1", a1)
    t2 = fl.add_tenant("t2", a2)
    reqs = [fl.submit("t1", x) for x in xs_for(a1, 4)]
    serve_all(fl, reqs)
    fl.budget_bytes = fl.resident_bytes  # full: the next admission evicts
    t3 = fl.add_tenant("t3", a3)
    assert t3.resident
    assert not t2.resident, "the zero-traffic tenant should be the victim"
    assert t1.resident, "the tenant with recent traffic must survive"
    assert fl.stats_fleet.evictions >= 1
    assert not any(k[0] == t2.fp for k in tt.operator._PREP_MEMO._entries)


def test_evicted_tenant_reactivates_from_cache_on_submit():
    _, a1 = small(seed=14)
    _, a2 = small(seed=15)
    fl = fleet(retune=True)
    t1 = fl.add_tenant("t1", a1)
    assert fl.wait_retunes(timeout=WAIT_S)  # measured plans now cached
    fl.budget_bytes = fl.resident_bytes
    fl.add_tenant("t2", a2, retune=False)
    assert not t1.resident
    x = xs_for(a1, 1)[0]
    r = fl.submit("t1", x)
    assert t1.resident
    assert all(src == "cache" for src in t1.admitted_from.values())
    assert fl.stats_fleet.reactivations == 1
    serve_all(fl, [r])
    assert_rowtol(r.y.numpy(), a1, x.numpy())
    fl.close()


def test_busy_tenants_are_never_evicted_over_budget_admission_counted():
    _, a1 = small(seed=16)
    _, a2 = small(seed=17)
    fl = fleet()
    fl.add_tenant("t1", a1)
    fl.submit("t1", xs_for(a1, 1)[0])  # pending work: t1 is busy
    fl.budget_bytes = 1  # nothing fits; t1 cannot be evicted
    t2 = fl.add_tenant("t2", a2)
    assert t2.resident and fl.tenants["t1"].resident
    assert fl.stats_fleet.evictions == 0
    assert fl.stats_fleet.over_budget_admissions >= 1
    assert fl.drain() == 1


# -- scheduling -----------------------------------------------------------------
def test_round_robin_serves_all_tenants_and_slo_orders_first():
    mats = [small(seed=s) for s in (18, 19, 20)]
    fl = fleet()
    for i, (_, a) in enumerate(mats):
        fl.add_tenant(f"t{i}", a, max_wait_s=0.0)
    all_reqs = {f"t{i}": [fl.submit(f"t{i}", x) for x in xs_for(a, 4)]
                for i, (_, a) in enumerate(mats)}
    assert fl.step() == 12  # one pass dispatches for every tenant with work
    fl.flush()
    for i, (_, a) in enumerate(mats):
        for r in all_reqs[f"t{i}"]:
            assert r.done
            assert_rowtol(r.y.numpy(), a, r.x.numpy())
    assert fl.drain() == 0


def test_fleet_drain_and_stats_summary_shapes():
    _, a = small(seed=21)
    fl = fleet()
    fl.add_tenant("t", a)
    reqs = [fl.submit("t", x) for x in xs_for(a, 5)]
    assert fl.drain() == 5
    assert all(r.done for r in reqs)
    s = fl.stats().summary()
    assert s["admissions"] == 1 and "t" in s["tenants"]
    assert s["tenants"]["t"]["engine"]["requests"] == 5
    assert set(s["prep_memo"]) >= {"entries", "resident_bytes", "hits", "misses",
                                   "evictions"}
    assert s["resident_bytes"] == _table_bytes(fl.tenants["t"].engine.ops)


def test_cuda_fleet_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CPU-only refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseFleet(cache=tt.PlanCache())


# -- breaker and retune surfacing --------------------------------------------------
def test_circuit_breaker_quarantines_poisoning_tenant(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tfleet, "time", clock)  # the breaker's cooldown clock
    d_good, a_good = small(seed=8, m=96)
    _, a_bad = small(seed=9, m=96)
    storm = FaultPlan({"engine.dispatch": {"n": 500, "engine": "bad"}})
    fl = SparseFleet(ks=(1, 4), cache=tt.PlanCache(), retune=False, faults=storm,
                     breaker_threshold=2, breaker_reset_s=0.2, device="cpu",
                     supervisor_kwargs=dict(max_retries=0, **SUP_KW))
    fl.add_tenant("good", a_good)
    fl.add_tenant("bad", a_bad)
    good_x = xs_for(a_good, 8, seed=10)
    good_reqs = [fl.submit("good", x) for x in good_x]
    bad_reqs = [fl.submit("bad", x) for x in xs_for(a_bad, 8, seed=11)]
    for _ in range(40):
        fl.step()
    fl.drain()
    tenant = fl.tenants["bad"]
    assert tenant.n_quarantines >= 1 and fl.stats().quarantines >= 1
    for r in bad_reqs:  # every future of the faulty tenant resolved
        assert r.done and r.failed
        with pytest.raises((InjectedFault, CircuitOpenError)):
            r.result()
    for r, x in zip(good_reqs, good_x):  # the healthy tenant never noticed
        assert not r.failed
        assert_rowtol(r.result().numpy(), a_good, x.numpy())
    assert not fl.tenants["good"].engine.supervisor.events
    assert tenant.quarantined
    with pytest.raises(CircuitOpenError, match="quarantined"):
        fl.submit("bad", xs_for(a_bad, 1)[0])
    clock.advance(0.25)  # past the cooldown: accepted again
    assert not tenant.quarantined
    fl.submit("bad", xs_for(a_bad, 1)[0])
    assert fl.stats().summary()["tenants"]["bad"]["quarantines"] >= 1
    fl.close()


def test_retune_failure_retried_and_surfaced():
    _, a = small(seed=12, m=96)
    fl = fleet(faults=FaultPlan({"fleet.retune": {"n": 2}}), retune=True,
               retune_max_retries=2, retune_backoff_s=0.001)
    fl.add_tenant("t", a)
    assert fl.wait_retunes(timeout=WAIT_S)
    s = fl.stats().summary()
    assert s["retune_errors"] == 2  # both injected raises counted
    assert s["retunes_done"] == 1 and s["retunes_failed"] == 0
    assert "InjectedFault" in s["last_retune_error"]
    fl.close()


def test_retune_exhaustion_marks_failed_and_keeps_serving():
    _, a = small(seed=13, m=96)
    fl = fleet(faults=FaultPlan({"fleet.retune": {"n": 10}}), retune=True,
               retune_max_retries=1, retune_backoff_s=0.001)
    fl.add_tenant("t", a)
    assert fl.wait_retunes(timeout=WAIT_S)
    s = fl.stats().summary()
    assert s["retunes_failed"] == 1 and s["retune_errors"] == 2
    x = xs_for(a, 1, seed=14)[0]
    r = fl.submit("t", x)
    fl.drain()
    assert_rowtol(r.result().numpy(), a, x.numpy())  # the predicted plan serves
    fl.close()


# -- overload: fair share, bounded retunes, shared brownout --------------------------
def test_fair_share_greedy_cannot_starve_polite_in_dispatch_steps(monkeypatch):
    """The greedy tenant's refused burst never reaches the polite tenant's
    service: on a patched clock the polite request resolves within its SLO
    plus one tick, in a bounded number of dispatch steps, every round."""
    clock = Clock()
    for mod in (tfleet, tengine, toverload):
        monkeypatch.setattr(mod, "time", clock)
    _, a_greedy = small(seed=10)
    _, a_polite = small(seed=11)
    slo, tick = 0.05, 0.01
    fl = fleet(max_wait_s=0.0)
    fl.add_tenant("greedy", a_greedy, rate=20.0, burst=2.0)
    fl.add_tenant("polite", a_polite, max_wait_s=slo)
    xg = xs_for(a_greedy, 8, seed=12)
    xp = xs_for(a_polite, 8, seed=13)
    fl.submit("polite", xp[0])
    fl.submit("greedy", xg[0])
    fl.drain()
    def polite_round(j, burst):
        """Steps until the polite request resolves, and its latency."""
        nonlocal limited, admitted
        clock.advance(tick)
        for b in range(burst):  # greedy offers a burst every round...
            try:
                fl.submit("greedy", xg[(8 * j + b) % 8])
                admitted += 1
            except OverloadError:
                limited += 1  # ...and its excess fails fast, typed
        r = fl.submit("polite", xp[j % 8])
        n = 0
        while not r.done:
            n += 1
            assert n <= 100, "the polite request never resolved"
            if fl.step() == 0:
                fl.flush()
                clock.advance(tick)
        assert_rowtol(r.y.numpy(), a_polite, xp[j % 8].numpy())
        return n, r.latency_s

    limited = admitted = 0
    alone = [polite_round(j, 0) for j in range(3)]  # no greedy traffic
    loaded = [polite_round(j, 8) for j in range(24)]  # an 8x burst a round
    fl.drain()
    assert limited > 0 and admitted > 0  # the bucket bit, and let a trickle in
    assert fl.stats_fleet.rate_limited == limited
    # Patched clock, no wall time: the polite request waits out its SLO
    # (plus one tick) however hard greedy pushes, and greedy's admitted
    # trickle adds at most one dispatch step to a polite round.
    assert max(lat for _, lat in loaded) <= slo + tick + 1e-9, loaded
    assert max(n for n, _ in loaded) <= max(n for n, _ in alone) + 1, (alone, loaded)
    fl.close()


def test_retune_queue_coalesces_and_bounds():
    _, a = small(seed=14)
    fl = fleet(ks=(1,), retune_queue_max=2)
    fl.add_tenant("t1", a)
    with fl._retune_lock:  # hold the worker off while requests pile up
        fl._retune_q.put_nowait("t1")
        fl._retune_pending.add("t1")
        fl.stats_fleet.retunes_queued += 1
    for _ in range(4):
        fl._queue_retune("t1")  # same tenant: all coalesce
    assert fl.stats_fleet.retunes_coalesced == 4
    assert fl.stats_fleet.retunes_queued == 1
    for name in ("t2", "t3", "t4", "t5"):
        fl._queue_retune(name)
    assert fl.stats_fleet.retunes_dropped >= 1
    assert fl._retune_q.qsize() <= 2
    assert fl.wait_retunes(timeout=WAIT_S)
    fl.close()


def test_fleet_brownout_defers_retunes_and_requeues_on_recovery():
    _, a = small(seed=15)
    ctrl = BrownoutController(min_dwell_s=0.0)
    fl = fleet(ks=(1,), brownout=ctrl, max_queue=8)
    fl.add_tenant("t", a)
    ctrl.update(0.8)
    assert ctrl.state == BROWNOUT
    fl._queue_retune("t")
    assert fl.stats_fleet.retunes_deferred == 1
    assert fl.stats_fleet.retunes_queued == 0  # parked, not queued
    ctrl.update(0.0)  # recovery re-queues the deferred search
    assert ctrl.state == HEALTHY
    assert fl.stats_fleet.retunes_queued == 1
    assert len(fl.supervisor.events_of("brownout")) == 2  # on the fleet's log
    assert fl.wait_retunes(timeout=WAIT_S)
    # Engines read the shared controller but never update it.
    assert fl.tenants["t"].engine._brownout_update is False
    fl.close()


def test_fleet_rate_limit_is_typed_and_survives_eviction():
    _, a = small(seed=16)
    fl = fleet(ks=(1,), tenant_rate=5.0, tenant_burst=1.0)
    fl.add_tenant("t", a)
    fl.submit("t", xs_for(a, 1)[0])
    with pytest.raises(OverloadError):
        fl.submit("t", xs_for(a, 1, seed=2)[0])
    assert fl.stats_fleet.rate_limited == 1
    fl.drain()
    bucket = fl.tenants["t"].bucket
    fl._evict(fl.tenants["t"])
    assert fl.tenants["t"].bucket is bucket  # a tenant property, not residency
    fl.close()


def test_fleet_summary_aggregates_overload_counters():
    _, a = small(seed=17)
    ctrl = BrownoutController(min_dwell_s=0.0)
    fl = fleet(ks=(1,), max_queue=1, overload_policy="reject", max_wait_s=10.0,
               brownout=ctrl)
    fl.add_tenant("t", a)
    fl.submit("t", xs_for(a, 1)[0])
    with pytest.raises(OverloadError):
        fl.submit("t", xs_for(a, 1, seed=2)[0])  # per-tenant queue cap
    out = fl.stats().summary()
    assert out["rejected"] == 1
    assert out["shed_oldest"] == 0 and out["shed_deadline"] == 0
    assert out["brownout"]["state"] == HEALTHY
    fl.drain()
    fl.close()


# -- against repro's fleet -------------------------------------------------------
def _training_plans(names, scale):
    """Hand-written plan records (the same in both caches) for a few suite
    matrices, per bucket k in (1, 4)."""
    jc, tc = jt.PlanCache(), tt.PlanCache()
    picks = {1: [("csr", "vector", {}), ("sell", "ref", {"C": 8, "sigma": 64}),
                 ("bcsr", "ref", {"block": [8, 8]})],
             4: [("csr", "vector", {}), ("bcsr", "ref", {"block": [8, 8]}),
                 ("sell", "ref", {"C": 8, "sigma": 64})]}
    for i, name in enumerate(names):
        ja = jgen(name, scale=scale)
        for k in (1, 4):
            fmt, impl, params = picks[k][i % 3]
            jp = jplan.Plan(
                fingerprint=jt.fingerprint(ja), kind="spmv" if k == 1 else "spmm",
                fmt=fmt, impl=impl, params=params, est_cost=1.0, measured_s=1e-4,
                n_candidates=10, n_measured=3, k=k, backend="cpu",
                scale=[int(ja.shape[0]), int(ja.shape[1]), int(ja.nnz)],
                features=jt.extract(ja, k=k).to_dict(),
            )
            jc.put(jp)
            d = jp.to_json()
            d.pop("mesh_shape")
            tc.put(tt.Plan.from_json(d))
    return jc, tc


def test_admission_and_served_results_match_repro_on_the_same_training_cache():
    scale = 1 / 64
    jc, tc = _training_plans(["cant", "scircuit", "pdb1HYS"], scale)
    jfl = JFleet(ks=(1, 4), cache=jc, retune=False)
    tfl = SparseFleet(ks=(1, 4), cache=tc, retune=False, device="cpu")
    names = ["hood", "webbase-1M", "cant"]
    mats = {}
    for name in names:
        ja, ta = jgen(name, scale=scale), generate(name, scale=scale)
        mats[name] = ta
        jt_ = jfl.add_tenant(name, ja)
        tt_ = tfl.add_tenant(name, ta)
        assert tt_.admitted_from == jt_.admitted_from, name
        assert tt_.fp == jt_.fp
    assert tfl.tenants["cant"].admitted_from == {1: "cache", 4: "cache"}
    for key in ("cache_admissions", "predicted_admissions", "transferred_buckets",
                "byte_model_buckets"):
        assert getattr(tfl.stats_fleet, key) == getattr(jfl.stats_fleet, key), key
    rng = np.random.default_rng(3)
    xs = {n: [rng.standard_normal(mats[n].shape[1]).astype(np.float32)
              for _ in range(5)] for n in names}
    jreqs = [(n, x, jfl.submit(n, jnp.asarray(x))) for n in names for x in xs[n]]
    treqs = [(n, x, tfl.submit(n, torch.as_tensor(x))) for n in names for x in xs[n]]
    jfl.drain()
    tfl.drain()
    for (n, x, jr), (_, _, tr) in zip(jreqs, treqs):
        yt = tr.result().numpy()
        assert_rowtol(yt, mats[n], x)
        assert_rowtol(np.asarray(jr.result()), mats[n], x)
        y_ref = np.asarray(jr.result(), np.float64)  # the port against repro
        a64 = sp.csr_matrix((np.abs(mats[n].data).astype(np.float64), mats[n].indices,
                             mats[n].indptr), shape=mats[n].shape)
        assert np.all(np.abs(yt - y_ref) <= TOL * (a64 @ np.abs(x.astype(np.float64))))
    js, ts = jfl.stats().summary(), tfl.stats().summary()
    assert set(ts) == set(js)
    assert set(ts["tenants"]["hood"]) == set(js["tenants"]["hood"])
    assert ts["resident_bytes"] > 0
    jfl.close()
    tfl.close()

"""Overload protection in the port, on ``device="cpu"``: the token bucket and
the brownout controller (held against ``repro``'s on the same call
sequences), bounded admission under each policy, deadline shedding, the
overload delay site, close with and without drain, the brownout pin to the
widest bucket, and the condition wake-up across threads.

Every refusal is typed (OverloadError / DeadlineExceededError /
EngineClosedError); every admitted request resolves; every wait is
bounded."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import overload as joverload

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.runtime import overload as toverload
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.overload import (
    BROWNOUT,
    HEALTHY,
    SHED,
    BrownoutController,
    DeadlineExceededError,
    EngineClosedError,
    OverloadError,
    TokenBucket,
)

torch.set_num_threads(1)

WAIT_S = 5.0


def small(seed=0, m=128, density=0.06):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, m)) < density) * rng.standard_normal((m, m))).astype(
        np.float32
    )
    return d, csr_from_dense(d)


def engine(a, ks=(1, 4), **kw):
    kw.setdefault("cache", tt.PlanCache())
    return SparseEngine(a, ks=ks, warmup=0, timed=1, device="cpu", **kw)


def xs_for(a, count, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32))
            for _ in range(count)]


# -- the same call sequences through both packages ---------------------------
def test_token_bucket_takes_like_repro():
    rng = np.random.default_rng(0)
    jb, tb = joverload.TokenBucket(rate=8.0, burst=3.0), toverload.TokenBucket(8.0, 3.0)
    t = 100.0
    for _ in range(200):
        t += float(rng.choice([0.0, 0.03125, 0.125, 0.5]))
        n = float(rng.choice([1.0, 2.0]))
        assert tb.try_take(n, now=t) == jb.try_take(n, now=t)
        assert tb.tokens == jb.tokens


@pytest.mark.parametrize("kw", [{}, {"min_dwell_s": 0.0},
                                {"enter_brownout": 0.5, "exit_brownout": 0.2,
                                 "enter_shed": 0.8, "exit_shed": 0.6, "min_dwell_s": 0.3}])
def test_brownout_controller_steps_like_repro(kw):
    rng = np.random.default_rng(1)
    jc, tc = joverload.BrownoutController(**kw), toverload.BrownoutController(**kw)
    jc._t_entered = tc._t_entered = 0.0
    t = 0.0
    for _ in range(400):
        t += float(rng.choice([0.01, 0.1, 0.5]))
        p = float(rng.uniform(0.0, 1.2))
        assert tc.update(p, now=t) == jc.update(p, now=t)
    assert [(x.t, x.frm, x.to, x.pressure) for x in tc.transitions] == [
        (x.t, x.frm, x.to, x.pressure) for x in jc.transitions]
    assert tc.summary() == jc.summary()
    assert len(tc.transitions) > 2
    for signals in ({"queue": 0.4, "age": None, "prep": 0.9}, {"queue": None}, {}):
        assert (toverload.BrownoutController.pressure(**signals)
                == joverload.BrownoutController.pressure(**signals))


# -- token bucket ------------------------------------------------------------
def test_token_bucket_burst_then_refill():
    b = TokenBucket(rate=8.0, burst=3.0)
    t = 100.0
    assert all(b.try_take(now=t) for _ in range(3))
    assert not b.try_take(now=t)
    assert b.try_take(now=t + 0.125)
    assert not b.try_take(now=t + 0.125)
    assert sum(b.try_take(now=t + 100.0) for _ in range(10)) == 3


def test_token_bucket_validates():
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=1.0, burst=-1.0)


# -- brownout controller ------------------------------------------------------
def test_brownout_hysteresis_no_flap_on_boundary_load():
    c = BrownoutController(min_dwell_s=0.0)
    t = 0.0
    for i in range(50):
        t += 1.0
        c.update(0.71 if i % 2 == 0 else 0.69, now=t)
    assert c.state == BROWNOUT
    assert len(c.transitions) == 1
    c.update(0.34, now=t + 1.0)
    assert c.state == HEALTHY and len(c.transitions) == 2


def test_brownout_min_dwell_pins_state():
    c = BrownoutController(min_dwell_s=1.0)
    c._t_entered = 0.0
    c.update(1.0, now=2.0)
    assert c.state == SHED
    c.update(0.0, now=2.5)  # dwell: pinned despite zero pressure
    assert c.state == SHED
    c.update(0.0, now=3.5)
    assert c.state == BROWNOUT  # one level at a time
    c.update(0.0, now=5.0)
    assert c.state == HEALTHY


def test_brownout_shed_never_jumps_to_healthy():
    c = BrownoutController(min_dwell_s=0.0)
    c.update(1.0, now=1.0)
    assert c.state == SHED
    c.update(0.0, now=2.0)
    assert c.state == BROWNOUT
    assert [tr.to for tr in c.transitions] == [SHED, BROWNOUT]


def test_brownout_validates_watermarks():
    with pytest.raises(ValueError):
        BrownoutController(enter_brownout=0.5, exit_brownout=0.5)
    with pytest.raises(ValueError):
        BrownoutController(enter_brownout=0.96, enter_shed=0.95)


# -- bounded admission ---------------------------------------------------------
def test_submit_at_exactly_max_queue_boundary():
    d, a = small()
    eng = engine(a, max_queue=3, overload_policy="reject", max_wait_s=10.0)
    xs = xs_for(a, 4)
    for x in xs[:3]:
        eng.submit(x)
    assert eng.pending == 3
    with pytest.raises(OverloadError):
        eng.submit(xs[3])
    assert eng.stats.rejected == 1 and eng.pending == 3
    eng.drain()
    eng.close()
    with pytest.raises(ValueError, match="max_queue"):
        engine(a, max_queue=0)
    with pytest.raises(ValueError, match="overload_policy"):
        engine(a, overload_policy="drop")


def test_shed_oldest_preserves_fifo_for_survivors():
    d, a = small(seed=1)
    eng = engine(a, ks=(4,), max_queue=4, overload_policy="shed-oldest",
                 max_wait_s=10.0)
    xs = xs_for(a, 6)
    reqs = [eng.submit(x) for x in xs]
    assert reqs[0].failed and isinstance(reqs[0]._exc, OverloadError)
    assert reqs[1].failed and isinstance(reqs[1]._exc, OverloadError)
    assert eng.stats.shed_oldest == 2
    eng.drain()
    survivors = reqs[2:]
    assert all(r.done and not r.failed for r in survivors)
    dones = [r.t_done for r in survivors]
    assert dones == sorted(dones)
    for r in survivors:
        np.testing.assert_allclose(r.result().numpy(), d @ r.x.numpy(),
                                   rtol=1e-4, atol=1e-4)
    eng.close()


def test_block_policy_waits_then_admits():
    d, a = small(seed=2)
    eng = engine(a, ks=(1,), max_queue=1, overload_policy="block",
                 block_timeout_s=5.0, max_wait_s=0.0)
    xs = xs_for(a, 3)
    r0 = eng.submit(xs[0])
    r1 = eng.submit(xs[1])  # full queue: block drives a dispatch itself
    assert eng.stats.rejected == 0
    eng.drain()
    assert r0.done and r1.done and not (r0.failed or r1.failed)
    eng.close()


def test_block_policy_times_out_typed():
    d, a = small(seed=3)
    eng = engine(a, ks=(4,), max_queue=1, overload_policy="block",
                 block_timeout_s=0.05, max_wait_s=30.0)
    eng.submit(xs_for(a, 1)[0])
    t0 = time.perf_counter()
    with pytest.raises(OverloadError):
        eng.submit(xs_for(a, 1, seed=9)[0])
    waited = time.perf_counter() - t0
    assert 0.04 <= waited < 2.0
    assert eng.stats.rejected == 1
    eng.drain()
    eng.close()


def test_deadline_shed_is_typed_and_counted():
    d, a = small(seed=4)
    eng = engine(a, max_queue=16, max_wait_s=0.0, shed_after_s=0.002)
    r = eng.submit(xs_for(a, 1)[0])
    time.sleep(0.01)  # lapse the deadline before any dispatch runs
    assert eng.step() == 0
    assert r.failed and isinstance(r._exc, DeadlineExceededError)
    assert isinstance(r._exc, OverloadError)
    assert eng.stats.shed_deadline == 1
    with pytest.raises(DeadlineExceededError):
        r.result()
    eng.close()


def test_overload_delay_site_stalls_dispatch():
    d, a = small(seed=5)
    plan = FaultPlan({"engine.overload": {"delay_s": 0.03, "n": 1}})
    eng = engine(a, ks=(1,), faults=plan)
    xs = xs_for(a, 1)
    t0 = time.perf_counter()
    (y,) = eng.run(xs)
    assert time.perf_counter() - t0 >= 0.03
    assert plan.fired("engine.overload") == 1
    assert plan.delay("engine.overload") == 0.0  # n spent: no stall
    np.testing.assert_allclose(y.numpy(), d @ xs[0].numpy(), atol=1e-4)
    eng.close()


def test_close_without_drain_fails_futures_immediately():
    d, a = small(seed=6)
    eng = engine(a, max_wait_s=10.0)
    reqs = [eng.submit(x) for x in xs_for(a, 3)]
    eng.close(drain=False)
    t0 = time.perf_counter()
    for r in reqs:
        with pytest.raises(EngineClosedError):
            r.result(timeout=WAIT_S)
    assert time.perf_counter() - t0 < 1.0
    assert eng.stats.failed_requests == 3
    (ev,) = eng.supervisor.events_of("engine_aborted")
    assert ev.info["n_requests"] == 3
    with pytest.raises(EngineClosedError, match="closed"):
        eng.submit(xs_for(a, 1)[0])
    eng.close()  # a second close is a no-op


def test_close_drain_default_still_serves():
    d, a = small(seed=7)
    eng = engine(a)
    r = eng.submit(xs_for(a, 1)[0])
    eng.close()
    assert r.done and not r.failed
    assert eng.supervisor.events_of("engine_aborted") == []


# -- brownout wired through the engine ----------------------------------------
def test_engine_brownout_degrades_and_recovers():
    d, a = small(seed=8)
    ctrl = BrownoutController(min_dwell_s=0.0)
    eng = engine(a, ks=(1, 4), max_queue=8, shed_after_s=1.0, max_wait_s=0.0,
                 brownout=ctrl)
    assert eng.supervisor.events_of("brownout") == []
    xs = xs_for(a, 8)
    reqs = [eng.submit(x) for x in xs]
    eng.step()  # pressure 8/8 = 1.0
    assert ctrl.entries(SHED) >= 1 or ctrl.entries(BROWNOUT) >= 1
    if ctrl.state == SHED:
        with pytest.raises(OverloadError, match="shedding"):
            eng.submit(xs[0])
        with pytest.raises(OverloadError, match="shedding"):
            eng.submit_sparse(np.array([1], np.int64), np.array([1.0], np.float32))
    while eng.pending:
        eng.step()
    eng.drain()
    for _ in range(4):
        eng.step()
    assert ctrl.state == HEALTHY
    assert len(eng.supervisor.events_of("brownout")) == len(ctrl.transitions)
    assert all(r.done and not r.failed for r in reqs)
    assert eng.stats.summary()["by_bucket"] == {4: 2}  # pinned to the widest
    eng.close()


def _pinned(ctrl, pressure):
    """Drive ``ctrl`` to the state of ``pressure`` on a clock far ahead, so
    its dwell time holds that state through every real-time update."""
    ctrl.update(pressure, now=time.perf_counter() + 1e6 * (1 + len(ctrl.transitions)))


def test_brownout_pins_widest_bucket():
    d, a = small(seed=9)
    ctrl = BrownoutController(min_dwell_s=1e5)
    eng = engine(a, ks=(1, 4), brownout=ctrl)
    _pinned(ctrl, 0.8)
    assert ctrl.state == BROWNOUT
    x = xs_for(a, 1)[0]
    r = eng.submit(x)
    eng.step(force=True)
    eng.flush()
    assert eng.stats.dispatched.get(4, 0) == 1 and eng.stats.dispatched.get(1, 0) == 0
    np.testing.assert_allclose(r.result().numpy(), d @ x.numpy(), atol=1e-4)
    _pinned(ctrl, 0.0)
    assert ctrl.state == HEALTHY
    eng.submit(x)
    eng.step(force=True)
    eng.flush()
    assert eng.stats.dispatched.get(1, 0) == 1
    assert len(eng.supervisor.events_of("brownout")) == len(ctrl.transitions) == 2
    eng.close()


def test_run_absorbs_rejections():
    d, a = small(seed=11)
    eng = engine(a, ks=(1, 4), max_queue=2, overload_policy="reject")
    xs = xs_for(a, 9)
    ys = eng.run(xs)
    assert eng.stats.rejected > 0
    for y, x in zip(ys, xs):
        np.testing.assert_allclose(y.numpy(), d @ x.numpy(), atol=1e-4)
    eng.close()


# -- result() waits on the condition -------------------------------------------
def test_result_wakes_via_condition_across_threads():
    d, a = small(seed=18)
    eng = engine(a, ks=(1,), max_wait_s=None)
    r = eng.submit(xs_for(a, 1)[0])
    got: list = []

    def waiter():
        got.append(r.result(timeout=WAIT_S).numpy())

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    eng.drain()
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and len(got) == 1
    np.testing.assert_allclose(got[0], d @ r.x.numpy(), rtol=1e-4, atol=1e-4)
    eng.close()


def test_result_timeout_still_honored_with_condition_wait():
    d, a = small(seed=19)
    eng = engine(a, ks=(4,), max_wait_s=None)
    r = eng.submit(xs_for(a, 1)[0])
    eng._serve_lock.acquire()
    try:
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            r.result(timeout=0.05)
        assert time.perf_counter() - t0 < 2.0
    finally:
        eng._serve_lock.release()
    eng.drain()
    eng.close()


def test_full_prep_memo_leaves_an_idle_engine_serving(monkeypatch):
    """A prep memo filled past the shedding watermark is no overload: an
    idle engine stays HEALTHY, admits work and serves it."""
    from repro_torch.tune import operator as top

    d, a = small(seed=12)
    monkeypatch.setattr(top, "_PREP_MEMO", top.PrepCache(budget_bytes=10**6))
    eng = engine(a, ks=(1, 4), max_queue=8, brownout=BrownoutController(min_dwell_s=0.0))
    eng.run(xs_for(a, 4))  # fills the memo with this matrix's preps
    st = top.prep_memo_stats()
    monkeypatch.setattr(top._PREP_MEMO, "budget_bytes",
                        int(st["resident_bytes"] / 0.97))
    assert top.prep_memo_stats()["resident_bytes"] > 0.95 * top.prep_memo_stats()["budget_bytes"]
    for _ in range(3):
        eng.step()
    assert eng.brownout.state == HEALTHY and eng._overload_pressure() == 0.0
    xs = xs_for(a, 6, seed=2)
    ys = eng.run(xs)
    for y, x in zip(ys, xs):
        np.testing.assert_allclose(y.numpy(), d @ x.numpy(), atol=1e-4)
    assert eng.stats.rejected == 0 and eng.brownout.state == HEALTHY
    eng.close()


def test_run_raises_when_refused_past_block_timeout():
    """With nothing left to serve, run() waits ``block_timeout_s`` for the
    refusal to lift, then re-raises it instead of spinning."""
    d, a = small(seed=14)
    ctrl = BrownoutController(min_dwell_s=1e5)
    eng = engine(a, ks=(1, 4), brownout=ctrl, block_timeout_s=0.05)
    _pinned(ctrl, 1.0)
    assert ctrl.state == SHED
    t0 = time.perf_counter()
    with pytest.raises(OverloadError, match="shedding"):
        eng.run(xs_for(a, 2))
    assert 0.05 <= time.perf_counter() - t0 < WAIT_S
    assert eng.pending == 0 and eng.stats.rejected >= 2
    eng.close()

"""The port's tracer (``runtime.tracing``) and the engine's request stamps:
off, nothing is recorded and a span is the shared no-op; on, a small CPU
engine run records the set-up and serving spans with their parent links,
one ``engine.step`` span per dispatched batch, and stamps every request
with its batch and dispatch time; the span cap counts what it drops; the
profiler sees the spans as ``repro.*`` ranges; the benchmark's harness
leaves the tracer off.  On a card, the batch records' device times agree
with the profiler's."""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.tune as tt
from repro_torch.data.suite import generate
from repro_torch.runtime import tracing
from repro_torch.runtime.engine import SparseEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.enable()
    tracing.disable()
    yield
    tracing.disable()


def _engine(a, cache=None, device="cpu"):
    return SparseEngine(a, ks=(1, 4, 16), cache=tt.PlanCache() if cache is None else cache,
                        warmup=0, timed=1, device=device)


def _xs(a, count, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32))
            for _ in range(count)]


def _serve(eng, xs):
    """21 requests in batches of 16, 4 and 1, each submitted and stepped."""
    reqs = []
    for lo, hi in ((0, 16), (16, 20), (20, 21)):
        reqs += [eng.submit(x) for x in xs[lo:hi]]
        assert eng.step() == hi - lo
    eng.flush()
    return reqs


def test_off_a_span_is_the_shared_noop():
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", {"k": 1})
    assert a is b and a.on is False
    with a as sp:
        assert sp is a
    assert tracing.device_event(torch.device("cpu")) is None
    tracing.mark_stacked(torch.device("cpu"))
    assert tracing.take_stacked() is None
    tracing.annotate(k=1)
    assert tracing.spans() == [] and tracing.batches() == []


def test_off_an_engine_run_records_nothing_and_still_stamps():
    a = generate("cant", scale=1 / 64)
    eng = _engine(a)
    reqs = _serve(eng, _xs(a, 21))
    assert tracing.spans() == [] and tracing.batches() == []
    assert [r.batch for r in reqs] == [0] * 16 + [1] * 4 + [2]
    assert all(r.t_submit <= r.t_dispatch <= r.t_done for r in reqs)
    assert not hasattr(eng.stats, "latencies_s")
    assert not {"latency_mean_ms", "latency_p99_ms"} & set(eng.stats.summary())
    eng.close()


def _by_id(recs):
    return {r.span_id: r for r in recs}


def test_on_an_engine_run_records_its_spans_and_links_them():
    # values of their own: no format of this matrix is in the process's memo
    a = generate("cant", scale=1 / 64, seed=34)
    cache = tt.PlanCache()
    tracing.enable()
    eng = _engine(a, cache)  # every bucket searched
    again = _engine(a, cache)  # every bucket from the cache, its formats memoized
    t0 = time.perf_counter_ns()
    reqs = _serve(eng, _xs(a, 21))
    tracing.disable()
    recs = tracing.spans()
    ids = _by_id(recs)

    def parent(r):
        return ids[r.parent_id].name if r.parent_id is not None else None

    setup = [r for r in recs if r.start_ns < t0]
    builds = [r for r in setup if r.name == "engine.build"]
    assert len(builds) == 2 and all(parent(r) is None for r in builds)
    tunes = [r for r in setup if r.name == "tune.build"]
    assert sorted((r.attrs["k"], r.attrs["from_cache"]) for r in tunes) == [
        (1, False), (1, True), (4, False), (4, True), (16, False), (16, True)]
    assert all(parent(r) == "engine.build" for r in tunes)
    for r in setup:
        if r.name in ("tune.fingerprint", "tune.lookup", "tune.search"):
            assert parent(r) == "tune.build", r
        if r.name == "prepare":
            assert parent(r) in ("tune.build", "tune.search")
            assert r.attrs["memo"] in ("hit", "miss") and r.attrs["fmt"]
        if r.name in ("prepare.digest", "prepare.format"):
            assert parent(r) == "prepare"
    n_search = sum(r.name == "tune.search" for r in setup)
    assert n_search == 3 and sum(r.name == "tune.lookup" for r in setup) == 6
    hits = [r for r in setup if r.name == "prepare" and parent(r) == "tune.build"]
    assert len(hits) == 3 and all(r.attrs["memo"] == "hit" for r in hits)
    formats = [r for r in setup if r.name == "prepare.format"]
    assert formats and all(ids[r.parent_id].attrs["memo"] == "miss" for r in formats)

    serving = [r for r in recs if r.start_ns >= t0]
    steps = [r for r in serving if r.name == "engine.step"]
    assert [(s.attrs["batch"], s.attrs["bucket"], s.attrs["take"]) for s in steps] == [
        (0, 16, 16), (1, 4, 4), (2, 1, 1)]
    assert all(parent(s) is None for s in steps)
    for r in serving:
        want = {"engine.assemble": {"engine.step"}, "engine.launch": {"engine.step"},
                "executable.stack": {"engine.launch"}, "executable.run": {"engine.launch"},
                "engine.retire": {"engine.step", None},
                "engine.resolve": {"engine.retire"}, "engine.step": {None}}[r.name]
        assert parent(r) in want, r
    # the eager k = 1 closure is the plan itself: buckets 16 and 4 stack
    assert sum(r.name == "executable.stack" for r in serving) == 2
    retired = sorted(r.attrs["batch"] for r in serving if r.name == "engine.retire")
    assert retired == [0, 1, 2]

    step_of = {s.attrs["batch"]: s for s in steps}
    assert sorted({r.batch for r in reqs}) == sorted(step_of)
    for r in reqs:
        assert r.t_submit <= r.t_dispatch <= r.t_done
        s = step_of[r.batch].attrs
        assert s["first"] <= r.rid <= s["last"]
    assert tracing.batches() == []  # no card: no device times

    summ = tracing.summary()
    assert summ["engine.step"]["count"] == 3
    assert all(0 <= v["self_s"] <= v["total_s"] for v in summ.values())
    eng.close()
    again.close()


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span("s", {"i": i}):
            pass
    assert [r.attrs["i"] for r in tracing.spans()] == [0, 1, 2]
    assert tracing.dropped() == 2
    tracing.enable()
    assert tracing.dropped() == 0 and tracing.spans() == []


def test_each_thread_keeps_its_own_parents():
    tracing.enable()
    errors = []
    old = sys.getswitchinterval()

    def work(i):
        try:
            for _ in range(100):
                with tracing.span("outer", {"thread": i}):
                    with tracing.span("inner", {"thread": i}):
                        pass
        except Exception as exc:  # reported below
            errors.append(exc)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = tracing.spans()
    ids = _by_id(recs)
    assert len(recs) == 8 * 100 * 2
    for r in recs:
        if r.name == "inner":
            p = ids[r.parent_id]
            assert p.name == "outer" and p.attrs == r.attrs and p.thread == r.thread
        else:
            assert r.parent_id is None


def test_the_profiler_sees_spans_as_repro_ranges_only_when_on():
    def names(on):
        if on:
            tracing.enable()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.span("engine.step"):
                torch.ones(4).sum()
        tracing.disable()
        return {e.name for e in prof.events()}

    assert "repro.engine.step" in names(True)
    assert not any(n.startswith("repro.") for n in names(False))


def test_the_benchmark_harness_leaves_the_tracer_off(tmp_path, monkeypatch):
    """``bench/run.py`` with ``--trace 0`` and ``--trace 1``: the tracer
    stays off and records nothing, so the harness's traced device rows
    hold no ``repro.*`` range."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(tt.plan, "_default", None, raising=False)
    monkeypatch.syspath_prepend(str(ROOT / "bench"))
    from benchkit import cell, spec

    c = spec.find_cell(ROOT, "ldoor.stream")
    for trace in (False, True):
        out = cell.run(c, 2**31 + 11, 0.5, trace, "cpu", time.perf_counter(),
                       scale=1 / 512, cache=tmp_path, samples=8)
        assert out["correct"] is True
        assert not tracing.enabled() and tracing.spans() == [] and tracing.batches() == []


@pytest.mark.gpu
def test_gpu_batch_device_times_match_the_profiler():
    """A stream of bucket-64 batches with the tracer on, the card kept busy
    (the requests queued beforehand, the profiler tracing the device only):
    the mean of each batch's ``stack_ms + plan_ms`` is within 5 % of the
    profiler's device time a batch (every kernel, copy and fill, the
    ``repro.*`` mirrors left out).  Where the host cannot keep up, the
    events also count the card's idle time inside a batch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the batch events are timed only on a card")
    dev = torch.device("cuda")
    a = generate("ldoor", scale=0.5)
    op = tt.SparseOperator.from_candidate(a, tt.make("bcsr", "cuda", block=(8, 8)), k=64,
                                          device=dev)
    eng = SparseEngine(a, ks=(64,), ops={64: op}, device=dev)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32), device=dev)
          for _ in range(64)]
    for x in xs:  # warm the bucket outside the profile
        eng.submit(x)
    eng.drain()
    n_batches = 40
    for _ in range(n_batches):
        for x in xs:
            eng.submit(x)
    tracing.enable()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_batches):
            assert eng.step() == 64
        eng.flush()
        torch.cuda.synchronize(dev)
    tracing.disable()
    recs = tracing.batches()
    assert len(recs) == n_batches and all(r.bucket == 64 and r.take == 64 for r in recs)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.name().startswith("repro.")]
    device_ms = sum(e.end_ns() - e.start_ns() for e in events) * 1e-6 / n_batches
    events_ms = sum(r.stack_ms + r.plan_ms for r in recs) / n_batches
    assert abs(events_ms - device_ms) <= 0.05 * device_ms, (events_ms, device_ms)
    assert all(r.stack_ms > 0 and r.plan_ms > 0 for r in recs)
    eng.close()

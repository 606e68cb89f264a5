"""The port's SparseEngine: per-request agreement with the JAX package's
engine under pinned plan tables, async == sync bit for bit, FIFO futures,
k-bucket round-up, admission control, lifecycle, dtype policy, the sparse
lane (``submit_sparse``, run on both packages) and the serve CLI on the
CPU."""
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.runtime.engine import SparseEngine as JEngine

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.runtime.engine import EngineClosedError, SparseEngine

# Small shapes: one torch thread keeps the parallel workers from
# oversubscribing the CPU under timing-sensitive neighbours.
torch.set_num_threads(1)

TOL = 1e-5


def small(seed=0, m=128, density=0.06):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, m)) < density) * rng.standard_normal((m, m))).astype(
        np.float32
    )
    return d, csr_from_dense(d)


def engine(a, ks=(1, 4, 16), **kw):
    return SparseEngine(a, ks=ks, cache=tt.PlanCache(), warmup=0, timed=1,
                        device="cpu", **kw)


def xs_for(a, count, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(a.shape[1]).astype(np.float32) for _ in range(count)]


def assert_rowtol(got, want, d, x):
    scale = np.abs(d.astype(np.float64)) @ np.abs(x.astype(np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= TOL * scale), float((err - TOL * scale).max())


def test_pinned_engines_agree_with_repro_per_request():
    d, a = small(seed=30, m=120)
    ja = j_csr_from_dense(d)
    ks = (1, 4)
    jops = {
        1: jt.SparseOperator.from_candidate(
            ja, jt.make("sell", "pallas", C=8, sigma=64, chunk_tile=8)),
        4: jt.SparseOperator.from_candidate(
            ja, jt.make("bcsr", "pallas", block=(8, 8)), k=4),
    }
    tops = {
        1: tt.SparseOperator.from_candidate(
            a, tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8), device="cpu"),
        4: tt.SparseOperator.from_candidate(
            a, tt.make("bcsr", "cuda", block=(8, 8)), k=4, device="cpu"),
    }
    jeng = JEngine(ja, ks=ks, ops=jops, async_depth=0)
    teng = SparseEngine(a, ks=ks, ops=tops, device="cpu")
    xs = xs_for(a, 7, seed=31)
    results = []
    for eng, conv in ((jeng, jnp.asarray), (teng, torch.as_tensor)):
        reqs = [eng.submit(conv(xs[0]))]
        eng.step()  # bucket 1
        reqs += [eng.submit(conv(x)) for x in xs[1:]]
        eng.drain()  # buckets 4, then 4 holding two requests
        results.append(([np.asarray(r.y) for r in reqs], [r.bucket for r in reqs]))
    (jy, jb), (ty, tb) = results
    assert tb == jb == [1, 4, 4, 4, 4, 4, 4]
    for x, y_j, y_t in zip(xs, jy, ty):
        assert_rowtol(y_t, y_j, d, x)
        assert_rowtol(y_t, d.astype(np.float64) @ x, d, x)


def test_tuned_engine_matches_oracle():
    d, a = small()
    eng = engine(a)
    xs = xs_for(a, 21)
    reqs = [eng.submit(x) for x in xs]
    eng.drain()
    for r, x in zip(reqs, xs):
        assert r.done and r.latency_s >= 0
        assert_rowtol(r.y.numpy(), d.astype(np.float64) @ x, d, x)
    assert eng.stats.n_requests == 21 and eng.pending == 0


def test_async_results_bitwise_match_synchronous_engine():
    _, a = small(seed=11)
    cache = tt.PlanCache()
    xs = xs_for(a, 23, seed=12)
    kw = dict(ks=(1, 4, 16), cache=cache, warmup=0, timed=1, device="cpu")
    ys_sync = SparseEngine(a, async_depth=0, **kw).run(xs)
    ys_async = SparseEngine(a, async_depth=2, **kw).run(xs)
    for ys, ya in zip(ys_sync, ys_async):
        assert torch.equal(ys, ya)


def test_k_bucket_round_up_and_padding():
    d, a = small(seed=2)
    eng = engine(a)
    xs = xs_for(a, 5, seed=3)
    reqs = [eng.submit(x) for x in xs]
    assert eng.step() == 5
    eng.flush()
    assert eng.stats.dispatched == {16: 1}
    s = eng.stats.summary()
    assert s["served_cols"] == 5 and s["padded_cols"] == 11
    assert abs(s["occupancy"] - 5 / 16) < 1e-9
    assert abs(s["padded_occupancy"] - 11 / 16) < 1e-9
    for r, x in zip(reqs, xs):
        assert r.bucket == 16
        assert_rowtol(r.y.numpy(), d.astype(np.float64) @ x, d, x)
    assert eng.step() == 0 and eng.drain() == 0


def test_two_batches_in_flight_and_futures_resolve_in_submission_order():
    d, a = small(seed=15)
    eng = engine(a, ks=(1, 4), async_depth=2)
    xs = xs_for(a, 11, seed=16)
    reqs = [eng.submit(x) for x in xs]
    assert eng.step() == 4 and eng.step() == 4
    assert eng.in_flight == 2 and not any(r.done for r in reqs)
    y_last = reqs[-1].result(timeout=30)
    assert all(r.done for r in reqs)
    done_times = [r.t_done for r in reqs]
    assert done_times == sorted(done_times)  # FIFO retirement
    assert_rowtol(y_last.numpy(), d.astype(np.float64) @ xs[-1], d, xs[-1])
    assert eng.stats.n_dispatches == 3
    other = engine(a, ks=(1,)).submit(xs[0])
    other._engine = eng
    with pytest.raises(RuntimeError):
        other.result()


def test_admission_control_holds_then_dispatches_partial_bucket():
    d, a = small(seed=20)
    eng = engine(a, ks=(1, 4), max_wait_s=0.05)
    x = xs_for(a, 1, seed=21)[0]
    req = eng.submit(x)
    assert eng.step() == 0 and eng.pending == 1  # held under its SLO
    deadline = time.perf_counter() + 5.0
    while eng.step() == 0:
        assert time.perf_counter() < deadline, "SLO expiry never dispatched"
        time.sleep(0.005)
    eng.flush()
    assert req.done and req.bucket == 1 and req.latency_s >= 0.05
    assert_rowtol(req.y.numpy(), d.astype(np.float64) @ x, d, x)
    full = engine(a, ks=(1, 4), max_wait_s=10.0)
    for x in xs_for(a, 4, seed=22):
        full.submit(x)
    assert full.step() == 4  # max(ks) pending: no reason to wait


def test_close_dtype_policy_and_shape_checks():
    _, a = small(seed=40)
    eng = engine(a, ks=(1, 4))
    with pytest.raises(ValueError):
        eng.submit(np.zeros(3, np.float32))
    x64 = np.random.default_rng(0).standard_normal(a.shape[1])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r1 = eng.submit(x64)
        eng.submit(x64)
    assert sum("casting" in str(x.message) for x in w) == 1  # once per engine
    assert r1.x.dtype == torch.float32
    strict = engine(a, ks=(1,), strict_dtype=True)
    with pytest.raises(TypeError):
        strict.submit(x64)
    eng.close(drain=False)
    assert r1.failed
    with pytest.raises(EngineClosedError):
        r1.result()
    with pytest.raises(EngineClosedError):
        eng.submit(x64.astype(np.float32))
    graceful = engine(a, ks=(1,))
    r = graceful.submit(x64.astype(np.float32))
    graceful.close()
    assert r.done and not r.failed


# ---------------------------------------------------------------------------
# The sparse lane: the JAX package's submit_sparse tests, run on both packages
# ---------------------------------------------------------------------------
def both_engine(pkg, d, **kw):
    if pkg == "repro":
        return JEngine(j_csr_from_dense(d), cache=jt.PlanCache(), warmup=0,
                       timed=1, **kw)
    return engine(csr_from_dense(d), **kw)


def sparse_request(seed, n, nx):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=nx, replace=False)).astype(np.int64)
    val = rng.standard_normal(nx).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[idx] = val
    return idx, val, x


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_submit_sparse_matches_dense_oracle_and_buckets_by_nnz(pkg):
    d, _ = small(seed=70)
    eng = both_engine(pkg, d, ks=(1,), x_nnz_buckets=(4, 16))
    idx, val, x = sparse_request(71, 128, 3)
    fut = eng.submit_sparse(idx, val)
    eng.drain()
    assert_rowtol(np.asarray(fut.result()), d.astype(np.float64) @ x, d, x)
    # nnz=3 rounds up to the 4-bucket; stats keep the sparse lane apart
    s = eng.stats.summary()
    assert s["sparse_by_bucket"] == {"spmspv4": 1} and s["by_bucket"] == {}
    assert fut.bucket == ("spmspv", 4)


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_submit_sparse_oversize_falls_back_to_densify(pkg):
    d, _ = small(seed=72)
    eng = both_engine(pkg, d, ks=(1,), x_nnz_buckets=(4,))
    idx, val, x = sparse_request(73, 128, 9)
    fut = eng.submit_sparse(idx, val)  # nnz=9 > largest bucket 4
    eng.drain()
    assert_rowtol(np.asarray(fut.result()), d.astype(np.float64) @ x, d, x)
    s = eng.stats.summary()
    assert s["sparse_by_bucket"] == {}  # served by the dense k=1 lane
    assert s["by_bucket"] == {1: 1}


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_submit_sparse_rejects_bad_indices_loudly(pkg):
    d, _ = small(seed=74)
    eng = both_engine(pkg, d, ks=(1,), x_nnz_buckets=(8,))
    val2 = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="outside"):
        eng.submit_sparse(np.array([0, 128], np.int64), val2)
    with pytest.raises(ValueError, match="strictly increasing"):
        eng.submit_sparse(np.array([5, 2], np.int64), val2)
    with pytest.raises(ValueError, match="strictly increasing"):  # duplicates
        eng.submit_sparse(np.array([3, 3], np.int64), val2)
    with pytest.raises(ValueError, match="integer"):
        eng.submit_sparse(np.array([0.0, 1.0]), val2)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit_sparse(np.array([[0, 1]], np.int64), val2)
    with pytest.raises(ValueError, match="same length"):
        eng.submit_sparse(np.array([0, 1], np.int64), np.ones(3, np.float32))
    assert eng.stats.n_requests == 0


@pytest.mark.parametrize("pkg", ["repro", "port"])
def test_submit_sparse_strict_dtype_raises_instead_of_casting(pkg):
    d, _ = small(seed=75)
    eng = both_engine(pkg, d, ks=(1,), x_nnz_buckets=(8,), strict_dtype=True)
    with pytest.raises(TypeError, match="float32"):
        eng.submit_sparse(np.array([1, 2], np.int64), np.ones(2, np.float64))


def test_sparse_lane_shares_the_window_and_agrees_with_repro():
    """Sparse and dense requests interleave in one FIFO window; the default
    buckets are the JAX package's; a pinned spmspv/cuda lane (plain scatter
    on the CPU) answers as the JAX package's pinned pallas lane does."""
    d, a = small(seed=76)
    assert engine(a, ks=(1,)).x_nnz_buckets == JEngine(
        j_csr_from_dense(d), ks=(1,), cache=jt.PlanCache(), warmup=0,
        timed=1).x_nnz_buckets == (1, 2, 8, 32)
    reqs = [sparse_request(77 + i, 128, nx) for i, nx in enumerate((1, 5, 20, 2))]
    xs = xs_for(a, 3, seed=78)
    results = []
    for pkg, mod, impl, kw in (("repro", jt, "pallas", {}),
                               ("port", tt, "cuda", {"device": "cpu"})):
        eng = both_engine(pkg, d, ks=(1, 4), x_nnz_buckets=(2, 8, 32), async_depth=2)
        for b in eng.x_nnz_buckets:  # pin the sparse lane
            eng._sparse_ops[b] = mod.SparseOperator.from_candidate(
                eng.a, mod.make("spmspv", impl, slab=4096), x_nnz=b, **kw)
        futs = [eng.submit_sparse(*reqs[0][:2])]
        futs += [eng.submit(x) for x in xs]
        futs += [eng.submit_sparse(*r[:2]) for r in reqs[1:]]
        assert eng.in_flight <= 2
        eng.drain()
        results.append(([np.asarray(f.result()) for f in futs],
                        eng.stats.summary()["sparse_by_bucket"]))
    (jy, jb), (ty, tb) = results
    assert tb == jb == {"spmspv2": 2, "spmspv8": 1, "spmspv32": 1}
    wants = [r[2] for r in reqs[:1]] + xs + [r[2] for r in reqs[1:]]
    for y_j, y_t, x in zip(jy, ty, wants):
        assert_rowtol(y_t, y_j, d, x)
        assert_rowtol(y_t, d.astype(np.float64) @ x, d, x)


def test_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, a = small(seed=41)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseEngine(a, ks=(1,), cache=tt.PlanCache())


def test_serve_cli_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(tt.plan, "_default", None)
    stats = tmp_path / "stats.json"
    argv = ["--sparse", "cant", "--scale", "0.005", "--device", "cpu",
            "--requests", "9", "--k-buckets", "1,4", "--stats-json", str(stats)]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "served 9/9 spmv requests on cant" in out and "searched in" in out
    assert "device=cpu" in out and stats.exists()
    serve.main(argv)
    assert "plan table from cache" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--sparse", "nope", "--device", "cpu"])

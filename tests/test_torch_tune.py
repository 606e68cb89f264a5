"""The port's tuner against the JAX package's: the same candidate space (up
to the impl rename ``pallas`` -> ``cuda`` and the tiers not ported yet),
equal features and byte-model estimates, every ported candidate equal to
``repro``'s and to a float64 oracle, and the plan cache, timer and search
bookkeeping on their own."""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core.formats import csr_from_dense as j_csr_from_dense

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.data.suite import generate
from repro_torch.tune import plan as tplan
from repro_torch.tune.timing import time_fn

# Small shapes: one torch thread keeps the parallel workers from
# oversubscribing the CPU under timing-sensitive neighbours.
torch.set_num_threads(1)

NOT_PORTED_FMTS = {"merge"}  # and csr/scalar; see ROADMAP


def ported_keys(cands):
    return [
        c.key().replace("/pallas", "/cuda")
        for c in cands
        if c.fmt not in NOT_PORTED_FMTS and not (c.fmt == "csr" and c.impl == "scalar")
    ]


def pair(name="cant", scale=1 / 128):
    from repro.data.suite import generate as jgen

    return jgen(name, scale=scale), generate(name, scale=scale)


@pytest.mark.parametrize("name", ["cant", "scircuit"])
def test_enumeration_features_and_costs_match(name):
    ja, ta = pair(name)
    for kind, k in (("spmv", 1), ("spmm", 16), ("spmm", 3_000_000)):
        jfe, tfe = jt.extract(ja, k=k), tt.extract(ta, k=k)
        assert tfe.to_dict() == jfe.to_dict()
        jc = jt.enumerate_candidates(jfe, kind, k=k)
        tc = tt.enumerate_candidates(tfe, kind, k=k)
        assert [c.key() for c in tc] == ported_keys(jc)
        if k > 1_000_000:  # x beyond the on-chip budget: column slabs join
            assert any(c.fmt == "sell_blocked" and c.impl == "cuda" for c in tc)
        by_key = {c.key().replace("/pallas", "/cuda"): c for c in jc}
        for c in tc:
            for on_cpu in (True, False):
                assert tt.estimate_cost(ta, c, tfe, k=k, on_cpu=on_cpu) == (
                    jt.estimate_cost(ja, by_key[c.key()], jfe, k=k, on_cpu=on_cpu)
                ), (c.key(), on_cpu)
    L = np.diff(ta.indptr).astype(np.int64)
    for sigma in (1, 64, 256):
        assert tt.candidates.sell_padded_slots(L, 8, sigma) == (
            jt.sell_padded_slots(L, 8, sigma))
    for block in tt.BCSR_BLOCKS:
        assert tt.candidates.bcsr_block_count(ta, block) == (
            jt.bcsr_block_count(ja, block))


def _dense(seed=0, m=96, n=88):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < 0.09) * rng.standard_normal((m, n))).astype(np.float32)
    d[7] = 0.0
    d[40] = rng.standard_normal(n).astype(np.float32)  # one dense row
    return d


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_every_ported_candidate_matches_repro_and_f64_oracle(kind):
    d = _dense(1)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    k = 1 if kind == "spmv" else 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal(88 if k == 1 else (88, k)).astype(np.float32)
    scale = np.abs(d.astype(np.float64)) @ np.abs(x.astype(np.float64))
    want = d.astype(np.float64) @ x.astype(np.float64)
    cands = tt.enumerate_candidates(tt.extract(ta, k=k), kind, k=k)
    if kind == "spmv":  # column slabs only self-enumerate for a huge x
        cands += [tt.make("sell_blocked", "ref", C=8, sigma=64, n_slabs=3),
                  tt.make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=3,
                          chunk_tile=8)]
    for c in cands:
        jc = jt.make(c.fmt, c.impl.replace("cuda", "pallas"), **c.param_dict)
        if jc.fmt == "sell_blocked" and jc.impl == "pallas":
            jc = jt.make("sell_blocked", "pallas", C=8, sigma=64, n_slabs=3)
        kk = None if k == 1 else k
        got = (tt.SparseOperator.from_candidate(ta, c, k=kk, device="cpu")
               @ torch.as_tensor(x)).numpy()
        ref = np.asarray(jt.SparseOperator.from_candidate(ja, jc, k=kk) @ jnp.asarray(x))
        for what, other in (("repro", ref), ("f64", want)):
            err = np.abs(got.astype(np.float64) - other)
            assert np.all(err <= 1e-5 * scale), (c.key(), what, float(err.max()))


def test_sell_blocked_and_sell_kernel_refuse_spmm_and_search_records_it():
    d = _dense(3)
    a = csr_from_dense(d)
    cands = [tt.make("csr", "vector"),
             tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8),
             tt.make("sell_blocked", "ref", C=8, sigma=64, n_slabs=2),
             tt.make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8)]
    op = tt.SparseOperator.build(a, k=4, cache=tt.PlanCache(), candidates=cands,
                                 prune_factor=1e9, warmup=0, timed=1,
                                 device="cpu")
    assert op.plan.candidate.key() == "csr/vector"
    assert set(op.search_failures) == {c.key() for c in cands[1:]}
    assert all(isinstance(e, tt.NoSpMMTier) and "k > 1" in str(e)
               for e in op.search_failures.values())
    assert all(math.isinf(op.measurements[key]) for key in op.search_failures)
    X = np.random.default_rng(4).standard_normal((88, 4)).astype(np.float32)
    np.testing.assert_allclose((op @ torch.as_tensor(X)).numpy(), d @ X, atol=1e-4)


def test_search_on_cpu_records_a_failing_candidate(monkeypatch):
    """On the CPU any failure only disqualifies its candidate."""
    from repro_torch.kernels import ops as tops

    def broken(prep, x):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(tops, "sell_spmv", broken)
    a = csr_from_dense(_dense(5))
    cands = [tt.make("csr", "vector"),
             tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8)]
    op = tt.SparseOperator.build(a, cache=tt.PlanCache(), candidates=cands,
                                 prune_factor=1e9, warmup=0, timed=1, device="cpu")
    assert op.plan.candidate.key() == "csr/vector"
    assert list(op.search_failures) == [cands[1].key()]
    assert "injected" in str(op.search_failures[cands[1].key()])


@pytest.mark.parametrize("device,exc,skips", [
    ("cpu", RuntimeError("CUDA error 700"), True),
    ("cpu", tt.NoSpMMTier("k > 1"), True),
    ("cuda", tt.NoSpMMTier("k > 1"), True),
    ("cuda", RuntimeError("sell_spmv launch: CUDA error 1"), False),
    ("cuda", ValueError("a shape the kernel refuses"), False),
    ("cuda", torch.cuda.OutOfMemoryError("out of memory"), False),
])
def test_search_on_a_card_passes_over_only_the_missing_spmm_tier(device, exc, skips):
    from repro_torch.tune.operator import search_skips

    assert search_skips(exc, torch.device(device)) is skips


def test_build_search_plan_cache_round_trip(tmp_path):
    a = generate("cant", scale=1 / 256)
    path = tmp_path / "plans.json"
    op = tt.SparseOperator.build(a, cache=tt.PlanCache(path), warmup=0, timed=1,
                                 device="cpu")
    assert not op.from_cache and op.plan.backend == "cpu"
    assert op.plan.scale == [a.shape[0], a.shape[1], a.nnz]
    assert op.plan.features == tt.extract(a).to_dict()
    assert op.measurements and not op.search_failures
    # cuda candidates on a CPU device are priced out before timing
    assert not any("/cuda" in key for key in op.measurements)
    again = tt.SparseOperator.build(a, cache=tt.PlanCache(path), device="cpu")
    assert again.from_cache and again.plan.candidate == op.plan.candidate
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    np.testing.assert_array_equal((again @ x).numpy(), (op @ x).numpy())
    # another backend or scale is a miss; so is another PLAN_VERSION
    cache = tt.PlanCache(path)
    fp = tt.fingerprint(a)
    assert cache.get(fp, "spmv", 1, backend="cpu", scale=op.plan.scale) is not None
    assert cache.get(fp, "spmv", 1, backend="cuda:NVIDIA H100") is None
    assert cache.get(fp, "spmv", 1, backend="cpu", scale=[1, 2, 3]) is None
    raw = json.loads(path.read_text())
    for d in raw.values():
        d["version"] = tplan.PLAN_VERSION + 1
    path.write_text(json.dumps(raw))
    assert len(tt.PlanCache(path)) == 0
    # a torn file is quarantined, not fatal
    path.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        torn = tt.PlanCache(path)
    assert len(torn) == 0 and not path.exists()
    assert list(tmp_path.glob("plans.json.corrupt-*"))


def test_build_multi_and_default_cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "env.json"))
    monkeypatch.setattr(tplan, "_default", None)
    a = generate("cant", scale=1 / 256)
    table = tt.SparseOperator.build_multi(a, ks=(1, 4), warmup=0, timed=1,
                                          device="cpu")
    assert table[1].plan.kind == "spmv" and table[4].plan.kind == "spmm"
    assert (tmp_path / "env.json").exists()
    with pytest.raises(ValueError):
        tt.SparseOperator.build_multi(a, ks=(0,), device="cpu")


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    a = generate("cant", scale=1 / 512)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.SparseOperator.build(a, cache=tt.PlanCache())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"))


def test_time_fn_env_floor_and_racing(monkeypatch):
    calls = []

    def fn(x):
        calls.append(1)
        return x

    x = torch.zeros(4)
    monkeypatch.setenv("REPRO_TUNE_REPS", "7")
    time_fn(fn, x, warmup=0, timed=2)
    assert len(calls) == 1 + 7  # floored reps force one warmup
    monkeypatch.delenv("REPRO_TUNE_REPS")
    calls.clear()
    assert time_fn(fn, x, warmup=0, timed=5, abort_above=-1.0) == math.inf
    assert len(calls) == 1 + 2  # warmup, first rep, one confirmation


def test_prune_falls_back_deterministically_on_nonfinite_costs():
    cands = [tt.make("sell", "cuda"), tt.make("csr", "vector")]
    assert tt.prune({c: float("nan") for c in cands}) == [cands[1]]
    assert tt.prune({cands[0]: float("inf")}) == [cands[0]]
    assert tt.prune({cands[0]: 10.0, cands[1]: 1.0}, factor=2.0) == [cands[1]]
    zero = csr_from_dense(np.zeros((12, 16), np.float32))
    feats = tt.extract(zero)
    assert all(np.isfinite(v) for v in feats.to_dict().values())
    op = tt.SparseOperator.build(zero, cache=tt.PlanCache(), warmup=0, timed=1,
                                 device="cpu")
    np.testing.assert_array_equal((op @ torch.ones(16)).numpy(), np.zeros(12))


def test_prep_cache_memoizes_by_bytes():
    a = generate("cant", scale=1 / 512)
    c = tt.make("sell", "ref", C=8, sigma=64)
    p1 = tt.prepare_cached(a, c, device="cpu")
    assert tt.prepare_cached(a, c, device="cpu") is p1
    memo = tt.PrepCache(budget_bytes=1)
    first = memo.get_or_build(("a",), lambda: tt.prepare(a, c, device="cpu"))
    memo.get_or_build(("b",), lambda: tt.prepare(a, c, device="cpu"))
    assert len(memo) == 1 and memo.evictions == 1 and first is not None

"""Transfer tuning in the port against the JAX package's, on ``device="cpu"``.

The feature embedding, the nearest-neighbour prediction (leave-one-out over
suite matrices, the same plan records written into both packages' caches),
the byte model's argmin (equal on the CPU; on a CUDA device an exact tie
goes to the kernel), and ``build_predicted``: it never persists, records
its provenance, takes an exact cache hit first, and (a deviation from
``repro``) holds a predicted candidate to the float64 accuracy check before
it serves.  Inputs are numpy arrays from a seed; tolerances per row i are
1e-5 * (|A| |x|)_i."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.tune as jt
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.data.suite import generate as jgen
from repro.tune import plan as jplan
from repro.tune import predict as jpredict

import repro_torch.tune as tt
from repro_torch.core.formats import csr_from_dense
from repro_torch.data.suite import generate
from repro_torch.tune import plan as tplan
from repro_torch.tune import predict as tpredict
from repro_torch.tune.candidates import estimate_cost

torch.set_num_threads(1)

TOL = 1e-5
CPU = torch.device("cpu")
SUITE = ["shallow_water1", "2cubes_sphere", "scircuit", "mac_econ", "cop20k_A",
         "cant", "pdb1HYS", "webbase-1M", "hood", "pwtk", "crankseg_2", "torso1",
         "bmw3_2", "msdoor"]
SCALE = 1 / 64


def port_key(key: str) -> str:
    return key.replace("/pallas", "/cuda")


def pair(name, scale=SCALE):
    return jgen(name, scale=scale), generate(name, scale=scale)


def small(seed, m=96, n=96, density=0.08):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    return d, j_csr_from_dense(d), csr_from_dense(d)


def row_limit(a, x):
    a64 = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape)
    x64 = np.asarray(x, np.float64)
    return a64 @ x64, TOL * (abs(a64) @ np.abs(x64))


def assert_rowtol(y, a, x):
    y64, lim = row_limit(a, x)
    err = np.abs(np.asarray(y, np.float64) - y64)
    assert np.all(err <= lim), float((err - lim).max())


def port_plan(jp) -> tt.Plan:
    """The same record as a port plan (impl ``pallas`` -> ``cuda``; the port
    has no mesh shape)."""
    d = jp.to_json()
    d.pop("mesh_shape")
    d["impl"] = "cuda" if d["impl"] == "pallas" else d["impl"]
    d["version"] = tplan.PLAN_VERSION
    return tt.Plan.from_json(d)


def training_caches(names, kind, k):
    """One plan record per suite matrix, the same in both caches."""
    jcands = (
        [jt.make("csr", "vector"), jt.make("sell", "pallas", C=8, sigma=64, chunk_tile=8),
         jt.make("bcsr", "ref", block=(8, 8)), jt.make("merge", "scan", chunk=2048),
         jt.make("sell", "ref", C=8, sigma=1)]
        if kind == "spmv" else
        [jt.make("csr", "vector"), jt.make("bcsr", "pallas", block=(8, 8)),
         jt.make("sell", "ref", C=8, sigma=64), jt.make("merge", "scan", chunk=2048)]
    )
    jc, tc, mats = jt.PlanCache(), tt.PlanCache(), {}
    for i, name in enumerate(names):
        ja, ta = pair(name)
        mats[name] = (ja, ta)
        c = jcands[i % len(jcands)]
        jp = jplan.Plan(
            fingerprint=jt.fingerprint(ja), kind=kind, fmt=c.fmt, impl=c.impl,
            params={kp: list(v) if isinstance(v, tuple) else v for kp, v in c.params},
            est_cost=1.0, measured_s=1e-4, n_candidates=10, n_measured=3, k=k,
            backend="cpu", scale=[int(ja.shape[0]), int(ja.shape[1]), int(ja.nnz)],
            features=jt.extract(ja, k=k).to_dict(),
        )
        jc.put(jp)
        tc.put(port_plan(jp))
    return jc, tc, mats


# -- the embedding ----------------------------------------------------------
def test_feature_vector_matches_repro_and_refuses_missing_keys():
    assert tt.FEATURE_NAMES == jt.FEATURE_NAMES
    for name in ("cant", "webbase-1M", "torso1"):
        ja, ta = pair(name)
        for k in (1, 64):
            jv = jt.feature_vector(jt.extract(ja, k=k))
            tv = tt.feature_vector(tt.extract(ta, k=k))
            assert tv.shape == (len(tt.FEATURE_NAMES),)
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-12)
            # A persisted dict embeds like the live features.
            d = tt.extract(ta, k=k).to_dict()
            np.testing.assert_allclose(tt.feature_vector(d), tv, rtol=0, atol=1e-12)
    d = tt.extract(pair("cant")[1]).to_dict()
    d.pop("x_density")  # schema-additive: a missing density means a dense x
    assert tt.feature_vector(d)[-1] == 1.0
    d.pop("ucld")
    assert tt.feature_vector(d) is None and jt.feature_vector(d) is None
    assert tt.feature_vector({"m": "x"}) is None


# -- nearest-neighbour prediction ---------------------------------------------
@pytest.mark.parametrize("kind,k", [("spmv", 1), ("spmm", 4)])
def test_predict_leave_one_out_matches_repro(kind, k):
    jc, tc, mats = training_caches(SUITE, kind, k)
    outcomes = set()
    for radius in (jt.PREDICT_RADIUS, 0.0, 10.0):
        for name, (ja, ta) in mats.items():
            fp = jt.fingerprint(ja)
            assert tt.fingerprint(ta) == fp
            jp = jt.predict_candidate(ja, kind, k, jc, exclude={fp}, backend="cpu",
                                      radius=radius)
            tp = tt.predict_candidate(ta, kind, k, tc, exclude={fp}, backend="cpu",
                                      radius=radius, device="cpu")
            assert tp.source == jp.source, name
            assert tp.confident == jp.confident, name
            assert tp.candidate.key() == port_key(jp.candidate.key()), name
            assert tp.n_neighbors == jp.n_neighbors == len(SUITE) - 1
            assert math.isclose(tp.distance, jp.distance, rel_tol=0, abs_tol=1e-12)
            outcomes.add(tp.confident)
    assert outcomes == {True, False}  # both branches were compared
    # Another backend's plans do not transfer.
    ja, ta = mats["cant"]
    other = tt.predict_candidate(ta, kind, k, tc, backend="cuda:other card",
                                 device="cpu")
    assert other.source == "byte_model" and other.n_neighbors == 0
    assert other.distance == float("inf")


def test_byte_model_argmin_matches_repro_and_prefers_kernels_off_the_cpu():
    ties = 0
    for name in SUITE:
        ja, ta = pair(name)
        for kind, k in (("spmv", 1), ("spmm", 4), ("spmm", 64)):
            jf, tf_ = jt.extract(ja, k=k), tt.extract(ta, k=k)
            jpick = jpredict._byte_model_argmin(ja, jf, kind, k)
            tpick = tpredict._byte_model_argmin(ta, tf_, kind, k, device=CPU)
            assert tpick.key() == port_key(jpick.key()), (name, kind, k)
            # The card's view: no tensor is made, so no card is needed.
            cands = tt.enumerate_candidates(tf_, kind, k=k)
            costs = {c: estimate_cost(ta, c, tf_, k=k, on_cpu=False) for c in cands}
            best = min(costs.values())
            card = tpredict._byte_model_argmin(ta, tf_, kind, k,
                                               device=torch.device("cuda"))
            assert costs[card] == best
            if any(c.impl == "cuda" and costs[c] == best for c in cands):
                assert card.impl == "cuda", (name, kind, k, card.key())
                ties += 1
            order = tpredict.byte_model_order(ta, tf_, kind, k, device="cuda")
            assert order[0] == card and len(order) == len(cands)
    assert ties > 0  # the tie-break was exercised


def test_plans_skips_malformed_entries_and_old_entries_load():
    _, ja, ta = small(seed=40)
    cache = tt.PlanCache()
    op = tt.SparseOperator.build(ta, cache=cache, warmup=0, timed=1, device="cpu")
    assert [p.fingerprint for p in cache.plans()] == [op.plan.fingerprint]
    d = op.plan.to_json()
    d.pop("predicted_from")  # an entry written before the field existed
    cache._plans["old"] = d
    cache._plans["bad"] = {"version": tplan.PLAN_VERSION, "nonsense": 1}
    plans = cache.plans()
    assert len(plans) == 2 and all(p.predicted_from == "" for p in plans)
    assert tt.predict_candidate(ta, "spmv", 1, cache, device="cpu").n_neighbors == 2


# -- build_predicted ------------------------------------------------------------
def test_predict_transfers_within_radius_and_falls_back_beyond():
    cache = tt.PlanCache()
    _, _, a = small(seed=41)
    op = tt.SparseOperator.build(a, cache=cache, warmup=0, timed=1, device="cpu")
    _, _, b = small(seed=42)  # same family: close in feature space
    pred = tt.predict_candidate(b, "spmv", 1, cache, device="cpu")
    assert pred.confident and pred.source == tt.fingerprint(a)
    assert pred.candidate.key() == op.plan.candidate.key()
    alone = tt.predict_candidate(b, "spmv", 1, cache, exclude={tt.fingerprint(a)},
                                 device="cpu")
    assert not alone.confident and alone.source == "byte_model"
    far = tt.predict_candidate(b, "spmv", 1, cache, radius=0.0, device="cpu")
    assert not far.confident and far.source == "byte_model"
    assert np.isfinite(far.distance)


def test_build_predicted_never_persists_and_marks_provenance():
    cache = tt.PlanCache()
    d, _, a = small(seed=43)
    op = tt.SparseOperator.build_predicted(a, cache=cache, device="cpu")
    assert op.plan.predicted_from == "byte_model" and not op.from_cache
    assert op.plan.measured_s == 0.0 and op.plan.n_measured == 0
    assert op.predicted is not None and not op.predicted.confident
    assert op.check_s > 0.0 and not op.search_failures
    assert len(cache) == 0  # predicted plans never enter the cache
    x = np.random.default_rng(44).standard_normal(a.shape[1]).astype(np.float32)
    assert_rowtol((op @ torch.as_tensor(x)).numpy(), a, x)

    measured = tt.SparseOperator.build(a, cache=cache, warmup=0, timed=1, device="cpu")
    hit = tt.SparseOperator.build_predicted(a, cache=cache, device="cpu")
    assert hit.from_cache and hit.predicted is None
    assert hit.plan.candidate == measured.plan.candidate
    _, _, b = small(seed=45)
    sib = tt.SparseOperator.build_predicted(b, cache=cache, device="cpu")
    assert sib.plan.predicted_from == tt.fingerprint(a)
    assert sib.predicted is not None and sib.predicted.confident
    assert len(cache) == 1  # still only the measured plan
    for k in (4, 16):
        opk = tt.SparseOperator.build_predicted(b, k=k, cache=cache, device="cpu")
        assert opk.plan.k == k and opk.plan.kind == "spmm"
    assert len(cache) == 1


def test_build_predicted_matches_repro_on_the_same_training_cache():
    jc, tc, mats = training_caches(SUITE[:8], "spmv", 1)
    for name in ("hood", "pwtk", "msdoor"):
        ja, ta = pair(name)
        jop = jt.SparseOperator.build_predicted(ja, cache=jc)
        top = tt.SparseOperator.build_predicted(ta, cache=tc, device="cpu")
        assert top.plan.predicted_from == jop.plan.predicted_from
        assert top.plan.candidate.key() == port_key(jop.plan.candidate.key())
        x = np.random.default_rng(7).standard_normal(ta.shape[1]).astype(np.float32)
        yt = (top @ torch.as_tensor(x)).numpy()
        yj = np.asarray(jop @ jnp.asarray(x))
        assert_rowtol(yt, ta, x)
        assert_rowtol(yj, ta, x)


def test_cuda_build_predicted_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CPU-only refusal cannot be shown")
    _, _, a = small(seed=46)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.SparseOperator.build_predicted(a, cache=tt.PlanCache())


# -- the accuracy check on a predicted plan (merge breaking the limit) --------
def merge_breaker(seed=47, m=256, n=256, big_rows=4):
    """A few huge rows ahead of many tiny ones: merge's global prefix sums
    reach ~1e6, so a tiny row (a difference of two prefix sums) loses every
    digit.  The neighbour differs by one stored entry (another fingerprint,
    near-identical features)."""
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < 0.05) * rng.uniform(0.5, 1.0, (m, n))).astype(np.float32)
    d[:big_rows] *= 1e6
    d[big_rows:] *= 1e-3
    nb = d.copy()
    i, j = int(np.flatnonzero(d[m // 2] == 0)[0]), m // 2
    nb[j, i] = 1e-3
    return d, nb


def test_predicted_merge_breaks_repro_and_the_port_passes_over_it():
    d, nb = merge_breaker()
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    jb, tb = j_csr_from_dense(nb), csr_from_dense(nb)
    merge = jt.make("merge", "scan", chunk=2048)
    jp = jplan.Plan(
        fingerprint=jt.fingerprint(jb), kind="spmv", fmt="merge", impl="scan",
        params={"chunk": 2048}, est_cost=1.0, measured_s=1e-4, n_candidates=10,
        n_measured=3, k=1, backend="cpu",
        scale=[int(jb.shape[0]), int(jb.shape[1]), int(jb.nnz)],
        features=jt.extract(jb).to_dict(),
    )
    jc, tc = jt.PlanCache(), tt.PlanCache()
    jc.put(jp)
    tc.put(port_plan(jp))
    # Both packages predict merge: a confident transfer from the neighbour.
    for pred in (jt.predict_candidate(ja, "spmv", 1, jc),
                 tt.predict_candidate(ta, "spmv", 1, tc, device="cpu")):
        assert pred.confident and pred.source == jt.fingerprint(jb)
        assert pred.candidate.key() == merge.key()
    x = np.random.default_rng(48).standard_normal(d.shape[1]).astype(np.float32)
    y64, lim = row_limit(ta, x)

    jop = jt.SparseOperator.build_predicted(ja, cache=jc)
    assert jop.plan.candidate.key() == merge.key()  # repro serves merge...
    yj = np.asarray(jop @ jnp.asarray(x), np.float64)
    assert int((np.abs(yj - y64) > lim).sum()) > 0  # ...and breaks the limit

    top = tt.SparseOperator.build_predicted(ta, cache=tc, device="cpu")
    assert merge.key() in top.search_failures
    assert isinstance(top.search_failures[merge.key()], tt.InaccurateTier)
    assert top.plan.fmt != "merge"
    assert top.plan.predicted_from == "byte_model" and not top.predicted.confident
    assert_rowtol((top @ torch.as_tensor(x)).numpy(), ta, x)
    assert len(tc) == 1  # nothing persisted


def test_a_failing_kernel_ends_a_predicted_build_under_the_cards_rule(monkeypatch):
    """Under the card's rule (``search_skips`` on a CUDA device) a plain
    tier that fails the check is passed over, and a ``cuda`` candidate
    that fails it ends the build instead of handing the bucket to a plain
    tier."""
    from repro_torch.tune import operator as top

    card_rule = top.search_skips
    monkeypatch.setattr(top, "search_skips", lambda exc, device, stage="run":
                        card_rule(exc, torch.device("cuda"), stage=stage))
    _, _, a = small(seed=50)
    kernel = tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8)
    cache = tt.PlanCache()
    cache.put(tt.Plan(fingerprint="neighbour", kind="spmv", fmt=kernel.fmt,
                      impl=kernel.impl, params=dict(kernel.params), est_cost=1.0,
                      measured_s=1e-4, n_candidates=1, n_measured=1, k=1,
                      backend="cpu", scale=[96, 96, a.nnz],
                      features=tt.extract(a).to_dict()))

    def refuse(cand, y, ref):
        raise tt.InaccurateTier(f"{cand.key()}: refused", kernel=cand.impl == "cuda")

    monkeypatch.setattr(top, "check_accuracy", refuse)
    with pytest.raises(RuntimeError, match="predicted candidate sell/cuda"):
        tt.SparseOperator.build_predicted(a, cache=cache, device="cpu")
    # With no neighbour the plain tiers first in byte-model order are passed
    # over; the first kernel in that order ends the build.
    with pytest.raises(RuntimeError, match=r"predicted candidate \w+/cuda"):
        tt.SparseOperator.build_predicted(a, cache=tt.PlanCache(), device="cpu")


def test_prep_memo_counts_hits_misses_and_clears():
    _, _, a = small(seed=49)
    memo = tt.PrepCache()
    c = tt.make("csr", "vector")
    p1 = memo.get_or_build(("fp", 1), lambda: tt.prepare(a, c, device=CPU))
    p2 = memo.get_or_build(("fp", 1), lambda: tt.prepare(a, c, device=CPU))
    assert p1 is p2
    s = memo.stats()
    assert set(s) == set(jt.PrepCache().stats())
    assert (s["hits"], s["misses"], s["entries"]) == (1, 1, 1)
    memo.clear()
    assert memo.stats()["entries"] == 0 and memo.stats()["resident_bytes"] == 0
    assert set(tt.prep_memo_stats()) == set(jt.prep_memo_stats())

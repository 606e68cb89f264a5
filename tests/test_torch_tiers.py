"""The port's remaining plain tiers and the search space against ``repro``:
the merge tier (held to its own limit: a row is a difference of global
prefix sums), ``csr/scalar``, ``symmetrize``/``spd_shift``, the orderings
and ``CSRMatrix.permuted``, the candidate key sets and byte-model
estimates with and without RCM variants, and a build that searches them.

The merge limit per row i is 1e-5 (|A| |x|)_i + 8 * 2**-24 * max|P|, with
max|P| the largest float64 prefix sum of the products in CSR order; every
other tier is held to 1e-5 (|A| |x|)_i."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core import reorder as jreorder
from repro.core.spmv import csr_prepare as j_csr_prepare
from repro.core.spmv import spd_shift as j_spd_shift
from repro.core.spmv import spmv_csr_scalar as j_spmv_csr_scalar
from repro.core.spmv import symmetrize as j_symmetrize
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.data.suite import generate as jgenerate
from repro.kernels import merge_spmv as jmerge

import repro_torch.tune as tt
from repro_torch import interop
from repro_torch.core import reorder as treorder
from repro_torch.core import spmv as tspmv
from repro_torch.core.formats import csr_from_dense
from repro_torch.data.suite import generate
from repro_torch.kernels import merge_spmv as tmerge

torch.set_num_threads(1)

TOL = 1e-5
MERGE_ULPS = 8


def rand_dense(seed, m=300, n=280, density=0.08, empty_rows=()):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    d[list(empty_rows)] = 0.0
    return d


def rand_x(seed, n, k):
    shape = (n,) if k == 1 else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def limits(d, x, merge=False):
    """Per-row limit: 1e-5 (|A| |x|)_i, plus the merge term when asked."""
    x64 = np.asarray(x, np.float64)
    lim = TOL * (np.abs(d.astype(np.float64)) @ np.abs(x64))
    if merge:
        rows, cols = np.nonzero(d)
        x2 = x64.reshape(d.shape[1], -1)
        prods = d[rows, cols].astype(np.float64)[:, None] * x2[cols]
        pmax = np.abs(np.cumsum(prods, axis=0)).max(axis=0, initial=0.0)
        lim = lim + MERGE_ULPS * 2.0**-24 * pmax.reshape(x64.shape[1:])
    return lim


def assert_within(got, want, lim, what=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.shape == lim.shape, what
    assert np.all(err <= lim), (what, float((err - lim).max()))


# -- merge -------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [2048, 16384])
@pytest.mark.parametrize("k", [1, 4])
def test_merge_matches_repro_and_oracle_within_its_limit(chunk, k):
    d = rand_dense(1)  # zero-mean values, ~6 700 nonzeros: several chunks
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    x = rand_x(2, d.shape[1], k)
    want = d.astype(np.float64) @ x.astype(np.float64)
    lim = limits(d, x, merge=True)
    jprep = jmerge.merge_prepare(ja, chunk)
    tprep = tmerge.merge_prepare(ta, chunk, device="cpu")
    for key in ("indices", "data", "start", "end"):
        np.testing.assert_array_equal(tprep[key].numpy(), np.asarray(jprep[key]))
    assert (tprep["chunk"], tprep["n_chunks"]) == (jprep["chunk"], jprep["n_chunks"])
    jfn = jmerge.merge_spmv if k == 1 else jmerge.merge_spmm
    tfn = tmerge.merge_spmv if k == 1 else tmerge.merge_spmm
    ref = np.asarray(jfn(jprep, jnp.asarray(x)))
    got = tfn(tprep, torch.as_tensor(x)).numpy()
    # The same prepared operands, carried across from repro.
    carried = interop.prep_from_arrays("merge", *interop.split(jprep), "cpu")
    got_carried = tfn(carried, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got_carried, got)
    for what, other in (("repro", ref), ("f64", want)):
        assert_within(got, other, lim, f"merge chunk={chunk} k={k} vs {what}")
    # Through the facade, pinned.
    cand = tt.make("merge", "scan", chunk=chunk)
    op = tt.SparseOperator.from_candidate(ta, cand, k=None if k == 1 else k,
                                          device="cpu")
    assert_within((op @ torch.as_tensor(x)).numpy(), want, lim, "pinned merge")


@pytest.mark.parametrize("module", [jmerge, tmerge], ids=["repro", "port"])
def test_merge_prepare_refuses_int32_overflow(module):
    fake = types.SimpleNamespace(
        nnz=4, shape=(1, 4), indptr=np.array([0, 2**31], np.int64),
        indices=np.zeros(4, np.int32), data=np.zeros(4, np.float32),
    )
    kw = {} if module is jmerge else {"device": "cpu"}
    with pytest.raises(OverflowError, match="int32"):
        module.merge_prepare(fake, 2048, **kw)


# -- csr/scalar ---------------------------------------------------------------
@pytest.mark.parametrize("shape,empty_rows", [((96, 80), (0, 5, 6, 95)), ((0, 7), ()),
                                              ((5, 9), (0, 1, 2, 3, 4))])
def test_csr_scalar_matches_repro(shape, empty_rows):
    m, n = shape
    d = rand_dense(3, m, n, 0.1, empty_rows) if m else np.zeros(shape, np.float32)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    x = rand_x(4, n, 1)
    ref = np.asarray(j_spmv_csr_scalar(j_csr_prepare(ja), jnp.asarray(x),
                                           n_rows=m))
    got = tspmv.spmv_csr_scalar(tspmv.csr_scalar_prepare(ta, "cpu"),
                                torch.as_tensor(x), n_rows=m).numpy()
    lim = limits(d, x)
    assert_within(got, ref, lim, "scalar vs repro")
    assert_within(got, d.astype(np.float64) @ x.astype(np.float64), lim, "scalar vs f64")
    assert np.all(got[list(empty_rows)] == 0.0)
    cand = tt.make("csr", "scalar")
    op = tt.SparseOperator.from_candidate(ta, cand, device="cpu")
    np.testing.assert_array_equal((op @ torch.as_tensor(x)).numpy(), got)
    if m:
        with pytest.raises(ValueError, match="SpMM"):
            tt.SparseOperator.from_candidate(ta, cand, k=4, device="cpu")


# -- solver workloads ---------------------------------------------------------
def test_symmetrize_and_spd_shift_equal_repro():
    d = rand_dense(5, 64, 64, 0.1)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    for jfn, tfn in ((j_symmetrize, tspmv.symmetrize),
                     (j_spd_shift, tspmv.spd_shift)):
        jb, tb = jfn(ja), tfn(ta)
        assert tb.shape == jb.shape
        for key in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(tb, key), getattr(jb, key))
    s = tspmv.spd_shift(ta)
    dense = np.zeros(s.shape, np.float64)
    rows = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
    dense[rows, s.indices] = s.data
    np.testing.assert_allclose(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0


# -- orderings ----------------------------------------------------------------
@pytest.mark.parametrize("name", ["cant", "scircuit", "webbase-1M"])
def test_orderings_equal_repro_and_permuted_round_trips(name):
    ja, ta = jgenerate(name, scale=1 / 256), generate(name, scale=1 / 256)
    perm = treorder.rcm(ta)
    np.testing.assert_array_equal(perm, jreorder.rcm(ja))
    np.testing.assert_array_equal(treorder.degree_order(ta), jreorder.degree_order(ja))
    np.testing.assert_array_equal(treorder.random_order(ta, 7),
                                  jreorder.random_order(ja, 7))
    for p in (perm, treorder.random_order(ta, 1)):
        jp, tp = ja.permuted(p), ta.permuted(p)
        for key in ("indptr", "indices", "data"):
            got, want = getattr(tp, key), getattr(jp, key)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        back = tp.permuted(np.argsort(p))
        for key in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(back, key), getattr(ta, key))
    with pytest.raises(ValueError, match="square"):
        treorder.rcm(csr_from_dense(np.ones((3, 4), np.float32)))


# -- the search space ---------------------------------------------------------
@pytest.mark.parametrize("kind,k", [("spmv", 1), ("spmm", 4), ("spmspv", 1)])
@pytest.mark.parametrize("reorders", [(), ("rcm",)])
def test_candidate_key_sets_and_costs_equal_repro(kind, k, reorders):
    ja, ta = jgenerate("cant", scale=1 / 128), generate("cant", scale=1 / 128)
    x_nnz = 40 if kind == "spmspv" else None
    jfe = jt.extract(ja, k=k, x_nnz=x_nnz)
    tfe = tt.extract(ta, k=k, x_nnz=x_nnz)
    jc = jt.enumerate_candidates(jfe, kind, k=k, reorders=reorders)
    tc = tt.enumerate_candidates(tfe, kind, k=k, reorders=reorders)
    keys = [c.key() for c in tc]
    assert keys == [c.key().replace("/pallas", "/cuda") for c in jc]
    assert any(c.fmt == "merge" for c in tc)
    assert any(c.impl == "scalar" for c in tc) is (kind == "spmv")
    assert any("reorder=rcm" in key for key in keys) is (bool(reorders) and kind != "spmspv")
    by_key = {c.key().replace("/pallas", "/cuda"): c for c in jc}
    sparse = kind == "spmspv"
    for c in tc:
        for on_cpu in (True, False):
            assert tt.estimate_cost(ta, c, tfe, k=k, on_cpu=on_cpu, sparse_rhs=sparse) == (
                jt.estimate_cost(ja, by_key[c.key()], jfe, k=k, on_cpu=on_cpu,
                                 sparse_rhs=sparse)
            ), (c.key(), on_cpu)
    method, base = tt.candidates.split_reorder(tc[-1])
    assert (method is not None) is (bool(reorders) and kind != "spmspv")
    assert "reorder" not in base.param_dict


@pytest.mark.parametrize("key", ["csr/vector", "sell/ref", "sell/cuda", "bcsr/cuda",
                                 "merge/scan"])
def test_reordered_candidates_match_repro(key):
    d = rand_dense(6, 120, 120, 0.06)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    params = {"sell/ref": dict(C=8, sigma=64),
              "sell/cuda": dict(C=8, sigma=64, chunk_tile=8),
              "bcsr/cuda": dict(block=(8, 8)), "merge/scan": dict(chunk=2048)}.get(key, {})
    fmt, impl = key.split("/")
    cand = tt.make(fmt, impl, reorder="rcm", **params)
    jcand = jt.make(fmt, impl.replace("cuda", "pallas"), reorder="rcm", **params)
    x = rand_x(7, 120, 1)
    op = tt.SparseOperator.from_candidate(ta, cand, device="cpu")
    got = (op @ torch.as_tensor(x)).numpy()
    jop = jt.SparseOperator.from_candidate(ja, jcand)
    ref = np.asarray(jop @ jnp.asarray(x))
    np.testing.assert_array_equal(op._prep["perm"].numpy(), jop._prep["perm"])
    lim = limits(d, x, merge=fmt == "merge")
    for what, other in (("repro", ref), ("f64", d.astype(np.float64) @ x)):
        assert_within(got, other, lim, f"{key} reordered vs {what}")
    # repro's prepared reorder dict, carried across, serves the same.
    inner_fmt = {"csr": None, "sell": "sell", "bcsr": "bcsr", "merge": "merge"}[fmt]
    if inner_fmt is not None:
        carried = interop.prep_from_arrays(f"reorder:{inner_fmt}",
                                           *interop.split(jop._prep), "cpu")
        run = tt.runner(carried["matrix"], cand, carried)
        np.testing.assert_array_equal(run(torch.as_tensor(x)).numpy(), got)


def test_build_include_reorder_serves_within_tolerance():
    base = generate("cant", scale=1 / 128)
    a = base.permuted(treorder.random_order(base, 0))  # scrambled
    d = np.zeros(a.shape, np.float32)
    d[np.repeat(np.arange(a.shape[0]), np.diff(a.indptr)), a.indices] = a.data
    op = tt.SparseOperator.build(a, cache=tt.PlanCache(), include_reorder=True,
                                 warmup=0, timed=1, device="cpu")
    assert any("reorder=rcm" in key for key in op.measurements)
    assert op.plan.n_candidates == len(tt.enumerate_candidates(
        tt.extract(a), "spmv", reorders=("rcm",)))
    x = rand_x(8, a.shape[1], 1)
    lim = limits(d, x, merge=op.plan.fmt == "merge")
    assert_within((op @ torch.as_tensor(x)).numpy(), d.astype(np.float64) @ x, lim,
                  op.plan.candidate.key())


# -- the search's accuracy check ---------------------------------------------
def test_search_passes_over_a_merge_tier_that_breaks_the_row_limit():
    a = generate("webbase-1M", scale=1 / 16)
    n = a.shape[1]
    cands = [tt.make("merge", "scan", chunk=2048), tt.make("csr", "vector")]
    feats = tt.extract(a, x_nnz=n // 4)
    costs = [tt.estimate_cost(a, c, feats, on_cpu=True, sparse_rhs=True) for c in cands]
    assert costs[0] < costs[1]  # merge is timed first, so it is checked
    op = tt.SparseOperator.build(a, x_nnz=n // 4, cache=tt.PlanCache(), candidates=cands,
                                 prune_factor=1e9, warmup=0, timed=1, device="cpu")
    key = cands[0].key()
    assert op.plan.fmt != "merge"
    assert isinstance(op.search_failures.get(key), tt.InaccurateTier), op.search_failures
    assert op.measurements[key] == float("inf")


def test_accuracy_check_limits_and_what_a_card_does_with_them():
    from repro_torch.tune.operator import check_accuracy, probe_reference, search_skips

    d = rand_dense(9, 64, 48, 0.2)
    a = csr_from_dense(d)
    x = torch.as_tensor(rand_x(10, 48, 3))
    ref = probe_reference(a, x, device="cpu")
    y64 = d.astype(np.float64) @ x.numpy().astype(np.float64)
    np.testing.assert_allclose(ref[0].numpy(), y64, rtol=1e-12, atol=1e-12)
    cand = tt.make("csr", "vector")
    for run in ("csr/vector", "sell/ref"):  # float32 row sums always pass
        c = tt.make(*run.split("/"), **({"C": 8, "sigma": 64} if "sell" in run else {}))
        y = tt.SparseOperator.from_candidate(a, c, k=3, device="cpu") @ x
        check_accuracy(c, y, ref)
    bad = ref[0].float().clone()
    bad[5, 1] = float("nan")
    with pytest.raises(tt.InaccurateTier, match="1 of 192"):
        check_accuracy(cand, bad, ref)
    bad = ref[0].float() + 1e-3 * ref[1].float() / 1e-5
    with pytest.raises(tt.InaccurateTier):
        check_accuracy(cand, bad, ref)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    plain, kernel = tt.InaccurateTier("x", kernel=False), tt.InaccurateTier("x", kernel=True)
    assert search_skips(plain, card) and not search_skips(kernel, card)
    assert search_skips(kernel, cpu) and search_skips(plain, cpu)

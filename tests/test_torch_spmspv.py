"""The port's sparse-RHS tier against the JAX package's.

Same seeded numpy inputs on both sides: the CSC prepare, the work-bucket
ladder and the product expansion must equal ``repro``'s bit for bit, the
validation texts must match, the host plan of the fused expand-and-scatter
kernel (offsets, true total, each block's first slot) must imply exactly
``repro``'s expanded stream, and the fused wrapper (its plain version on
the CPU) must agree with ``repro``'s expansion + Pallas scatter in
interpret mode (``spmspv_pallas_fn``) on the same padded x, carried across
with ``repro_torch.interop``.  Tolerance
per row i: |port - repro| <= 1e-5 * (|A| |x|)_i, since only the summation
order differs.  Then the tuner (enumeration, byte model, every candidate
through ``from_candidate(x_nnz=)`` and ``op @ (idx, val)``, the plan cache)
against ``repro``'s and a float64 oracle.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.kernels import spmspv as jsp

import repro_torch.tune as tt
from repro_torch import interop
from repro_torch.core.formats import csr_from_dense
from repro_torch.kernels import _build
from repro_torch.kernels import spmspv as tsp

# Small shapes: one torch thread keeps the parallel workers from
# oversubscribing the CPU under timing-sensitive neighbours.
torch.set_num_threads(1)

TOL = 1e-5


def rand_dense(seed, m=100, n=80, density=0.1):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    d[m // 3] = 0.0  # an empty row
    d[:, n // 2] = 0.0  # an empty column
    d[:, 3] = rng.standard_normal(m).astype(np.float32)  # one dense column
    return d


def sparse_x(seed, n, nx):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=nx, replace=False)).astype(np.int64)
    val = rng.standard_normal(nx).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[idx] = val
    return idx, val, x


def assert_rowtol(got, ref, d, x, what="", slack=0.0):
    """|got - ref| <= 1e-5 (|A| |x|)_i + ``slack`` per row (``slack`` is the
    merge tier's prefix-sum term, 0 for every other tier)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(d.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(got - ref)
    assert got.shape == ref.shape, what
    assert np.all(err <= TOL * scale + slack), (
        what, float((err - TOL * scale - slack).max()))


def carried(jprep):
    return interop.prep_from_arrays("spmspv", *interop.split(jprep), "cpu")


# ---------------------------------------------------------------------------
# Host pieces: prepare, ladder, validation, expansion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,density", [((100, 80), 0.1), ((40, 64), 0.0)])
def test_prepare_equals_repro_bit_for_bit(shape, density):
    d = rand_dense(1, *shape, density=density) if density else np.zeros(shape, np.float32)
    jprep = jsp.spmspv_prepare(j_csr_from_dense(d))
    own = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    for prep in (own, carried(jprep)):
        for key in ("col_start", "col_len", "rows", "vals"):
            np.testing.assert_array_equal(prep[key].numpy(), np.asarray(jprep[key]),
                                          err_msg=key)
            assert prep[key].dtype == (torch.float32 if key == "vals" else torch.int32)
        np.testing.assert_array_equal(prep["col_len_np"], jprep["col_len_np"])
        assert prep["shape"] == jprep["shape"] and prep["nnz"] == jprep["nnz"]
    assert own["col_len"][-1] == 0  # the sentinel column is empty


def test_prepare_refuses_int32_overflow():
    huge = types.SimpleNamespace(shape=(4, 4), indptr=np.array([0, 2**31]))
    with pytest.raises(OverflowError, match="int32"):
        tsp.spmspv_prepare(huge, device="cpu")


def test_work_bucket_ladder_equals_repro():
    assert (tsp.WORK_BUCKET_BASE, tsp.WORK_BUCKET_GROWTH) == (
        jsp.WORK_BUCKET_BASE, jsp.WORK_BUCKET_GROWTH)
    for nnz in (0, 1, 255, 256, 257, 5000, 70_000, 3_838_752):
        for total in (0, 1, 255, 256, 257, 1024, 1025, 4097, 65_536, nnz, 2 * nnz):
            assert tsp.work_bucket(total, nnz) == jsp.work_bucket(total, nnz)


@pytest.mark.parametrize("indices,values,match", [
    (np.array([0, 80]), np.ones(2, np.float32), "outside"),
    (np.array([-1, 2]), np.ones(2, np.float32), "outside"),
    (np.array([5, 2]), np.ones(2, np.float32), "strictly increasing"),
    (np.array([3, 3]), np.ones(2, np.float32), "strictly increasing"),
    (np.array([0.0, 1.0]), np.ones(2, np.float32), "integer"),
    (np.array([[0, 1]]), np.ones(2, np.float32), "1-D"),
    (np.array([0, 1]), np.ones(3, np.float32), "same length"),
])
def test_validation_texts_equal_repro(indices, values, match):
    with pytest.raises(ValueError, match=match) as tex:
        tsp.validate_sparse_rhs(indices, values, 80)
    with pytest.raises(ValueError) as jex:
        jsp.validate_sparse_rhs(indices, values, 80)
    assert str(tex.value) == str(jex.value)


def test_pad_refuses_more_nonzeros_than_the_bucket_as_repro():
    with pytest.raises(ValueError) as tex:
        tsp.pad_sparse_rhs(np.arange(5), np.ones(5, np.float32), 4, 80)
    with pytest.raises(ValueError) as jex:
        jsp.pad_sparse_rhs(np.arange(5), np.ones(5, np.float32), 4, 80)
    assert str(tex.value) == str(jex.value)


@pytest.mark.parametrize("nx,bucket", [(6, 6), (6, 16), (30, 32), (0, 4)])
def test_expand_products_equal_repro_bit_for_bit(nx, bucket):
    d = rand_dense(2)
    a = csr_from_dense(d)
    jprep = jsp.spmspv_prepare(j_csr_from_dense(d))
    tprep = tsp.spmspv_prepare(a, device="cpu")
    idx, val, _ = sparse_x(3, 80, nx)
    xi, xv = tsp.pad_sparse_rhs(idx, val, bucket, 80)
    jxi, jxv = jsp.pad_sparse_rhs(idx, val, bucket, 80)
    np.testing.assert_array_equal(xi, jxi)
    np.testing.assert_array_equal(xv, jxv)
    total = int(tprep["col_len_np"][xi].sum())
    G = tsp.work_bucket(total, a.nnz)
    jrows, jprods = jsp.expand_products(jprep, jnp.asarray(jxi), jnp.asarray(jxv), G)
    rows, prods = tsp.expand_products(tprep, torch.as_tensor(xi), torch.as_tensor(xv), G)
    assert rows.dtype == torch.int32 and prods.dtype == torch.float32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(prods.numpy().view(np.int32),
                                  np.asarray(jprods).view(np.int32))
    assert not prods[total:].any() and not rows[total:].any()  # (row 0, value 0)


# ---------------------------------------------------------------------------
# The fused expand-and-scatter (spmspv_scatter_pallas + its expansion)
# ---------------------------------------------------------------------------
def hub_dense(seed, m=1500, n=64):
    """A column of m entries (a hub spanning many blocks), two empty
    columns between touched ones, and a sprinkle elsewhere."""
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < 0.02) * rng.standard_normal((m, n))).astype(np.float32)
    d[:, 7] = rng.standard_normal(m).astype(np.float32)
    d[:, 20:22] = 0.0
    return d


def plan_case(case):
    """(dense A, idx, val, slab) for the host-plan and parity cases."""
    if case == "hub":
        d = hub_dense(20)
        return d, np.array([3, 7, 20, 21, 40]), np.float32([0.5, -2.0, 1.0, 3.0, 0.25]), 128
    d = rand_dense(21, m=120, n=96, density=0.12)
    if case == "empty_x":
        return d, np.zeros(0, np.int64), np.zeros(0, np.float32), 4096
    if case == "empty_columns":
        d[:, 10:60] = 0.0  # every touched column in between is empty
        idx = np.array([2, 10, 11, 30, 59, 60, 95])
        return d, idx, np.linspace(-1, 1, idx.size).astype(np.float32), 4096
    idx, val, _ = sparse_x(22, 96, 40)
    return d, idx, val, 256


def emulate_fused_walk(prep, xi, xv, offs, first, tile):
    """The kernel's indexing in numpy: block b walks products
    [b*tile, (b+1)*tile) and finds each one's slot between first[b] and
    first[b+1].  Returns the (rows, products) stream it adds, in t order."""
    col_start, rows = prep["col_start"].numpy(), prep["rows"].numpy()
    vals, total = prep["vals"].numpy(), int(offs[-1])
    out_rows, out_prods = [], []
    for b in range(first.size - 1):
        lo, hi = int(first[b]), int(first[b + 1])
        for t in range(b * tile, min(total, (b + 1) * tile)):
            s = lo + int(np.searchsorted(offs[lo:hi + 1], t, side="right")) - 1
            assert lo <= s <= hi and offs[s] <= t < offs[s + 1]
            src = col_start[xi[s]] + t - offs[s]
            out_rows.append(rows[src])
            out_prods.append(np.float32(vals[src]) * np.float32(xv[s]))
    return np.array(out_rows, np.int32), np.array(out_prods, np.float32)


@pytest.mark.parametrize("case", ["empty_x", "all_sentinel", "empty_columns", "hub",
                                  "random"])
def test_host_plan_equals_what_repro_expansion_implies(case):
    """offs, T and each block's first slot equal what repro's expansion
    implies, and the kernel's walk over them adds exactly repro's stream."""
    d, idx, val, slab = plan_case("empty_x" if case == "all_sentinel" else case)
    n = d.shape[1]
    bucket = 8 if case == "all_sentinel" else max(idx.size, 1) + 3
    jprep = jsp.spmspv_prepare(j_csr_from_dense(d))
    prep = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    xi, xv = tsp.pad_sparse_rhs(idx, val, bucket, n)
    offs = tsp.touched_offsets(prep["col_len_np"], xi)
    want = np.concatenate([[0], np.cumsum(np.asarray(jprep["col_len_np"])[xi])])
    np.testing.assert_array_equal(offs, want)
    assert offs.dtype == np.int32
    total = int(offs[-1])
    tile, first = tsp.scatter_plan(offs, slab)
    n_blocks = -(-total // tile)
    assert first.shape == (n_blocks + 1,) and first.dtype == np.int32
    assert 1 <= tile <= min(slab, tsp.SCATTER_THREADS * tsp.SCATTER_MAX_PER_THREAD)
    t = np.arange(total)
    slot = np.searchsorted(offs, t, side="right") - 1  # the expansion's slot map
    if total:
        np.testing.assert_array_equal(first[:-1], slot[::tile])
        assert first[-1] == slot[-1]
        assert np.all(np.diff(first) >= 0)
    G = jsp.work_bucket(total, jprep["nnz"])
    jrows, jprods = jsp.expand_products(jprep, jnp.asarray(xi), jnp.asarray(xv), G)
    rows, prods = emulate_fused_walk(prep, xi, xv, offs, first, tile)
    np.testing.assert_array_equal(rows, np.asarray(jrows)[:total])
    np.testing.assert_array_equal(prods.view(np.int32),
                                  np.asarray(jprods)[:total].view(np.int32))
    if case == "hub":
        assert n_blocks >= 8 and np.sum(first[:-1] == first[1]) >= 6  # one hub
    if case == "empty_columns":
        assert np.sum(prep["col_len_np"][xi] == 0) >= 3


@pytest.mark.parametrize("case,nx", [("random", 6), ("random", 40), ("hub", 5),
                                     ("empty_columns", 7)])
def test_scatter_matches_pallas_scatter_on_repro_streams(case, nx):
    """The fused wrapper (its plain version on the CPU) against repro's
    spmspv_pallas_fn in interpret mode on the same padded (xi, xv)."""
    d, idx, val, slab = plan_case(case)
    if case == "random":
        idx, val, _ = sparse_x(5, d.shape[1], nx)
    m, n = d.shape
    x = np.zeros(n, np.float32)
    x[idx] = val
    jprep = jsp.spmspv_prepare(j_csr_from_dense(d))
    jxi, jxv = jsp.pad_sparse_rhs(idx, val, nx, n)
    total = int(jprep["col_len_np"][jxi].sum())
    G = jsp.work_bucket(total, jprep["nnz"])
    y_pallas = np.asarray(jsp.spmspv_pallas_fn(jprep, G, slab, True)(
        jnp.asarray(jxi), jnp.asarray(jxv)))
    prep = carried(jprep)
    _build.reset_launches()
    op = tsp.stage_sparse(prep, jxi, jxv, slab=slab)
    assert op["total"] == total
    y_port = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["offs"], op["first"],
                                total=total, tile=op["tile"]).numpy()
    assert sum(_build.LAUNCHES.values()) == 0  # the plain version ran
    assert_rowtol(y_port, y_pallas, d, x, "port vs pallas")
    assert_rowtol(y_port, d.astype(np.float64) @ x, d, x, "port vs f64")
    # the bound runner gives the same y through either impl
    for impl in ("cuda", "ref"):
        fn = tsp.spmspv_bind(prep, nx, impl=impl, slab=slab)
        np.testing.assert_array_equal(fn((jxi, jxv)).numpy(), y_port)


def test_empty_x_and_empty_matrix_give_exact_zeros():
    d = rand_dense(6, m=24, n=32, density=0.2)
    for dd in (d, np.zeros_like(d)):
        prep = tsp.spmspv_prepare(csr_from_dense(dd), device="cpu")
        xi, xv = tsp.pad_sparse_rhs(np.zeros(0, np.int64), np.zeros(0, np.float32),
                                    6, 32)
        for impl in ("ref", "cuda"):
            y = tsp.spmspv_bind(prep, 6, impl=impl)((xi, xv))
            assert y.shape == (24,) and y.dtype == torch.float32
            np.testing.assert_array_equal(y.numpy(), np.zeros(24, np.float32))
        op = tsp.stage_sparse(prep, xi, xv)
        assert op["total"] == 0 and op["first"].shape == (1,)
        empty = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["offs"], op["first"],
                                   total=0, tile=op["tile"])
        np.testing.assert_array_equal(empty.numpy(), np.zeros(24, np.float32))
    g = tsp.work_bucket(0, 0)
    assert g == jsp.work_bucket(0, 0) and g % tsp.WORK_BUCKET_BASE == 0


def test_scatter_reads_only_the_true_products():
    """The plain version adds the first ``total`` products of the expanded
    stream and none of the work bucket's padded tail; the fused plan's
    blocks cover exactly those products."""
    d = hub_dense(15, m=300, n=40)
    prep = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    idx = np.array([1, 7, 20, 33])
    val = np.float32([1.5, -0.5, 2.0, 1.0])
    xi, xv = tsp.pad_sparse_rhs(idx, val, 6, 40)
    offs = tsp.touched_offsets(prep["col_len_np"], xi)
    T = int(offs[-1])
    G = tsp.work_bucket(T, prep["nnz"])
    assert G > T  # a padded tail exists
    rows, prods = tsp.expand_products(prep, torch.as_tensor(xi), torch.as_tensor(xv), G)
    for total in (T, T // 2):
        y = tsp.spmspv_scatter_plain(prep, torch.as_tensor(xi), torch.as_tensor(xv),
                                     total)
        want = np.zeros(300)
        np.add.at(want, rows[:total].numpy(), prods[:total].numpy().astype(np.float64))
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    for slab in (1, 100, 4096):
        tile, first = tsp.scatter_plan(offs, slab)
        n_blocks = first.size - 1
        assert (n_blocks - 1) * tile < T <= n_blocks * tile


def test_scatter_and_bind_refuse_bad_operands():
    prep = tsp.spmspv_prepare(csr_from_dense(rand_dense(7, m=16, n=16)), device="cpu")
    xi, xv = tsp.pad_sparse_rhs(np.arange(3), np.ones(3, np.float32), 4, 16)
    op = tsp.stage_sparse(prep, xi, xv)
    args = (op["xi"], op["xv"], op["offs"], op["first"])
    kw = {"total": op["total"], "tile": op["tile"]}
    with pytest.raises(ValueError, match=r"must be \(B,\), \(B,\) and \(B \+ 1,\)"):
        tsp.spmspv_scatter(prep, op["xi"], op["xv"][:3], *args[2:], **kw)
    with pytest.raises(ValueError, match=r"must be \(B,\)"):
        tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["offs"][:4], op["first"], **kw)
    with pytest.raises(ValueError, match="scatter_plan"):
        tsp.spmspv_scatter(prep, *args[:3], op["first"][:1], **kw)
    with pytest.raises(ValueError, match="scatter_plan"):
        tsp.spmspv_scatter(prep, *args, total=op["total"], tile=0)
    with pytest.raises(ValueError, match="scatter_plan"):
        tsp.spmspv_scatter(prep, *args, total=-1, tile=op["tile"])
    with pytest.raises(ValueError, match="ref or cuda"):
        tsp.spmspv_bind(prep, 4, impl="pallas")
    with pytest.raises(ValueError, match="padded slots"):
        tsp.spmspv_bind(prep, 4)(tsp.pad_sparse_rhs(np.arange(2), np.ones(2), 5, 16))


# ---------------------------------------------------------------------------
# The tuner: enumeration, byte model, operators, plan cache
# ---------------------------------------------------------------------------
def ported_keys(cands):
    return [c.key().replace("/pallas", "/cuda") for c in cands]


@pytest.mark.parametrize("x_nnz", [1, 12, 80])
def test_enumeration_features_and_sparse_costs_equal_repro(x_nnz):
    d = rand_dense(8, m=96, n=80)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    jfe, tfe = jt.extract(ja, x_nnz=x_nnz), tt.extract(ta, x_nnz=x_nnz)
    assert tfe.to_dict() == jfe.to_dict()
    assert tfe.x_density == pytest.approx(x_nnz / 80)
    jc = jt.enumerate_candidates(jfe, "spmspv")
    tc = tt.enumerate_candidates(tfe, "spmspv")
    assert [c.key() for c in tc] == ported_keys(jc)
    assert [c.key() for c in tc][-2:] == ["spmspv/ref", "spmspv/cuda[slab=4096]"]
    by_key = {c.key().replace("/pallas", "/cuda"): c for c in jc}
    for c in tc:
        for on_cpu in (True, False):
            for sparse_rhs in (True, False):
                if c.fmt == "spmspv" and not sparse_rhs:
                    continue
                assert tt.estimate_cost(ta, c, tfe, on_cpu=on_cpu,
                                        sparse_rhs=sparse_rhs) == jt.estimate_cost(
                    ja, by_key[c.key()], jfe, on_cpu=on_cpu, sparse_rhs=sparse_rhs
                ), (c.key(), on_cpu, sparse_rhs)


def test_cost_model_crosses_over_with_density():
    d = rand_dense(9, m=512, n=512, density=0.05)
    a = csr_from_dense(d)
    base = tt.extract(a)
    spmspv, csr = tt.make("spmspv", "cuda", slab=4096), tt.make("csr", "vector")
    thin = dataclasses.replace(base, x_density=0.001)
    full = dataclasses.replace(base, x_density=1.0)
    assert tt.estimate_cost(a, spmspv, thin, sparse_rhs=True) < tt.estimate_cost(
        a, csr, thin, sparse_rhs=True)
    assert tt.estimate_cost(a, spmspv, full, sparse_rhs=True) > tt.estimate_cost(
        a, csr, full, sparse_rhs=True)
    # a cuda candidate on a CPU device keeps its penalty
    assert tt.estimate_cost(a, spmspv, thin, sparse_rhs=True, on_cpu=True) > (
        tt.estimate_cost(a, tt.make("spmspv", "ref"), thin, sparse_rhs=True,
                         on_cpu=True))


def test_every_spmspv_kind_candidate_matches_repro_and_f64_oracle():
    d = rand_dense(10)
    ja, ta = j_csr_from_dense(d), csr_from_dense(d)
    nx = 6
    idx, val, x = sparse_x(11, 80, nx)
    want = d.astype(np.float64) @ x.astype(np.float64)
    cands = tt.enumerate_candidates(tt.extract(ta, x_nnz=nx), "spmspv")
    assert {c.fmt for c in cands} >= {"spmspv", "csr", "sell", "bcsr"}
    for c in cands:
        op = tt.SparseOperator.from_candidate(ta, c, x_nnz=nx, device="cpu")
        assert op.plan.kind == "spmspv" and op.plan.k == nx
        got = op.apply_sparse(idx, val).numpy()
        np.testing.assert_array_equal((op @ (idx, val)).numpy(), got)
        jc = jt.make(c.fmt, c.impl.replace("cuda", "pallas"), **c.param_dict)
        ref = np.asarray(jt.SparseOperator.from_candidate(ja, jc, x_nnz=nx)
                         .apply_sparse(idx, val))
        slack = 0.0
        if c.fmt == "merge":  # a row is a difference of global prefix sums
            rows, cols = np.nonzero(d)
            prefix = np.cumsum(d[rows, cols].astype(np.float64) * x[cols])
            slack = 8 * 2.0**-24 * np.abs(prefix).max(initial=0.0)
        for what, other in (("repro", ref), ("f64", want)):
            assert_rowtol(got, other, d, x, f"{c.key()} vs {what}", slack)


def test_operator_argument_rules_and_dense_fallback():
    d = rand_dense(12, m=40, n=32)
    a = csr_from_dense(d)
    sp = tt.make("spmspv", "ref")
    with pytest.raises(ValueError, match="x_nnz"):
        tt.SparseOperator.from_candidate(a, sp, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt.SparseOperator.from_candidate(a, sp, k=4, x_nnz=4, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt.SparseOperator.build(a, k=4, x_nnz=4, device="cpu")
    with pytest.raises(ValueError, match="sparse_rhs_runner"):
        tt.runner(a, sp, tt.prepare(a, sp, device="cpu"))
    dense_op = tt.SparseOperator.from_candidate(a, tt.make("csr", "vector"), device="cpu")
    with pytest.raises(ValueError, match="apply_sparse needs"):
        dense_op.apply_sparse(np.arange(2), np.ones(2, np.float32))
    op = tt.SparseOperator.from_candidate(a, sp, x_nnz=4, device="cpu")
    with pytest.raises(ValueError, match="x-nnz bucket is 4"):
        op.apply_sparse(np.arange(5), np.ones(5, np.float32))
    x = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    assert_rowtol((op @ torch.as_tensor(x)).numpy(), d.astype(np.float64) @ x, d, x)


def test_build_x_nnz_plan_cache_round_trip(tmp_path):
    d = rand_dense(13, m=96, n=96)
    a = csr_from_dense(d)
    path = tmp_path / "plans.json"
    op = tt.SparseOperator.build(a, x_nnz=8, cache=tt.PlanCache(path), warmup=0,
                                 timed=1, device="cpu")
    assert op.plan.kind == "spmspv" and op.plan.k == 8 and not op.from_cache
    assert op.plan.features["x_density"] == pytest.approx(8 / 96)
    assert "spmspv/ref" in op.measurements and not op.search_failures
    assert not any("/cuda" in key for key in op.measurements)  # priced out on CPU
    again = tt.SparseOperator.build(a, x_nnz=8, cache=tt.PlanCache(path), device="cpu")
    assert again.from_cache and again.plan.candidate == op.plan.candidate
    fp = tt.fingerprint(a)
    cache = tt.PlanCache(path)
    assert cache.get(fp, "spmspv", 8, backend="cpu") is not None
    assert cache.get(fp, "spmspv", 16, backend="cpu") is None  # keyed per bucket
    assert cache.get(fp, "spmv", 1, backend="cpu") is None
    idx, val, x = sparse_x(14, 96, 8)
    np.testing.assert_array_equal(again.apply_sparse(idx, val).numpy(),
                                  op.apply_sparse(idx, val).numpy())
    assert_rowtol(op.apply_sparse(idx, val).numpy(), d.astype(np.float64) @ x, d, x)

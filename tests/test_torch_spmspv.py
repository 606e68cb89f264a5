"""The port's sparse-RHS tier against the JAX package's.

Same seeded numpy inputs on both sides: the CSC prepare, the work-bucket
ladder and the product expansion must equal ``repro``'s bit for bit, the
validation texts must match, and the host plan of the SpMSpV kernel
(offsets, true total, each block's first slot, the row tiles) walked in
numpy through the kernel's four passes must bucket exactly ``repro``'s
expanded stream in stream order and sum it to ``repro``'s y.  The wrapper
(its plain version on the CPU) must equal ``repro``'s expansion + Pallas
scatter in interpret mode (``spmspv_pallas_fn``) on the same padded x,
carried across with ``repro_torch.interop``, bit for bit: both add each
row's products in stream order from +0.0.  Against float64 the tolerance
per row i is |port - f64| <= 1e-5 * (|A| |x|)_i.  Then the tuner (enumeration, byte model, every candidate
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
from repro.core.formats import csr_from_coo as j_csr_coo
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
# The SpMSpV kernel (spmspv_scatter_pallas + its expansion)
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
    if case == "long_row":
        # row 5 holds a product in every touched column: 2000 of them, past
        # the most a block takes (SCATTER_MAX_TILE) and spread over many blocks
        rng = np.random.default_rng(23)
        d = ((rng.random((40, 3000)) < 0.01) * rng.standard_normal((40, 3000))).astype(
            np.float32)
        d[5] = rng.standard_normal(3000).astype(np.float32)
        idx = np.sort(rng.choice(3000, size=2000, replace=False))
        return d, idx, rng.standard_normal(2000).astype(np.float32), 4096
    d = rand_dense(21, m=120, n=96, density=0.12)
    if case == "empty_x":
        return d, np.zeros(0, np.int64), np.zeros(0, np.float32), 4096
    if case == "empty_columns":
        d[:, 10:60] = 0.0  # every touched column in between is empty
        idx = np.array([2, 10, 11, 30, 59, 60, 95])
        return d, idx, np.linspace(-1, 1, idx.size).astype(np.float32), 4096
    if case == "neg_zero":
        # x_2 = +0.0: row 7's only product is -1.5 * +0.0 = -0.0, row 9's
        # only one +0.0, and row 11 starts from -0.0 before its others
        d[7], d[9] = 0.0, 0.0
        d[7, 2], d[9, 2], d[11, 2] = -1.5, 2.0, -1.0
        idx = np.array([2, 10, 30, 59, 60, 95])
        val = np.float32([0.0, 0.5, -1.0, 2.0, 0.25, -3.0])
        return d, idx, val, 4096
    idx, val, _ = sparse_x(22, 96, 40)
    return d, idx, val, 256


def emulate_kernel(prep, xi, xv, offs, first, tile):
    """The kernel's four passes in numpy.  Block b walks products
    [b*tile, (b+1)*tile), finding each one's slot between first[b] and
    first[b+1]; ``count`` tallies them per row tile, ``scan`` turns the
    tallies into each block's place in each tile's bucket, ``place`` writes
    them 32 at a time, a lane ranked after the lower lanes of its tile, and
    ``sum`` adds each bucket in order into +0.0 rows, one float32 rounding
    a product.  Returns (stream rows, stream products, bucket rows, bucket
    products, tile_start, shift, y)."""
    col_start, rows = prep["col_start"].numpy(), prep["rows"].numpy()
    vals, total, m = prep["vals"].numpy(), int(offs[-1]), prep["shape"][0]
    blocks = []
    for b in range(first.size - 1):
        lo, hi = int(first[b]), int(first[b + 1])
        r_b, p_b = [], []
        for t in range(b * tile, min(total, (b + 1) * tile)):
            s = lo + int(np.searchsorted(offs[lo:hi + 1], t, side="right")) - 1
            assert lo <= s <= hi and offs[s] <= t < offs[s + 1]
            src = col_start[xi[s]] + t - offs[s]
            r_b.append(rows[src])
            p_b.append(np.float32(vals[src]) * np.float32(xv[s]))
        blocks.append((np.array(r_b, np.int64), np.array(p_b, np.float32)))
    y = np.zeros(m, np.float32)
    if total == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.float32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(1, np.int64), 0, y)
    shift, n_tiles = tsp.row_tiles(m, total)
    assert n_tiles == -(-m >> shift) <= tsp.SCATTER_MAX_TILES
    counts = np.array([np.bincount(r_b >> shift, minlength=n_tiles) for r_b, _ in blocks])
    tile_start = np.concatenate([[0], np.cumsum(counts.sum(0))])
    base = tile_start[:-1] + np.cumsum(counts, axis=0) - counts  # (blocks, tiles)
    b_rows = np.full(total, -1, np.int64)
    b_prods = np.zeros(total, np.float32)
    for (r_b, p_b), nxt in zip(blocks, base):
        nxt = nxt.copy()
        for j in range(0, r_b.size, 32):
            key = r_b[j:j + 32] >> shift
            rank = [int(np.sum(key[:lane] == key[lane])) for lane in range(key.size)]
            pos = nxt[key] + rank
            b_rows[pos], b_prods[pos] = r_b[j:j + 32], p_b[j:j + 32]
            np.add.at(nxt, key, 1)
    assert np.all(b_rows >= 0)  # every position written once
    for i in range(total):
        y[b_rows[i]] = np.float32(y[b_rows[i]] + b_prods[i])
    stream_r = np.concatenate([r_b for r_b, _ in blocks]).astype(np.int32)
    stream_p = np.concatenate([p_b for _, p_b in blocks])
    return stream_r, stream_p, b_rows, b_prods, tile_start, shift, y


def bits(y):
    return np.asarray(y, np.float32).view(np.int32)


PLAN_CASES = ["empty_x", "all_sentinel", "empty_columns", "hub", "random", "long_row",
              "neg_zero"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_host_plan_equals_what_repro_expansion_implies(case):
    """offs, T and each block's first slot equal what repro's expansion
    implies; the kernel's walk over them buckets exactly repro's stream,
    each tile's bucket in stream order, and sums it to the stream-order
    float32 sum of repro's products."""
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
    assert 1 <= tile <= min(slab, tsp.SCATTER_MAX_TILE)
    t = np.arange(total)
    slot = np.searchsorted(offs, t, side="right") - 1  # the expansion's slot map
    if total:
        np.testing.assert_array_equal(first[:-1], slot[::tile])
        assert first[-1] == slot[-1]
        assert np.all(np.diff(first) >= 0)
    G = jsp.work_bucket(total, jprep["nnz"])
    jrows, jprods = jsp.expand_products(jprep, jnp.asarray(xi), jnp.asarray(xv), G)
    jrows, jprods = np.asarray(jrows)[:total], np.asarray(jprods)[:total]
    rows, prods, b_rows, b_prods, tile_start, shift, y = emulate_kernel(
        prep, xi, xv, offs, first, tile)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(bits(prods), bits(jprods))
    for k in range(tile_start.size - 1):  # bucket k = repro's stream of tile k, in order
        of_k = (jrows >> shift) == k
        np.testing.assert_array_equal(b_rows[tile_start[k]:tile_start[k + 1]], jrows[of_k])
        np.testing.assert_array_equal(bits(b_prods[tile_start[k]:tile_start[k + 1]]),
                                      bits(jprods[of_k]))
    want_y = np.zeros(d.shape[0], np.float32)
    for r, p in zip(jrows, jprods):
        want_y[r] = np.float32(want_y[r] + p)
    np.testing.assert_array_equal(bits(y), bits(want_y))
    if case == "hub":
        assert n_blocks >= 8 and np.sum(first[:-1] == first[1]) >= 6  # one hub
    if case == "empty_columns":
        assert np.sum(prep["col_len_np"][xi] == 0) >= 3
    if case == "long_row":
        starts = np.flatnonzero(jrows == 5)
        assert starts.size > tsp.SCATTER_MAX_TILE
        assert starts[-1] // tile - starts[0] // tile >= 8  # row 5 spans many blocks
    if case == "neg_zero":
        assert bits(jprods[jrows == 7]).tolist() == [np.int32(-2**31)]  # -0.0
        assert bits(y)[7] == 0 and bits(y)[9] == 0  # +0.0


@pytest.mark.parametrize("case,nx", [("random", 6), ("random", 40), ("hub", 5),
                                     ("empty_columns", 7), ("long_row", 2000),
                                     ("neg_zero", 6)])
def test_scatter_matches_pallas_scatter_on_repro_streams(case, nx):
    """The wrapper (its plain version on the CPU) and the numpy walk of the
    kernel against repro's spmspv_pallas_fn in interpret mode on the same
    padded (xi, xv): equal bit for bit."""
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
    np.testing.assert_array_equal(bits(y_port), bits(y_pallas))
    y_walk = emulate_kernel(prep, op["xi"].numpy(), op["xv"].numpy(), op["offs"].numpy(),
                            op["first"].numpy(), op["tile"])[-1]
    np.testing.assert_array_equal(bits(y_walk), bits(y_pallas))
    assert_rowtol(y_port, d.astype(np.float64) @ x, d, x, "port vs f64")
    # the bound runner gives the same y through either impl
    for impl in ("cuda", "ref"):
        fn = tsp.spmspv_bind(prep, nx, impl=impl, slab=slab)
        np.testing.assert_array_equal(bits(fn((jxi, jxv)).numpy()), bits(y_port))


# the largest y whose row tiles all fit shared memory, then one row more
SMEM_ROWS_MAX = tsp.SCATTER_MAX_TILES * tsp.SCATTER_SMEM_TILE_ROWS


@pytest.mark.parametrize("m,total,want", [
    (100, 10, (6, 2)),
    (1_000_000, 1_006_062, (10, 977)),  # webbase-1M at n/4
    (SMEM_ROWS_MAX, 1, (13, tsp.SCATTER_MAX_TILES)),
    (SMEM_ROWS_MAX + 1, 1, (14, tsp.SCATTER_MAX_TILES // 2 + 1)),
    (SMEM_ROWS_MAX + 1, 10**8, (14, tsp.SCATTER_MAX_TILES // 2 + 1)),
    (2**31 - 1, 5, (21, tsp.SCATTER_MAX_TILES)),
])
def test_row_tiles_cover_any_int32_y(m, total, want):
    """Row tiles cover every row of y exactly, at most SCATTER_MAX_TILES of
    them: up to SMEM_ROWS_MAX rows in tiles that fit shared memory, past it
    in larger tiles (which the kernel sums in y itself), up to 2**31 - 1."""
    shift, n_tiles = tsp.row_tiles(m, total)
    assert (shift, n_tiles) == want
    assert 1 <= n_tiles <= tsp.SCATTER_MAX_TILES
    assert (n_tiles - 1) << shift < m <= n_tiles << shift
    assert ((1 << shift) <= tsp.SCATTER_SMEM_TILE_ROWS) == (m <= SMEM_ROWS_MAX)


def test_prepare_refuses_a_y_past_int32_rows():
    huge = types.SimpleNamespace(shape=(2**31, 4), indptr=np.array([0, 2]))
    with pytest.raises(OverflowError, match="int32"):
        tsp.spmspv_prepare(huge, device="cpu")


def test_kernel_walk_on_a_y_past_the_shared_memory_tiles():
    """A y of SMEM_ROWS_MAX + 1 rows, products in its first and last rows
    and a row of 1 500 products spread over many blocks: the numpy walk of
    the kernel (tiles of 2**14 rows) and the wrapper's plain version equal
    repro's spmspv_pallas_fn in interpret mode bit for bit."""
    m, n = SMEM_ROWS_MAX + 1, 2000
    rng = np.random.default_rng(31)
    rows = np.concatenate([rng.integers(0, m, 3000), [0, m - 1, m - 1],
                           np.full(n, m - 20_000)])
    cols = np.concatenate([rng.integers(0, n, 3003), np.arange(n)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    a = j_csr_coo((m, n), rows, cols, vals)
    idx = np.union1d(rng.choice(n, size=1500, replace=False), cols[3000:3003])
    val = rng.standard_normal(idx.size).astype(np.float32)
    nx, slab = idx.size + 2, 4096
    jprep = jsp.spmspv_prepare(a)
    jxi, jxv = jsp.pad_sparse_rhs(idx, val, nx, n)
    total = int(jprep["col_len_np"][jxi].sum())
    G = jsp.work_bucket(total, jprep["nnz"])
    y_pallas = np.asarray(jsp.spmspv_pallas_fn(jprep, G, slab, True)(
        jnp.asarray(jxi), jnp.asarray(jxv)))
    prep = carried(jprep)
    op = tsp.stage_sparse(prep, jxi, jxv, slab=slab)
    assert op["total"] == total
    y_port = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["offs"], op["first"],
                                total=total, tile=op["tile"]).numpy()
    np.testing.assert_array_equal(bits(y_port), bits(y_pallas))
    *_, tile_start, shift, y_walk = emulate_kernel(
        prep, op["xi"].numpy(), op["xv"].numpy(), op["offs"].numpy(),
        op["first"].numpy(), op["tile"])
    assert 1 << shift > tsp.SCATTER_SMEM_TILE_ROWS
    assert tile_start.size - 1 == -(-m >> shift)
    np.testing.assert_array_equal(bits(y_walk), bits(y_pallas))
    assert y_pallas[m - 20_000] != 0 and y_pallas[m - 1] != 0


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
    stream and none of the work bucket's padded tail; the kernel plan's
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

"""The port's sparse-RHS tier against the JAX package's.

Same seeded numpy inputs on both sides: the CSC prepare, the work-bucket
ladder and the product expansion must equal ``repro``'s bit for bit, the
validation texts must match, and the SpMSpV kernel's five passes walked in
numpy (the offsets, T and each chunk's slots found on the device, the
per-warp ranks, the row-tile buckets, the in-tile sort by row and the
per-row sums) must imply exactly ``repro``'s expanded stream and sum it to
``repro``'s y, at several chunk and tile splits.  A request's host half
reads no host column lengths.  The wrapper
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
        # row 5 holds a product in every touched column: 2000 of them,
        # spread over many chunks
        rng = np.random.default_rng(23)
        d = ((rng.random((40, 3000)) < 0.01) * rng.standard_normal((40, 3000))).astype(
            np.float32)
        d[5] = rng.standard_normal(3000).astype(np.float32)
        idx = np.sort(rng.choice(3000, size=2000, replace=False))
        return d, idx, rng.standard_normal(2000).astype(np.float32), 4096
    if case == "hub_rows":
        # twelve rows hold a product in every touched column: twelve hub
        # rows in one row tile whose bucket (30 000+) passes the shared-memory
        # sort of every tile size
        rng = np.random.default_rng(24)
        d = ((rng.random((64, 3000)) < 0.01) * rng.standard_normal((64, 3000))).astype(
            np.float32)
        hubs = [1, 3, 7, 9, 12, 15, 17, 20, 24, 27, 30, 31]
        d[hubs] = rng.standard_normal((len(hubs), 3000)).astype(np.float32)
        idx = np.sort(rng.choice(3000, size=2500, replace=False))
        return d, idx, rng.standard_normal(2500).astype(np.float32), 4096
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


def split(plan, chunk_shift=None, shift=None):
    """``plan`` with another chunk cap or row tiles, its chunk bound and
    grid recomputed as :func:`scatter_plan` does."""
    cs = plan.chunk_shift if chunk_shift is None else chunk_shift
    sh = plan.shift if shift is None else shift
    n_chunks = min(-(-plan.t_max // tsp.SCATTER_GRAIN),
                   max(tsp.SCATTER_TARGET_CHUNKS, -(-plan.t_max >> cs)))
    return dataclasses.replace(plan, chunk_shift=cs, shift=sh, n_tiles=-(-plan.m >> sh),
                               n_chunks=n_chunks, grid=max(1, min(n_chunks, tsp.SCATTER_MAX_GRID)))


def lane_ranks(keys):
    """Each lane's rank among the lower lanes of a 32-lane round holding the
    same key (``__popc(__match_any_sync(key) & lower)``)."""
    same = keys[:, None] == keys[None, :]
    return (same & np.tri(keys.size, k=-1, dtype=bool)).sum(1)


def sort_pass(order, key, bits):
    """One pass of the sum pass's in-tile counting sort: the bucket indices
    ``order`` (the pass's input order), keyed by ``key[order]`` (< 2**bits),
    placed stably.  Warp v of 16 takes the contiguous 16th [v * q, (v + 1) *
    q) of the input, 32 lanes a round; per-warp digit counts scanned over
    (digit, warp) start each warp's products of a digit, and a lane's rank
    among its round's lower lanes of the same digit places it."""
    keys, q, D = key[order], -(-order.size // 16), 1 << bits
    cnt = np.array([np.bincount(keys[v * q:(v + 1) * q], minlength=D)
                    for v in range(16)]).reshape(16, D)  # (warp, digit)
    flat = cnt.T.ravel()  # (digit, warp) order
    cur = (np.cumsum(flat) - flat).reshape(D, 16).T.copy()  # cur[warp, digit]
    out = np.full(order.size, -1, np.int64)
    for v in range(16):
        for i0 in range(v * q, min(order.size, (v + 1) * q), 32):
            lanes = keys[i0:i0 + 32]
            out[cur[v, lanes] + lane_ranks(lanes)] = order[i0:i0 + 32]
            np.add.at(cur[v], lanes, 1)
    return out


def emulate_kernel(prep, xi, xv, plan, cs=None):
    """The kernel's five passes in numpy, as csrc/spmspv_scatter.cu takes
    them.  ``offsets``: each 4096-slot block's exclusive scan of
    col_len[xi] plus the blocks before it; every 256-product grain's slot
    (``firsts``).  ``count``: per chunk of 2**chunk_shift products (the
    device's rule), each nonempty slot marks its first product and a max-
    scan carries the marks forward, giving every product its slot; then
    its row tile.  ``scan``: each chunk's place in each tile's bucket.
    ``place``: each warp takes a contiguous eighth of the chunk, 32 lanes a
    round, ranked by per-warp tile histograms scanned over (tile, warp) and
    by the lower lanes of its round.  ``sum``: per tile, a stable counting
    sort by row, least significant digit first in two passes
    (:func:`sort_pass`: the low shift // 2 bits, then the rest); the row
    counts, scanned, start the rows, and one thread per row adds its
    products in order into +0.0 (a tile of more rows than the sort takes
    walks its bucket in order in y).  Returns a dict: offs,
    T, firsts, the chunk shift, the stream (rows, products), the buckets,
    tile_start and y.  ``cs`` overrides the device's chunk size (log2), to
    show that the bits do not depend on it."""
    col_len, col_start = prep["col_len"].numpy(), prep["col_start"].numpy()
    rows, vals = prep["rows"].numpy(), prep["vals"].numpy()
    m, n = prep["shape"]
    B, shift, n_tiles = plan.B, plan.shift, plan.n_tiles
    xi = np.clip(np.asarray(xi, np.int64), 0, n)
    xv = np.asarray(xv, np.float32)
    lens = col_len[xi].astype(np.int64)
    offs = np.zeros(B + 1, np.int64)
    prefix = 0
    for b0 in range(0, B, tsp.SCATTER_SCAN_SLOTS):  # the look-back, block by block
        blk = lens[b0:b0 + tsp.SCATTER_SCAN_SLOTS]
        offs[b0:b0 + blk.size] = prefix + np.cumsum(blk) - blk
        prefix += int(blk.sum())
    total = offs[B] = prefix
    grain = tsp.SCATTER_GRAIN
    firsts = np.full(-(-total // grain), -1, np.int64)
    for s in np.flatnonzero(lens):
        firsts[-(-offs[s] // grain):-(-offs[s + 1] // grain)] = s
    assert np.all(firsts >= 0)
    y = np.zeros(m, np.float32)
    out = {"offs": offs, "T": total, "firsts": firsts, "y": y}
    assert total <= plan.t_max
    cs = tsp.chunk_shift(total, plan.chunk_shift) if cs is None else cs
    size = 1 << cs
    n_chunks = -(-total >> cs)
    assert n_chunks <= plan.n_chunks
    out["cs"] = cs
    chunks = []
    for c in range(n_chunks):  # count: the slot map of each chunk
        t0, t_end = c << cs, min(total, (c + 1) << cs)
        lo = firsts[t0 // grain]
        pos = np.zeros(size, np.int64)
        base = np.zeros(size, np.int64)
        scale = np.zeros(size, np.float32)
        base[0], scale[0] = col_start[xi[lo]] - offs[lo], xv[lo]
        s = lo + 1
        while s < B and offs[s] < t_end:
            if offs[s + 1] > offs[s]:
                p = offs[s] - t0
                pos[p], base[p], scale[p] = p, col_start[xi[s]] - offs[s], xv[s]
            s += 1
        a = np.maximum.accumulate(pos)[:t_end - t0]
        t = np.arange(t0, t_end)
        slot = np.searchsorted(offs, t, side="right") - 1  # the expansion's slot map
        np.testing.assert_array_equal(base[a], col_start[xi[slot]] - offs[slot])
        src = base[a] + t
        chunks.append((rows[src].astype(np.int64), vals[src] * scale[a]))
    out["rows"] = np.concatenate([r for r, _ in chunks] or [np.zeros(0, np.int64)])
    out["prods"] = np.concatenate([p for _, p in chunks] or [np.zeros(0, np.float32)])
    counts = np.array([np.bincount(r >> shift, minlength=n_tiles) for r, _ in chunks],
                      np.int64).reshape(n_chunks, n_tiles)
    tile_start = np.concatenate([[0], np.cumsum(counts.sum(0))])  # scan
    chunk_base = tile_start[:-1] + np.cumsum(counts, axis=0) - counts
    b_rows = np.full(total, -1, np.int64)
    b_prods = np.zeros(total, np.float32)
    sub = size // 8
    for (r, p), cbase in zip(chunks, chunk_base):  # place
        keys = r >> shift
        hist = np.array([np.bincount(keys[w * sub:(w + 1) * sub], minlength=n_tiles)
                         for w in range(8)])
        before = np.cumsum(hist, axis=0) - hist  # over (tile, warp)
        for w in range(8):
            run = cbase + before[w]
            for i0 in range(w * sub, min(r.size, (w + 1) * sub), 32):
                lanes = keys[i0:i0 + 32]
                at = run[lanes] + lane_ranks(lanes)
                b_rows[at], b_prods[at] = r[i0:i0 + 32], p[i0:i0 + 32]
                np.add.at(run, lanes, 1)
    assert np.all(b_rows >= 0)  # every place written once
    out.update(b_rows=b_rows, b_prods=b_prods, tile_start=tile_start)
    R = 1 << shift
    for k in range(n_tiles):  # sum
        r0, beg, end = k << shift, tile_start[k], tile_start[k + 1]
        lr, lp = b_rows[beg:end] - r0, b_prods[beg:end]
        if R > tsp.SCATTER_SMEM_TILE_ROWS:  # summed in y, in bucket order
            for r_, p_ in zip(lr, lp):
                y[r0 + r_] = np.float32(y[r0 + r_] + p_)
            continue
        if lr.size == 0:
            continue
        lo = shift // 2  # (1) the low shift // 2 bits of the row, (2) the rest
        perm = sort_pass(np.arange(lr.size), lr & ((1 << lo) - 1), lo)
        perm = sort_pass(perm, lr >> lo, shift - lo)
        assert np.array_equal(np.sort(perm), np.arange(lr.size))  # a permutation
        sorted_p = lp[perm]
        hist = np.bincount(lr, minlength=R)  # the row counts, scanned, start the rows
        start = np.cumsum(hist) - hist
        for r_ in np.unique(lr):  # one thread a row, from +0.0 in sorted order
            acc = np.float32(0.0)
            for v in sorted_p[start[r_]:start[r_] + hist[r_]]:
                acc = np.float32(acc + v)
            y[r0 + r_] = acc
    return out


def bits(y):
    return np.asarray(y, np.float32).view(np.int32)


def repro_stream(jprep, xi, xv):
    """repro's expanded stream (rows, products) over its true products, and
    its stream-order float32 sum."""
    total = int(np.asarray(jprep["col_len_np"])[np.asarray(xi)].sum())
    G = jsp.work_bucket(total, jprep["nnz"])
    jrows, jprods = jsp.expand_products(jprep, jnp.asarray(xi), jnp.asarray(xv), G)
    jrows, jprods = np.asarray(jrows)[:total], np.asarray(jprods)[:total]
    want_y = np.zeros(jprep["shape"][0], np.float32)
    for r, p in zip(jrows, jprods):
        want_y[r] = np.float32(want_y[r] + p)
    return jrows, jprods, want_y


PLAN_CASES = ["empty_x", "all_sentinel", "empty_columns", "hub", "random", "long_row",
              "neg_zero", "hub_rows"]
# The splits a plan case runs at, (plan changes, chunk size): the bucket's
# own plan, the smallest chunks (256 products) with 32-row tiles, and the
# largest chunks (4 096 products) with 8 192-row tiles.
SPLITS = {"plan": ({}, None),
          "fine": ({"chunk_shift": 8, "shift": 5}, 8),
          "coarse": ({"chunk_shift": 12, "shift": 13}, 12)}


@pytest.mark.parametrize("split_name", list(SPLITS))
@pytest.mark.parametrize("case", PLAN_CASES)
def test_host_plan_equals_what_repro_expansion_implies(case, split_name):
    """The device-side plan walked in numpy (offsets and T by block
    look-back, each chunk's first slot, the slot map by marks and a
    max-scan) implies exactly repro's expansion; the passes bucket it, each
    tile's bucket in stream order, sort each tile by row and sum it to
    repro's stream-order float32 sum, bit for bit, at every split."""
    d, idx, val, slab = plan_case("empty_x" if case == "all_sentinel" else case)
    n = d.shape[1]
    bucket = 8 if case == "all_sentinel" else max(idx.size, 1) + 3
    jprep = jsp.spmspv_prepare(j_csr_from_dense(d))
    prep = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    xi, xv = tsp.pad_sparse_rhs(idx, val, bucket, n)
    changes, cs = SPLITS[split_name]
    plan = split(tsp.scatter_plan(prep, bucket, slab), **changes)
    walk = emulate_kernel(prep, xi, xv, plan, cs)
    want = np.concatenate([[0], np.cumsum(np.asarray(jprep["col_len_np"])[xi])])
    np.testing.assert_array_equal(walk["offs"], want)
    total = walk["T"]
    assert total <= plan.t_max == np.sort(prep["col_len_np"][:n])[::-1][:bucket].sum()
    jrows, jprods, want_y = repro_stream(jprep, xi, xv)
    np.testing.assert_array_equal(walk["rows"], jrows)
    np.testing.assert_array_equal(bits(walk["prods"]), bits(jprods))
    shift, tile_start = plan.shift, walk["tile_start"]
    for k in range(plan.n_tiles):  # bucket k = repro's stream of tile k, in order
        of_k = (jrows >> shift) == k
        np.testing.assert_array_equal(walk["b_rows"][tile_start[k]:tile_start[k + 1]],
                                      jrows[of_k])
        np.testing.assert_array_equal(
            bits(walk["b_prods"][tile_start[k]:tile_start[k + 1]]), bits(jprods[of_k]))
    np.testing.assert_array_equal(bits(walk["y"]), bits(want_y))
    n_chunks = -(-total >> walk["cs"])
    if split_name == "coarse":
        assert n_chunks == -(-total // tsp.SCATTER_MAX_CHUNK)
    if case == "hub":
        assert np.sum(walk["firsts"][:-1] == walk["firsts"][1:]) >= 4  # one hub
        assert n_chunks >= 4 or split_name == "coarse"
    if case == "empty_columns":
        assert np.sum(prep["col_len_np"][xi] == 0) >= 3
    if case == "long_row":
        starts = np.flatnonzero(jrows == 5)
        assert starts.size > tsp.SCATTER_MAX_CHUNK // 4
        if split_name != "coarse":  # row 5 spans many chunks
            assert (starts[-1] >> walk["cs"]) - (starts[0] >> walk["cs"]) >= 8
    if case == "neg_zero":
        assert bits(jprods[jrows == 7]).tolist() == [np.int32(-2**31)]  # -0.0
        assert bits(walk["y"])[7] == 0 and bits(walk["y"])[9] == 0  # +0.0
    if case == "hub_rows":  # several hub rows in one tile, past the shared sort
        k_i = np.bincount(jrows, minlength=d.shape[0])
        assert np.sum(k_i >= 1000) >= 12 and len({r >> shift for r in np.flatnonzero(
            k_i >= 1000)}) == 1
        assert tile_start[1] - tile_start[0] > tsp.sort_cap(shift)


@pytest.mark.parametrize("case,nx", [("random", 6), ("random", 40), ("hub", 5),
                                     ("empty_columns", 7), ("long_row", 2000),
                                     ("neg_zero", 6), ("hub_rows", 2500)])
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
    y_pallas = np.asarray(jsp.spmspv_pallas_fn(jprep, G, min(slab, 4096), True)(
        jnp.asarray(jxi), jnp.asarray(jxv)))
    prep = carried(jprep)
    _build.reset_launches()
    op = tsp.stage_sparse(prep, jxi, jxv, slab=slab)
    y_port = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"]).numpy()
    assert sum(_build.LAUNCHES.values()) == 0  # the plain version ran
    np.testing.assert_array_equal(bits(y_port), bits(y_pallas))
    walk = emulate_kernel(prep, op["xi"].numpy(), op["xv"].numpy(), op["plan"])
    assert walk["T"] == total
    np.testing.assert_array_equal(bits(walk["y"]), bits(y_pallas))
    assert_rowtol(y_port, d.astype(np.float64) @ x, d, x, "port vs f64")
    # the bound runner gives the same y through either impl
    for impl in ("cuda", "ref"):
        fn = tsp.spmspv_bind(prep, nx, impl=impl, slab=slab)
        np.testing.assert_array_equal(bits(fn((jxi, jxv)).numpy()), bits(y_port))


# the largest y whose row tiles all sort in shared memory, then one row more
SMEM_ROWS_MAX = tsp.SCATTER_MAX_TILES * tsp.SCATTER_SMEM_TILE_ROWS


@pytest.mark.parametrize("m,total,want", [
    (100, 10, (5, 4)),
    (1_000_005, 959_697, (13, 123)),  # webbase-1M at n/4: B * nnz / n
    (116_158, 2_129_590, (10, 114)),  # torso1 at n/4
    (SMEM_ROWS_MAX, 1, (13, tsp.SCATTER_MAX_TILES)),
    (SMEM_ROWS_MAX + 1, 1, (14, tsp.SCATTER_MAX_TILES // 2 + 1)),
    (SMEM_ROWS_MAX + 1, 10**8, (14, tsp.SCATTER_MAX_TILES // 2 + 1)),
    (2**31 - 1, 5, (21, tsp.SCATTER_MAX_TILES)),
])
def test_row_tiles_cover_any_int32_y(m, total, want):
    """Row tiles cover every row of y exactly, at most SCATTER_MAX_TILES of
    them, at least SCATTER_MIN_TILES or one per SCATTER_TILE_PRODUCTS
    expected products: up to
    SMEM_ROWS_MAX rows in tiles that sort in shared memory, past it in
    larger tiles (which the kernel sums in y itself), up to 2**31 - 1."""
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
    and a row of 1 500 products spread over many chunks: the numpy walk of
    the kernel (tiles of 2**14 rows, summed in y) and the wrapper's plain
    version equal repro's spmspv_pallas_fn in interpret mode bit for bit."""
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
    y_port = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"]).numpy()
    np.testing.assert_array_equal(bits(y_port), bits(y_pallas))
    walk = emulate_kernel(prep, op["xi"].numpy(), op["xv"].numpy(), op["plan"])
    assert walk["T"] == total
    assert 1 << op["plan"].shift > tsp.SCATTER_SMEM_TILE_ROWS
    assert walk["tile_start"].size - 1 == -(-m >> op["plan"].shift)
    np.testing.assert_array_equal(bits(walk["y"]), bits(y_pallas))
    assert y_pallas[m - 20_000] != 0 and y_pallas[m - 1] != 0


def test_empty_x_and_empty_matrix_give_exact_zeros():
    """An x with no nonzero: zeros through either impl, no staging; a T of
    0 from empty touched columns (or an empty matrix) through the wrapper:
    zeros (on a card the passes launch and write them)."""
    d = rand_dense(6, m=24, n=32, density=0.2)
    d[:, 5] = 0.0
    for dd in (d, np.zeros_like(d)):
        prep = tsp.spmspv_prepare(csr_from_dense(dd), device="cpu")
        xi, xv = tsp.pad_sparse_rhs(np.zeros(0, np.int64), np.zeros(0, np.float32),
                                    6, 32)
        for impl in ("ref", "cuda"):
            y = tsp.spmspv_bind(prep, 6, impl=impl)((xi, xv))
            assert y.shape == (24,) and y.dtype == torch.float32
            np.testing.assert_array_equal(y.numpy(), np.zeros(24, np.float32))
        xi, xv = tsp.pad_sparse_rhs(np.array([5]), np.ones(1, np.float32), 6, 32)
        op = tsp.stage_sparse(prep, xi, xv)
        empty = tsp.spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"])
        np.testing.assert_array_equal(bits(empty.numpy()), np.zeros(24, np.int32))
        assert emulate_kernel(prep, xi, xv, op["plan"])["T"] == 0
    g = tsp.work_bucket(0, 0)
    assert g == jsp.work_bucket(0, 0) and g % tsp.WORK_BUCKET_BASE == 0


def test_scatter_reads_only_the_true_products():
    """The plain version adds the first T products of the expanded stream
    and none of the work bucket's padded tail (on the CPU and through the
    card's rank-ordered adds); the plan's bounds hold every T of B distinct
    columns and every chunk split of it."""
    d = hub_dense(15, m=300, n=40)
    prep = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    idx = np.array([1, 7, 20, 33])
    val = np.float32([1.5, -0.5, 2.0, 1.0])
    xi, xv = tsp.pad_sparse_rhs(idx, val, 6, 40)
    T = int(prep["col_len_np"][xi].sum())
    G = tsp.work_bucket(T, prep["nnz"])
    assert G > T  # a padded tail exists
    rows, prods = tsp.expand_products(prep, torch.as_tensor(xi), torch.as_tensor(xv), G)
    y = tsp.spmspv_scatter_plain(prep, torch.as_tensor(xi), torch.as_tensor(xv))
    want = np.zeros(300, np.float32)
    for r, p in zip(rows[:T].numpy(), prods[:T].numpy()):
        want[r] = np.float32(want[r] + p)
    np.testing.assert_array_equal(bits(y.numpy()), bits(want))
    ranked = tsp.rank_ordered_sum(torch.zeros(300), rows[:T], prods[:T])
    np.testing.assert_array_equal(bits(ranked.numpy()), bits(want))
    for slab in (1, 100, 4096):
        plan = tsp.scatter_plan(prep, 6, slab)
        assert plan.t_max == np.sort(prep["col_len_np"][:40])[::-1][:6].sum() >= T
        for t in range(0, plan.t_max + 1, 7):  # every T the bucket can meet
            cs = tsp.chunk_shift(t, plan.chunk_shift)
            assert 8 <= cs <= plan.chunk_shift and -(-t >> cs) <= plan.n_chunks


def test_rank_ordered_sum_adds_each_row_in_stream_order():
    """The card's plain tier on CPU tensors: hub rows, -0.0 products and
    rows in any order give index_add_'s stream-order bits, and each of its
    index_add_ calls meets every row at most once."""
    rng = np.random.default_rng(41)
    rows = np.concatenate([rng.integers(0, 50, 400), np.full(300, 7), np.full(200, 31)])
    rng.shuffle(rows)
    prods = (rng.standard_normal(rows.size) * 10.0 ** rng.integers(-4, 4, rows.size)
             ).astype(np.float32)
    prods[rows == 13] = -0.0
    r_t, p_t = torch.as_tensor(rows, dtype=torch.int32), torch.as_tensor(prods)
    want = torch.zeros(60).index_add_(0, r_t, p_t)
    seen = []
    add = torch.Tensor.index_add_

    def recording(self, dim, index, source):
        seen.append(index.clone())
        return add(self, dim, index, source)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "index_add_", recording)
        got = tsp.rank_ordered_sum(torch.zeros(60), r_t, p_t)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
    assert len(seen) == int(np.bincount(rows).max()) >= 300
    assert all(torch.unique(i).numel() == i.numel() for i in seen)
    assert bits(got.numpy())[13] == 0  # +0.0


def test_request_host_half_reads_no_col_len():
    """A request's host half is validate, pad and one staged copy of xi and
    xv: with the prepared dict's host lengths made unreadable after binding,
    both impls still answer bit for bit as before, and the staged buffer is
    the zero flags, the clipped slots and the values' bits."""
    d = rand_dense(17, m=80, n=64)
    prep = tsp.spmspv_prepare(csr_from_dense(d), device="cpu")
    idx, val, _ = sparse_x(18, 64, 9)
    xi, xv = tsp.pad_sparse_rhs(idx, val, 12, 64)
    want = tsp.spmspv_bind(prep, 12, impl="ref")((xi, xv))
    fns = {impl: tsp.spmspv_bind(prep, 12, impl=impl) for impl in ("ref", "cuda")}

    class Unreadable:
        def __getattr__(self, name):
            raise AssertionError(f"a request read col_len_np.{name}")

        def __getitem__(self, key):
            raise AssertionError("a request read col_len_np")

        def __array__(self, *args, **kwargs):
            raise AssertionError("a request read col_len_np")

    prep["col_len_np"] = prep["top_len_np"] = Unreadable()
    for impl, fn in fns.items():
        np.testing.assert_array_equal(bits(fn((xi, xv)).numpy()), bits(want.numpy()), impl)
    plan = tsp.scatter_plan(carried(jsp.spmspv_prepare(j_csr_from_dense(d))), 12)
    op = tsp.SparseStager(prep, plan)(xi, xv)
    assert not op["flags"].any() and op["flags"].numel() == plan.flag_words == 4
    np.testing.assert_array_equal(op["xi"].numpy(), xi)
    np.testing.assert_array_equal(bits(op["xv"].numpy()), bits(xv))


def test_python_mirrors_the_kernel_constants():
    """The launch shapes the host fixes (scatter_plan, row_tiles, sort_cap)
    and the numpy walk read the kernel's constants from their Python
    mirrors: each equals its constexpr in csrc/spmspv_scatter.cu, and each
    pass in SCATTER_PASSES is a kernel there."""
    import pathlib
    import re

    src = (pathlib.Path(tsp.__file__).parent / "csrc" / "spmspv_scatter.cu").read_text()
    known = {}
    for name, expr in re.findall(r"constexpr (?:int|unsigned) (k\w+) = ([^;]+);", src):
        try:
            known[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(known))
        except (NameError, SyntaxError):
            continue
    assert known["kScanSlots"] == tsp.SCATTER_SCAN_SLOTS
    assert 1 << known["kGrainShift"] == tsp.SCATTER_GRAIN
    assert 1 << known["kMaxChunkShift"] == tsp.SCATTER_MAX_CHUNK
    assert known["kTargetChunks"] == tsp.SCATTER_TARGET_CHUNKS
    assert known["kMaxTiles"] == tsp.SCATTER_MAX_TILES
    assert 1 << known["kSortShift"] == tsp.SCATTER_SMEM_TILE_ROWS
    assert known["kSortBytes"] == tsp.SCATTER_SORT_BYTES
    assert known["kDigitMax"] == tsp.SCATTER_SORT_DIGIT_BITS
    assert (tsp.SCATTER_SMEM_TILE_ROWS.bit_length() - 1) - (
        tsp.SCATTER_SMEM_TILE_ROWS.bit_length() - 1) // 2 <= tsp.SCATTER_SORT_DIGIT_BITS
    for p in tsp.SCATTER_PASSES:
        assert re.search(rf"\bspmspv_scatter_{p}\(", src), p
    launched = re.findall(r"(spmspv_scatter_[a-z]+)(?:<\w+>)?<<<", src)
    assert [n.removeprefix("spmspv_scatter_") for n in dict.fromkeys(launched)] == list(
        tsp.SCATTER_PASSES)  # in launch order (sum in either of its two forms)


def test_scatter_and_bind_refuse_bad_operands():
    prep = tsp.spmspv_prepare(csr_from_dense(rand_dense(7, m=16, n=16)), device="cpu")
    xi, xv = tsp.pad_sparse_rhs(np.arange(3), np.ones(3, np.float32), 4, 16)
    op = tsp.stage_sparse(prep, xi, xv)
    args = (op["xi"], op["xv"], op["flags"], op["plan"])
    with pytest.raises(ValueError, match=r"must be \(4,\), \(4,\) and \(4,\)"):
        tsp.spmspv_scatter(prep, op["xi"], op["xv"][:3], *args[2:])
    with pytest.raises(ValueError, match="stage_sparse"):
        tsp.spmspv_scatter(prep, *args[:2], op["flags"][:2], op["plan"])
    with pytest.raises(ValueError, match="stage_sparse"):
        tsp.spmspv_scatter(prep, *args[:3], tsp.scatter_plan(prep, 5))
    other = tsp.spmspv_prepare(csr_from_dense(rand_dense(7, m=20, n=16)), device="cpu")
    with pytest.raises(ValueError, match="20-row operator"):
        tsp.spmspv_scatter(other, *args)
    with pytest.raises(ValueError, match="B >= 1"):
        tsp.scatter_plan(prep, 0)
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

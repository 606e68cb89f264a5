"""Kernel modules of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain versions; they are
fed the very arrays ``repro``'s prepare built (carried across with
``repro_torch.interop``) and held against ``repro``'s kernels in interpret
mode, and against a float64 dense oracle.  Tolerance per row i:
|port - repro| <= 1e-5 * (|A| |x|)_i, since only the summation order
differs.  The port's own prepare must produce the same arrays as
``repro``'s.  Tests marked ``gpu`` hold each CUDA kernel against its plain
version on a card: they are in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import interop
from repro_torch.core import formats as tf
from repro_torch.core.spmv import csr_prepare, spmm_csr, spmv_csr
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sell_spmv import (
    sell_spmv,
    sell_spmv_plain,
    stages_x_in_smem,
)

# Small shapes: one torch thread keeps the parallel workers from
# oversubscribing the CPU under timing-sensitive neighbours.
torch.set_num_threads(1)

TOL = 1e-5


def rand_dense(seed, m=160, n=144, density=0.08):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(
        np.float32
    )
    d[m // 3] = 0.0  # an empty row
    return d


def assert_rowtol(got, ref, d, x, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(d.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(got - ref)
    assert got.shape == ref.shape, what
    assert np.all(err <= TOL * scale), (what, float((err - TOL * scale).max()))


def assert_same_arrays(jprep, tprep, keys):
    for key in keys:
        np.testing.assert_array_equal(
            np.asarray(jprep[key]), tprep[key].numpy(), err_msg=key
        )


# ---------------------------------------------------------------------------
# SELL, x resident (sell_spmv_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_tile,sigma", [(8, 64), (16, 1)])
def test_sell_spmv_matches_pallas_kernel(chunk_tile, sigma):
    d = rand_dense(1)
    x = np.random.default_rng(2).standard_normal(d.shape[1]).astype(np.float32)
    ja = jf.csr_from_dense(d)
    jprep = jops.sell_prepare(jf.sell_from_csr(ja, C=8, sigma=sigma, width_align=8),
                              chunk_tile)
    y_pallas = np.asarray(jops.sell_spmv(jprep, jnp.asarray(x)))
    arrays, meta = interop.split(jprep)
    tprep = interop.prep_from_arrays("sell", arrays, meta, "cpu")
    xt = torch.as_tensor(x)
    y_port = tops.sell_spmv(tprep, xt).numpy()
    assert_rowtol(y_port, y_pallas, d, x, "port vs pallas")
    assert_rowtol(y_port, d.astype(np.float64) @ x, d, x, "port vs f64")
    own = tops.sell_prepare(
        tf.sell_from_csr(tf.csr_from_dense(d), C=8, sigma=sigma, width_align=8),
        chunk_tile, device="cpu",
    )
    assert_same_arrays(jprep, own, ("cols", "vals", "row_perm"))
    assert own["cols"].shape[0] % chunk_tile == 0
    # The oracles agree: sorted-row sums, un-permuted by the caller.
    sums = tref.sell_spmv_ref(own["cols"], own["vals"], xt).numpy()
    jsums = np.asarray(jref.sell_spmv_ref(jprep["cols"], jprep["vals"], jnp.asarray(x)))
    np.testing.assert_allclose(sums, jsums, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Column slabs over one shared permutation (sell_spmv_blocked_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_slabs", [1, 3])
def test_sell_blocked_stacked_matches_pallas_kernel(n_slabs):
    d = rand_dense(3, n=150)
    x = np.random.default_rng(4).standard_normal(d.shape[1]).astype(np.float32)
    jprep = jops.sell_prepare_blocked_stacked(jf.csr_from_dense(d), n_slabs)
    y_pallas = np.asarray(jops.sell_spmv_blocked_stacked(jprep, jnp.asarray(x)))
    arrays, meta = interop.split(jprep)
    tprep = interop.prep_from_arrays("sell_blocked_stacked", arrays, meta, "cpu")
    y_port = tops.sell_spmv_blocked_stacked(tprep, torch.as_tensor(x)).numpy()
    assert_rowtol(y_port, y_pallas, d, x, "port vs pallas")
    assert_rowtol(y_port, d.astype(np.float64) @ x, d, x, "port vs f64")
    own = tops.sell_prepare_blocked_stacked(tf.csr_from_dense(d), n_slabs,
                                            device="cpu")
    assert_same_arrays(jprep, own, ("cols", "vals", "row_perm"))
    assert own["slab_n"] == jprep["slab_n"]


def test_sell_prepare_blocked_equals_reference_split_and_loop():
    """The per-slab split (the sell_blocked/ref tier) builds the same arrays
    as both of the JAX package's splits, the vectorized one and the
    original python row loop."""
    d = ((np.random.default_rng(3).random((48, 96)) < 0.12)
         * np.random.default_rng(4).standard_normal((48, 96))).astype(np.float32)
    d[10:20] = 0.0  # a run of empty rows
    d[:, 60:] = 0.0  # empty trailing slabs
    ja, ta = jf.csr_from_dense(d), tf.csr_from_dense(d)
    x = np.random.default_rng(5).standard_normal(96).astype(np.float32)
    for n_slabs in (1, 3, 5):
        fast = jops.sell_prepare_blocked(ja, n_slabs, chunk_tile=8, C=8, sigma=16)
        slow = jops._sell_prepare_blocked_loop(ja, n_slabs, chunk_tile=8, C=8,
                                               sigma=16)
        own = tops.sell_prepare_blocked(ta, n_slabs, chunk_tile=8, C=8, sigma=16,
                                        device="cpu")
        np.testing.assert_array_equal(own["bounds"], fast["bounds"])
        assert len(own["slabs"]) == len(fast["slabs"]) == len(slow["slabs"])
        for s, (o, f, w) in enumerate(zip(own["slabs"], fast["slabs"], slow["slabs"])):
            assert_same_arrays(f, o, ("cols", "vals", "row_perm"))
            assert_same_arrays(w, o, ("cols", "vals", "row_perm"))
        y = tops.sell_spmv_blocked(own, torch.as_tensor(x)).numpy()
        assert_rowtol(y, d.astype(np.float64) @ x, d, x, f"n_slabs={n_slabs}")
        carried = interop.prep_from_arrays("sell_blocked", *interop.split(fast), "cpu")
        y2 = tops.sell_spmv_blocked(carried, torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(y, y2)


def test_sell_blocked_slabs_with_zero_nonzeros_and_empty_matrix():
    rng = np.random.default_rng(0)
    d = np.zeros((32, 64), np.float32)
    d[:, :16] = ((rng.random((32, 16)) < 0.3)
                 * rng.standard_normal((32, 16))).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    a = tf.csr_from_dense(d)
    y = tops.sell_spmv_blocked(tops.sell_prepare_blocked(a, 4, device="cpu"),
                               torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, d @ x, atol=1e-4)
    stacked = tops.sell_prepare_blocked_stacked(a, 4, device="cpu")
    y2 = tops.sell_spmv_blocked_stacked(stacked, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y2, d @ x, atol=1e-4)
    empty = tf.csr_from_dense(np.zeros((16, 24), np.float32))
    for prep, fn in (
        (tops.sell_prepare_blocked(empty, 3, device="cpu"), tops.sell_spmv_blocked),
        (tops.sell_prepare_blocked_stacked(empty, 3, device="cpu"),
         tops.sell_spmv_blocked_stacked),
    ):
        np.testing.assert_array_equal(fn(prep, torch.ones(24)).numpy(), np.zeros(16))


# ---------------------------------------------------------------------------
# BCSR (bcsr_spmm_pallas)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block", [(8, 8), (8, 16), (8, 128)])
def test_bcsr_spmm_matches_pallas_kernel(block):
    d = rand_dense(5, m=150, n=140, density=0.1)
    d[8:16] = 0.0  # an empty block row
    ja = jf.csr_from_dense(d)
    jprep = jops.bcsr_prepare(jf.bcsr_from_csr(ja, block))
    arrays, meta = interop.split(jprep)
    tprep = interop.prep_from_arrays("bcsr", arrays, meta, "cpu")
    own = tops.bcsr_prepare(tf.bcsr_from_csr(tf.csr_from_dense(d), block), "cpu")
    assert_same_arrays(jprep, own, ("block_rows", "block_cols", "blocks"))
    np.testing.assert_array_equal(own["indptr"].numpy(), tprep["indptr"].numpy())
    gm = own["grid_shape"][0]
    assert own["indptr"][-1] == own["blocks"].shape[0]
    assert bool((own["indptr"][1:] > own["indptr"][:-1]).all())  # fill-in: none empty
    assert own["indptr"].shape == (gm + 1,)
    for k in (1, 16):
        X = np.random.default_rng(k).standard_normal((d.shape[1], k)).astype(np.float32)
        y_pallas = np.asarray(jops.bcsr_spmm(jprep, jnp.asarray(X), n_tile=min(128, k)))
        y_port = tops.bcsr_spmm(tprep, torch.as_tensor(X)).numpy()
        for j in range(k):
            assert_rowtol(y_port[:, j], y_pallas[:, j], d, X[:, j], f"k={k} col {j}")
            assert_rowtol(y_port[:, j], d.astype(np.float64) @ X[:, j], d, X[:, j])


def test_bcsr_ref_oracles_agree():
    d = rand_dense(6, m=40, n=48, density=0.2)
    b = tf.bcsr_from_csr(tf.csr_from_dense(d), (8, 16))
    X = np.random.default_rng(7).standard_normal((48, 4)).astype(np.float32)
    xb = X.reshape(3, 16, 4)
    got = tref.bcsr_spmm_ref(torch.as_tensor(b.blocks), b.block_rows, b.block_cols,
                             torch.as_tensor(xb), 5).numpy()
    want = np.asarray(jref.bcsr_spmm_ref(jnp.asarray(b.blocks), b.block_rows,
                                         b.block_cols, jnp.asarray(xb), 5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reshape(40, 4), d @ X, atol=1e-4)


def test_bcsr_all_empty_and_some_empty_block_rows():
    a = tf.csr_from_dense(np.zeros((16, 16), np.float32))
    b = tf.bcsr_from_csr(a, (8, 8))
    assert b.n_blocks == 0
    prep = tops.bcsr_prepare(b, "cpu")
    assert prep["blocks"].shape[0] == 2  # one zero fill-in block per row
    X = np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32)
    np.testing.assert_array_equal(tops.bcsr_spmm(prep, torch.as_tensor(X)).numpy(),
                                  np.zeros((16, 4)))
    rng = np.random.default_rng(2)
    d = np.zeros((40, 24), np.float32)
    for r0 in (0, 16, 24):
        d[r0 : r0 + 8] = ((rng.random((8, 24)) < 0.4)
                          * rng.standard_normal((8, 24))).astype(np.float32)
    prep = tops.bcsr_prepare(tf.bcsr_from_csr(tf.csr_from_dense(d), (8, 8)), "cpu")
    X = rng.standard_normal((24, 8)).astype(np.float32)
    np.testing.assert_allclose(tops.bcsr_spmm(prep, torch.as_tensor(X)).numpy(),
                               d @ X, atol=1e-4)


# ---------------------------------------------------------------------------
# CSR rows (the csr/vector tier's prepared row map and edges)
# ---------------------------------------------------------------------------
def test_csr_empty_matrix_and_trailing_empty_rows():
    a = tf.csr_from_dense(np.zeros((5, 7), np.float32))
    prep = csr_prepare(a, "cpu")
    np.testing.assert_array_equal(prep["offsets"].numpy(), np.zeros(6))
    np.testing.assert_array_equal(spmv_csr(prep, torch.ones(7), n_rows=5).numpy(),
                                  np.zeros(5))
    d = np.zeros((6, 4), np.float32)
    d[0, 1] = 2.0
    d[2, 3] = -1.0  # rows 1, 3, 4, 5 empty; a trailing run of empties
    prep = csr_prepare(tf.csr_from_dense(d), "cpu")
    np.testing.assert_array_equal(prep["offsets"].numpy(), [0, 1, 1, 2, 2, 2, 2])
    x = np.arange(1, 5, dtype=np.float32)
    np.testing.assert_allclose(spmv_csr(prep, torch.as_tensor(x), n_rows=6).numpy(),
                               d @ x)
    X = np.stack([x, -x], axis=1)
    np.testing.assert_allclose(spmm_csr(prep, torch.as_tensor(X), n_rows=6).numpy(),
                               d @ X)


def test_wrappers_reject_nothing_on_cpu_and_count_no_cpu_launches():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    _build.reset_launches()
    d = rand_dense(8, m=24, n=20, density=0.3)
    a = tf.csr_from_dense(d)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(20).astype(np.float32))
    p = tops.sell_prepare(tf.sell_from_csr(a, width_align=8), device="cpu")
    np.testing.assert_array_equal(
        sell_spmv(p["cols"], p["vals"], x, p["row_perm"], n_rows=24).numpy(),
        sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"], 24).numpy())
    assert sum(_build.LAUNCHES.values()) == 0
    assert stages_x_in_smem(57_856) and not stages_x_in_smem(57_857)

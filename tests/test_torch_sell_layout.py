"""The slot-major SELL layout of the port against the JAX package.

The port stores SELL ``cols``/``vals`` as (n_chunks, W, 8) in memory and
hands out the logical (n_chunks, 8, W) view; beside them, ``chunk_w``
(n_chunks,) says how many slots of each chunk the CUDA kernel reads.  The
view must equal ``repro``'s prepared arrays value for value (from the
port's own prepare and carried across with ``repro_torch.interop``), the
widths must be each chunk's last stored slot + 1, the plain version on the
view must agree with ``repro``'s Pallas kernel in interpret mode, and the
SELL candidates must still match ``repro`` and a float64 oracle.
Tolerance per row i: |port - repro| <= 1e-5 * (|A| |x|)_i, since only the
summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jt
from repro.core import formats as jf
from repro.kernels import ops as jops
from repro.kernels.sell_spmv import sell_spmv_pallas

import repro_torch.tune as tt
from repro_torch import interop
from repro_torch.core import formats as tf
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sell_spmv import sell_spmv, sell_spmv_plain

torch.set_num_threads(1)

TOL = 1e-5


def _dense(seed, m=150, n=120):
    """Rows of very different lengths, a run of empty rows (whole empty
    chunks after the sigma sort) and one long row."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n), np.float32)
    for r, cnt in enumerate(rng.integers(0, 14, size=m)):
        d[r, rng.choice(n, size=cnt, replace=False)] = rng.standard_normal(cnt)
    d[40:60] = 0.0
    d[7, :37] = rng.standard_normal(37)
    return d


def _assert_rowtol(got, ref, d, x, what=""):
    scale = np.abs(d.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= TOL * scale), (what, float((err - TOL * scale).max()))


def _slot_major(t):
    """A (n_chunks, 8, W) view over (n_chunks, W, 8) storage, no copy."""
    return (t.dim() == 3 and t.transpose(1, 2).is_contiguous()
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


@pytest.mark.parametrize("chunk_tile,sigma,width_align", [(8, 64, 8), (16, 1, 1)])
def test_prepared_view_equals_repro_value_for_value(chunk_tile, sigma, width_align):
    d = _dense(1)
    jprep = jops.sell_prepare(
        jf.sell_from_csr(jf.csr_from_dense(d), C=8, sigma=sigma,
                         width_align=width_align), chunk_tile)
    own = tops.sell_prepare(
        tf.sell_from_csr(tf.csr_from_dense(d), C=8, sigma=sigma,
                         width_align=width_align), chunk_tile, device="cpu")
    carried = interop.prep_from_arrays("sell", *interop.split(jprep), "cpu")
    for prep in (own, carried):
        for key in ("cols", "vals"):
            assert _slot_major(prep[key]), key
            np.testing.assert_array_equal(prep[key].numpy(), np.asarray(jprep[key]),
                                          err_msg=key)
        np.testing.assert_array_equal(prep["row_perm"].numpy(),
                                      np.asarray(jprep["row_perm"]))
        assert prep["chunk_w"].dtype == torch.int32
        assert prep["chunk_w"].shape == (prep["cols"].shape[0],)
    np.testing.assert_array_equal(own["chunk_w"].numpy(), carried["chunk_w"].numpy())


def test_chunk_widths_are_each_chunks_last_stored_slot():
    """chunk_w is the chunk's widest row; a stored (0, 0.0) at a chunk's
    end counts as padding, as slab_chunk_widths has it."""
    d = _dense(2)
    a = tf.csr_from_dense(d)
    sell = tf.sell_from_csr(a, C=8, sigma=64, width_align=8)
    p = tops.sell_prepare(sell, 8, device="cpu")
    n_real = sell.n_chunks
    cw = p["chunk_w"].numpy()
    np.testing.assert_array_equal(cw[:n_real], sell.chunk_width)
    assert np.all(cw[n_real:] == 0) and (cw == 0).sum() >= 2  # empty chunks
    assert cw.max() == 37 and p["cols"].shape[2] == 40
    # Row 70, the widest of its sigma window (so of its chunk), gets a
    # stored (column 0, value 0.0) past its last entry: padding.
    d[70] = 0.0
    d[70, 1:31] = 1.5
    a = tf.csr_from_dense(d)
    indptr, indices, data = a.indptr.copy(), a.indices.tolist(), a.data.tolist()
    indices.insert(int(indptr[71]), 0)
    data.insert(int(indptr[71]), 0.0)
    indptr[71:] += 1
    b = tf.CSRMatrix(a.shape, indptr, np.array(indices, np.int32),
                     np.array(data, np.float32))
    sb = tf.sell_from_csr(b, C=8, sigma=64, width_align=8)
    pb = tops.sell_prepare(sb, 8, device="cpu")
    chunk = int(np.nonzero(sb.row_perm == 70)[0][0]) // 8
    assert sb.chunk_width[chunk] == 31  # the row's 30 entries and the stored zero
    assert pb["chunk_w"][chunk] == 30
    carried = interop.prep_from_arrays(
        "sell", {"cols": sb.cols, "vals": sb.vals, "row_perm": sb.row_perm},
        {"shape": sb.shape}, "cpu")
    np.testing.assert_array_equal(carried["chunk_w"].numpy(),
                                  pb["chunk_w"][:sb.n_chunks].numpy())


@pytest.mark.parametrize("sigma", [1, 64])
def test_plain_on_view_equals_pallas_after_unpermute(sigma):
    d = _dense(3)
    x = np.random.default_rng(4).standard_normal(d.shape[1]).astype(np.float32)
    jprep = jops.sell_prepare(
        jf.sell_from_csr(jf.csr_from_dense(d), C=8, sigma=sigma, width_align=8), 8)
    sums = np.asarray(sell_spmv_pallas(jprep["cols"], jprep["vals"], jnp.asarray(x),
                                       chunk_tile=8, interpret=True))
    perm = np.asarray(jprep["row_perm"])
    y_pallas = np.zeros(d.shape[0], np.float32)
    y_pallas[perm[perm >= 0]] = sums[perm >= 0]
    p = interop.prep_from_arrays("sell", *interop.split(jprep), "cpu")
    _build.reset_launches()
    xt = torch.as_tensor(x)
    y = sell_spmv_plain(p["cols"], p["vals"], xt, p["row_perm"], d.shape[0]).numpy()
    y_wrap = sell_spmv(p["cols"], p["vals"], xt, p["row_perm"], n_rows=d.shape[0],
                       chunk_w=p["chunk_w"]).numpy()
    assert sum(_build.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(y_wrap, y)
    _assert_rowtol(y, y_pallas, d, x, "plain vs pallas")
    _assert_rowtol(y, d.astype(np.float64) @ x, d, x, "plain vs f64")


def test_sell_candidates_match_repro_and_f64_oracle():
    d = _dense(5)
    ja, ta = jf.csr_from_dense(d), tf.csr_from_dense(d)
    x = np.random.default_rng(6).standard_normal(d.shape[1]).astype(np.float32)
    want = d.astype(np.float64) @ x
    for c in (tt.make("sell", "cuda", C=8, sigma=64, chunk_tile=8),
              tt.make("sell", "ref", C=8, sigma=64),
              tt.make("sell_blocked", "ref", C=8, sigma=64, n_slabs=3)):
        prep = tt.prepare(ta, c, device="cpu")
        if c.fmt == "sell":
            assert _slot_major(prep["cols"]) and _slot_major(prep["vals"])
        else:  # one slot-major SELL per column slab
            assert all(_slot_major(s["cols"]) for s in prep["slabs"])
        op = tt.SparseOperator.from_candidate(ta, c, device="cpu")
        got = (op @ torch.as_tensor(x)).numpy()
        jc = jt.make(c.fmt, c.impl.replace("cuda", "pallas"), **c.param_dict)
        ref = np.asarray(jt.SparseOperator.from_candidate(ja, jc) @ jnp.asarray(x))
        _assert_rowtol(got, ref, d, x, f"{c.key()} vs repro")
        _assert_rowtol(got, want, d, x, f"{c.key()} vs f64")


def test_wrapper_refuses_row_major_operand():
    d = _dense(7)
    p = tops.sell_prepare(tf.sell_from_csr(tf.csr_from_dense(d), width_align=8),
                          device="cpu")
    x = torch.ones(d.shape[1])
    for key in ("cols", "vals"):
        args = dict(cols=p["cols"], vals=p["vals"])
        args[key] = p[key].contiguous()  # the same values, stored row-major
        assert args[key].is_contiguous()
        with pytest.raises(ValueError, match=f"{key} .* slot-major SELL view.*"
                                             "ops.sell_prepare"):
            sell_spmv(args["cols"], args["vals"], x, p["row_perm"],
                      n_rows=d.shape[0], chunk_w=p["chunk_w"])
    with pytest.raises(ValueError, match="one width per chunk"):
        sell_spmv(p["cols"], p["vals"], x, p["row_perm"], n_rows=d.shape[0],
                  chunk_w=p["chunk_w"][1:])

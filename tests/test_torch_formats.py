"""The port's host formats, suite generators, metrics and fingerprint equal
the JAX package's on the same inputs — byte for byte where they are arrays."""
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import metrics as jm
from repro.data import suite as js
from repro.tune.plan import fingerprint as j_fingerprint

from repro_torch.core import formats as tf
from repro_torch.core import metrics as tm
from repro_torch.data import suite as ts
from repro_torch.tune.plan import fingerprint as t_fingerprint

# Small shapes: one torch thread keeps the parallel workers from
# oversubscribing the CPU under timing-sensitive neighbours.
torch.set_num_threads(1)

SCALE = 1 / 256


def _same(a, b, what):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)
    assert a.tobytes() == b.tobytes(), what


def test_suite_tables_match():
    assert [dataclass_tuple(s) for s in ts.SUITE] == [
        dataclass_tuple(s) for s in js.SUITE
    ]


def dataclass_tuple(spec):
    return (spec.idx, spec.name, spec.n_rows, spec.nnz, spec.family, spec.band,
            spec.max_row)


@pytest.mark.parametrize("name", [s.name for s in js.SUITE])
def test_suite_matrix_byte_identical_with_equal_fingerprint(name):
    a = js.generate(name, scale=SCALE)
    b = ts.generate(name, scale=SCALE)
    assert a.shape == b.shape
    for key in ("indptr", "indices", "data"):
        _same(getattr(a, key), getattr(b, key), f"{name}.{key}")
    assert t_fingerprint(b) == j_fingerprint(a)
    assert tm.ucld(b) == jm.ucld(a)
    assert tm.utd(b) == jm.utd(a)
    assert tm.matrix_bandwidth(b) == jm.matrix_bandwidth(a)
    m, n = b.shape
    assert tm.spmv_app_bytes(m, n, b.nnz) == jm.spmv_app_bytes(m, n, a.nnz)
    assert tm.spmm_app_bytes(m, n, b.nnz, 16) == jm.spmm_app_bytes(m, n, a.nnz, 16)


def test_generate_suite_covers_every_matrix():
    got = ts.generate_suite(scale=1 / 1024, seed=1)
    assert list(got) == [s.name for s in js.SUITE]
    ref = js.generate("cant", scale=1 / 1024, seed=1)
    _same(got["cant"].indices, ref.indices, "cant seed 1")


@pytest.mark.parametrize("name", ["cant", "scircuit", "pdb1HYS"])
def test_sell_and_bcsr_host_arrays_byte_identical(name):
    a = js.generate(name, scale=SCALE)
    b = ts.generate(name, scale=SCALE)
    for C, sigma, align in ((8, 1, 1), (8, 64, 8), (8, 256, 8)):
        sa = jf.sell_from_csr(a, C=C, sigma=sigma, width_align=align)
        sb = tf.sell_from_csr(b, C=C, sigma=sigma, width_align=align)
        for key in ("cols", "vals", "row_perm", "chunk_width"):
            _same(getattr(sa, key), getattr(sb, key), f"sell {sigma} {key}")
    for block in ((8, 8), (8, 16), (8, 128)):
        ba = jf.bcsr_from_csr(a, block)
        bb = tf.bcsr_from_csr(b, block)
        for key in ("indptr", "block_cols", "block_rows", "blocks"):
            _same(getattr(ba, key), getattr(bb, key), f"bcsr {block} {key}")
        assert bb.fill_ratio() == ba.fill_ratio()
    _same(jf.nnz_row_ids(a.indptr), tf.nnz_row_ids(b.indptr), "nnz_row_ids")


def test_dense_coo_round_trips_and_to_device():
    rng = np.random.default_rng(0)
    d = ((rng.random((13, 9)) < 0.3) * rng.standard_normal((13, 9))).astype(
        np.float32
    )
    a, b = jf.csr_from_dense(d), tf.csr_from_dense(d)
    for key in ("indptr", "indices", "data"):
        _same(getattr(a, key), getattr(b, key), key)
    np.testing.assert_array_equal(tf.csr_to_dense(b), d)
    np.testing.assert_array_equal(
        tf.sell_to_dense(tf.sell_from_csr(b, sigma=4)), d
    )
    np.testing.assert_array_equal(tf.bcsr_to_dense(tf.bcsr_from_csr(b, (8, 8))), d)
    rows = rng.integers(0, 13, 40)
    cols = rng.integers(0, 9, 40)  # duplicates are summed
    vals = rng.standard_normal(40).astype(np.float32)
    ca = jf.csr_from_coo((13, 9), rows, cols, vals)
    cb = tf.csr_from_coo((13, 9), rows, cols, vals)
    for key in ("indptr", "indices", "data"):
        _same(getattr(ca, key), getattr(cb, key), f"coo {key}")
    dev = b.to_device("cpu")
    assert set(dev) == {"indptr", "indices", "data"}
    assert all(isinstance(v, torch.Tensor) for v in dev.values())
    assert dev["indices"].dtype == torch.int32
    np.testing.assert_array_equal(dev["data"].numpy(), b.data)

"""The port's traffic model (``core.traffic``: the paper's Fig 6 cache
counts and the sharded analogue), the paper-figure metrics of
``core.metrics`` and ``configs.sparse_suite`` against the JAX package's,
on seeded smoke-scale suite matrices.  Everything here is host integer or
float arithmetic on equal inputs, so every value must be equal, bit for
bit."""
import dataclasses

import numpy as np
import pytest

from repro.configs import sparse_suite as jsuite_cfg
from repro.core import formats as jf
from repro.core import metrics as jm
from repro.core import traffic as jt
from repro.data import suite as js

from repro_torch.configs import sparse_suite as tsuite_cfg
from repro_torch.core import formats as tf
from repro_torch.core import metrics as tm
from repro_torch.core import traffic as tt
from repro_torch.data import suite as ts

SCALE = 1 / 256
NAMES = ["cant", "scircuit", "webbase-1M", "torso1"]


def _pair(name):
    a, b = js.generate(name, scale=SCALE, seed=3), ts.generate(name, scale=SCALE, seed=3)
    np.testing.assert_array_equal(a.indices, b.indices)
    return a, b


def _same(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype, what
    assert x.tobytes() == y.tobytes(), what


@pytest.mark.parametrize("name", NAMES)
def test_vector_lines_per_core_infinite_and_lru(name):
    a, b = _pair(name)
    for kw in ({}, {"n_cores": 7, "chunk": 16, "line_width": 4},
               {"cache_lines": 8192}, {"cache_lines": 16, "n_cores": 5}):
        _same(jt.vector_lines_per_core(a, **kw), tt.vector_lines_per_core(b, **kw), str(kw))
    # the small LRU refetches lines: the model's count is not the infinite one
    lru = tt.vector_lines_per_core(b, n_cores=5, cache_lines=16)
    assert lru.sum() >= tt.vector_lines_per_core(b, n_cores=5).sum()


@pytest.mark.parametrize("name", NAMES)
def test_actual_bytes_vector_access_and_shards(name):
    a, b = _pair(name)
    for kw in ({}, {"cache_lines": 64, "val_bytes": 8}):
        assert jt.actual_spmv_bytes(a, **kw) == tt.actual_spmv_bytes(b, **kw)
        assert type(tt.actual_spmv_bytes(b, **kw)) is int
    assert jt.vector_access_multiplier(a) == tt.vector_access_multiplier(b)
    for n_shards in (1, 3, 4, 8):
        assert jt.shard_vector_access(a, n_shards) == tt.shard_vector_access(b, n_shards)


@pytest.mark.parametrize("name", NAMES)
def test_block_fill_histogram_and_byte_models(name):
    a, b = _pair(name)
    for block in ((8, 8), (8, 128), (16, 16)):
        for bins in (10, 4):
            _same(jm.block_fill_histogram(jf.bcsr_from_csr(a, block), bins),
                  tm.block_fill_histogram(tf.bcsr_from_csr(b, block), bins), f"{block}")
    m, n = b.shape
    for vb, ib in ((4, 4), (8, 4), (2, 4)):
        assert jm.spmv_naive_bytes(b.nnz, vb, ib) == tm.spmv_naive_bytes(b.nnz, vb, ib)
        assert jm.flop_to_byte_spmv(vb, ib) == tm.flop_to_byte_spmv(vb, ib)
        for k in (1, 4, 16, 64):
            assert (jm.flop_to_byte_spmm(m, n, b.nnz, k, vb, ib)
                    == tm.flop_to_byte_spmm(m, n, b.nnz, k, vb, ib))


def test_sparse_suite_config_equals_the_references():
    for attr in ("CONFIG", "SMALL"):
        assert (dataclasses.asdict(getattr(tsuite_cfg, attr))
                == dataclasses.asdict(getattr(jsuite_cfg, attr)))
    assert ([f.name for f in dataclasses.fields(tsuite_cfg.SparseSuiteConfig)]
            == [f.name for f in dataclasses.fields(jsuite_cfg.SparseSuiteConfig)])
    assert tsuite_cfg.SparseSuiteConfig(scale=0.5) == tsuite_cfg.SparseSuiteConfig(scale=0.5)

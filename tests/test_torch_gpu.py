"""Each CUDA kernel against its plain torch version on a card.

Marked ``gpu``: the fixture skips them when no CUDA device is visible.  The
file imports nothing of JAX, so it also runs on a machine with a card and
no JAX:  ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerance per row i: |kernel - plain| <= 1e-5 * (|A| |x|)_i, since only the
summation order differs.  The scatter's atomics reorder each row's k_i
terms, so for it the limit is the larger of that and k_i * 2**-24 *
(|A| |x|)_i, the worst case of a reordered float32 sum.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import formats as tf
from repro_torch.data.suite import generate
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain
from repro_torch.kernels.spmspv import (
    expand_products,
    pad_sparse_rhs,
    spmspv_prepare,
    spmspv_scatter,
    spmspv_scatter_plain,
    work_bucket,
)
from repro_torch.tune import PlanCache, SparseOperator, make
from repro_torch.kernels.sell_spmv import (
    sell_spmv,
    sell_spmv_blocked,
    sell_spmv_blocked_plain,
    sell_spmv_plain,
    stages_x_in_smem,
)

TOL = 1e-5


def assert_rowtol(got, ref, a, x, what="", terms=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    abs_a = sp.csr_matrix((np.abs(a.data).astype(np.float64), a.indices, a.indptr),
                          shape=a.shape)
    scale = abs_a @ np.abs(np.asarray(x, np.float64))
    rel = TOL if terms is None else np.maximum(TOL, np.asarray(terms) * 2.0**-24)
    err = np.abs(got - ref)
    assert got.shape == ref.shape, what
    assert np.all(err <= rel * scale), (what, float((err - rel * scale).max()))


# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on a card")
    return torch.device("cuda")


def _gpu_case(scale=1 / 16):
    a = generate("cant", scale=scale)
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    return a, x


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_tile", [8, 16])
def test_gpu_sell_kernel_matches_plain(cuda_device, chunk_tile):
    a, x = _gpu_case()
    p = tops.sell_prepare(tf.sell_from_csr(a, width_align=8), chunk_tile,
                          device=cuda_device)
    xt = torch.as_tensor(x, device=cuda_device)
    y = sell_spmv(p["cols"], p["vals"], xt, p["row_perm"], n_rows=a.shape[0],
                  chunk_tile=chunk_tile)
    yp = sell_spmv_plain(p["cols"], p["vals"], xt, p["row_perm"], a.shape[0])
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)


@pytest.mark.gpu
@pytest.mark.parametrize("scale,n_slabs,path", [(1 / 16, 2, "smem"),
                                                (1 / 16, 40, "smem"),
                                                (1.0, 1, "global")])
def test_gpu_sell_blocked_kernel_matches_plain(cuda_device, scale, n_slabs, path):
    a, x = _gpu_case(scale)
    p = tops.sell_prepare_blocked_stacked(a, n_slabs, device=cuda_device)
    assert stages_x_in_smem(p["slab_n"]) == (path == "smem")
    before = _build.LAUNCHES[f"sell_spmv_blocked.{path}"]
    x_pad = torch.zeros(n_slabs * p["slab_n"], device=cuda_device)
    x_pad[: a.shape[1]] = torch.as_tensor(x, device=cuda_device)
    y = sell_spmv_blocked(p["cols"], p["vals"], x_pad, p["row_perm"],
                          n_rows=a.shape[0], slab_n=p["slab_n"])
    yp = sell_spmv_blocked_plain(p["cols"], p["vals"], x_pad, p["row_perm"],
                                 a.shape[0], p["slab_n"])
    assert _build.LAUNCHES[f"sell_spmv_blocked.{path}"] == before + 1
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(8, 8), (8, 16), (8, 128)])
def test_gpu_bcsr_kernel_matches_plain(cuda_device, block):
    a, _ = _gpu_case()
    p = tops.bcsr_prepare(tf.bcsr_from_csr(a, block), cuda_device)
    gn, bk = p["grid_shape"][1], p["block_shape"][1]
    for k in (1, 4, 16, 64):
        X = np.random.default_rng(k).standard_normal((a.shape[1], k)).astype(np.float32)
        xb = torch.zeros((gn * bk, k), device=cuda_device)
        xb[: a.shape[1]] = torch.as_tensor(X, device=cuda_device)
        xb = xb.view(gn, bk, k)
        y = bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)
        yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"], xb)
        m = a.shape[0]
        y = y.reshape(-1, k)[:m].cpu().numpy()
        yp = yp.reshape(-1, k)[:m].cpu().numpy()
        for j in range(k):
            assert_rowtol(y[:, j], yp[:, j], a, X[:, j], f"k={k}")


@pytest.mark.gpu
def test_gpu_search_raises_on_a_failing_launch(cuda_device, monkeypatch):
    """A kernel that fails to launch ends the build on a card: the search
    never hands its work to a plain tier."""
    a, _ = _gpu_case()
    _build.ensure_built()
    monkeypatch.setattr(_build, "function", lambda *args: (lambda *cargs: 1))
    cands = [make("csr", "vector"), make("sell", "cuda", C=8, sigma=64, chunk_tile=8)]
    with pytest.raises(RuntimeError, match="sell/cuda.*CUDA error 1"):
        SparseOperator.build(a, cache=PlanCache(), candidates=cands,
                             prune_factor=1e9, warmup=0, timed=1,
                             device=cuda_device)


def _sparse_case(name, frac, device):
    a = generate(name, scale=1 / 16)
    m, n = a.shape
    nx = max(1, n // frac)
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(n, size=nx, replace=False)).astype(np.int64)
    val = rng.standard_normal(nx).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[idx] = val
    prep = spmspv_prepare(a, device=device)
    xi, xv = pad_sparse_rhs(idx, val, nx, n)
    total = int(prep["col_len_np"][xi].sum())
    rows, prods = expand_products(prep, torch.as_tensor(xi, device=device),
                                  torch.as_tensor(xv, device=device),
                                  work_bucket(total, a.nnz))
    return a, x, rows, prods, total


@pytest.mark.gpu
@pytest.mark.parametrize("name,frac", [("webbase-1M", 256), ("webbase-1M", 4),
                                       ("torso1", 256), ("torso1", 4)])
def test_gpu_spmspv_scatter_matches_plain(cuda_device, name, frac):
    a, x, rows, prods, total = _sparse_case(name, frac, cuda_device)
    m = a.shape[0]
    before = _build.LAUNCHES["spmspv_scatter"]
    y = spmspv_scatter(rows, prods, m=m, total=total)
    yp = spmspv_scatter_plain(rows, prods, m, total)
    assert _build.LAUNCHES["spmspv_scatter"] == before + 1
    terms = torch.bincount(rows[:total].long(), minlength=m).cpu().numpy()
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x, name, terms=terms)
    # total = 0 launches nothing and gives exact zeros
    z = spmspv_scatter(rows, prods, m=m, total=0)
    assert _build.LAUNCHES["spmspv_scatter"] == before + 1
    assert not bool(z.any())
    # the lanes past total are never read, whatever they hold
    rows[total:] = 1
    prods[total:] = 1e30
    y2 = spmspv_scatter(rows, prods, m=m, total=total)
    assert_rowtol(y2.cpu().numpy(), yp.cpu().numpy(), a, x, name, terms=terms)


@pytest.mark.gpu
def test_gpu_spmspv_refused_launch_raises(cuda_device, monkeypatch):
    """A refused scatter launch raises, at the wrapper and in a search: the
    CUDA path never hands its work to the plain version."""
    a, _, rows, prods, total = _sparse_case("webbase-1M", 256, cuda_device)
    with pytest.raises(ValueError, match="is on cpu"):
        spmspv_scatter(rows.cpu(), prods, m=a.shape[0], total=total)
    _build.ensure_built()
    monkeypatch.setattr(_build, "function", lambda *args: (lambda *cargs: 1))
    with pytest.raises(RuntimeError, match="spmspv_scatter launch: CUDA error 1"):
        spmspv_scatter(rows, prods, m=a.shape[0], total=total)
    cands = [make("csr", "vector"), make("spmspv", "cuda", slab=4096)]
    with pytest.raises(RuntimeError, match="spmspv/cuda.*CUDA error 1"):
        SparseOperator.build(a, x_nnz=a.shape[1] // 256, cache=PlanCache(),
                             candidates=cands, prune_factor=1e9, warmup=0, timed=1,
                             device=cuda_device)

"""Each CUDA kernel against its plain torch version on a card.

Marked ``gpu``: the fixture skips them when no CUDA device is visible.  The
file imports nothing of JAX, so it also runs on a machine with a card and
no JAX:  ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Tolerance per row i: |kernel - plain| <= 1e-5 * (|A| |x|)_i, since only the
summation order differs.  The SpMSpV kernel sums each row in stream order,
as its plain version does on the CPU, so it is held to that plain version
on a CPU copy of the same operands bit for bit, and to float64 at 1e-5;
so is its plain version on the card (a stable sort by row, then one
``index_add_`` per rank within the row).
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
    SCATTER_LAUNCHES,
    SCATTER_MAX_TILES,
    SCATTER_SMEM_TILE_ROWS,
    pad_sparse_rhs,
    scatter_plan,
    sort_cap,
    spmspv_bind,
    spmspv_prepare,
    spmspv_scatter,
    spmspv_scatter_plain,
    stage_sparse,
)
from repro_torch.tune import PlanCache, SparseOperator, make
from repro_torch.kernels.sell_spmv import (
    sell_spmv,
    sell_spmv_blocked,
    sell_spmv_blocked_plain,
    sell_spmv_plain,
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
                  chunk_w=p["chunk_w"], chunk_tile=chunk_tile)
    yp = sell_spmv_plain(p["cols"], p["vals"], xt, p["row_perm"], a.shape[0])
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)


@pytest.mark.gpu
@pytest.mark.parametrize("width_align", [1, 8])
def test_gpu_sell_kernel_reads_each_chunk_to_its_width(cuda_device, width_align):
    """The slot-major SELL kernel on chunks of width 0 (a whole chunk of
    empty rows), widths that vary chunk by chunk and, with width_align=1, a
    W that is not a multiple of 8: against the plain version and the
    float64 oracle, the same bits on a second launch, padding past each
    width never read, and a row-major operand refused before any launch."""
    rng = np.random.default_rng(4)
    m, n = 700, 900
    lengths = rng.integers(1, 14, size=m)
    lengths[64:80] = 0  # sixteen empty rows in one sigma window: empty chunks
    rows = np.repeat(np.arange(m), lengths)
    cols = np.concatenate([np.sort(rng.choice(n, size=k, replace=False))
                           for k in lengths])
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, n))
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data)
    x = rng.standard_normal(n).astype(np.float32)
    p = tops.sell_prepare(tf.sell_from_csr(a, C=8, sigma=64, width_align=width_align),
                          8, device=cuda_device)
    W = p["cols"].shape[2]
    cw = p["chunk_w"].cpu().numpy()
    assert (W % 8 != 0) == (width_align == 1)
    assert (cw == 0).sum() >= 2 and len(np.unique(cw)) > 5
    xt = torch.as_tensor(x, device=cuda_device)

    def run(vals=p["vals"]):
        return sell_spmv(p["cols"], vals, xt, p["row_perm"], n_rows=m,
                         chunk_w=p["chunk_w"], chunk_tile=8)

    before = _build.LAUNCHES["sell_spmv"]
    y = run()
    assert _build.LAUNCHES["sell_spmv"] == before + 1
    assert torch.equal(y, run())
    yp = sell_spmv_plain(p["cols"], p["vals"], xt, p["row_perm"], m)
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)
    assert_rowtol(y.cpu().numpy(), A.astype(np.float64) @ x, a, x)
    w = torch.arange(W, device=cuda_device)
    poisoned = p["vals"].clone()  # keeps the slot-major strides
    poisoned.masked_fill_(w >= p["chunk_w"][:, None, None], float("nan"))
    assert poisoned.stride() == p["vals"].stride()
    assert torch.equal(run(poisoned), y)
    before = _build.LAUNCHES["sell_spmv"]
    with pytest.raises(ValueError, match="slot-major SELL view.*ops.sell_prepare"):
        sell_spmv(p["cols"].contiguous(), p["vals"], xt, p["row_perm"], n_rows=m,
                  chunk_w=p["chunk_w"])
    assert _build.LAUNCHES["sell_spmv"] == before


def _blocked_run(p, x_pad, n_rows):
    y = sell_spmv_blocked(p["cols"], p["vals"], x_pad, p["row_perm"], n_rows=n_rows,
                          slab_n=p["slab_n"], chunk_w=p["chunk_w"])
    yp = sell_spmv_blocked_plain(p["cols"], p["vals"], x_pad, p["row_perm"], n_rows,
                                 p["slab_n"], p["chunk_w"])
    return y, yp


@pytest.mark.gpu
@pytest.mark.parametrize("scale,n_slabs", [(1 / 16, 2), (1 / 16, 40), (1.0, 1)])
def test_gpu_sell_blocked_kernel_matches_plain(cuda_device, scale, n_slabs):
    a, x = _gpu_case(scale)
    p = tops.sell_prepare_blocked_stacked(a, n_slabs, device=cuda_device)
    before = _build.LAUNCHES["sell_spmv_blocked"]
    x_pad = torch.zeros(n_slabs * p["slab_n"], device=cuda_device)
    x_pad[: a.shape[1]] = torch.as_tensor(x, device=cuda_device)
    y, yp = _blocked_run(p, x_pad, a.shape[0])
    assert _build.LAUNCHES["sell_spmv_blocked"] == before + 1
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)


@pytest.mark.gpu
def test_gpu_sell_blocked_kernel_reads_each_chunk_to_its_width(cuda_device):
    """Rows whose lengths differ by slab give chunk widths that vary across
    chunks and slabs; the padding past each width is never read."""
    rng = np.random.default_rng(3)
    m, n, n_slabs = 1000, 1200, 3
    slab = -(-n // n_slabs)
    rows, cols = [], []
    for r in range(m):
        for s in range(n_slabs):
            cnt = int(rng.integers(0, 4 + 20 * ((r // 64 + s) % 3 == 0)))
            lo, hi = s * slab, min(n, (s + 1) * slab)
            cols += sorted(rng.choice(np.arange(lo, hi), size=cnt, replace=False))
            rows += [r] * cnt
    A = sp.csr_matrix((rng.standard_normal(len(rows)).astype(np.float32),
                       (rows, cols)), shape=(m, n))
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data)
    x = rng.standard_normal(n).astype(np.float32)
    p = tops.sell_prepare_blocked_stacked(a, n_slabs, device=cuda_device)
    cw = p["chunk_w"].cpu().numpy()
    assert len(np.unique(cw)) > 3 and cw.mean() < 0.75 * p["cols"].shape[3]
    assert not (cw == cw[:1]).all() and not (cw == cw[:, :1]).all()
    x_pad = torch.zeros(n_slabs * p["slab_n"], device=cuda_device)
    x_pad[:n] = torch.as_tensor(x, device=cuda_device)
    y, yp = _blocked_run(p, x_pad, m)
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)
    assert_rowtol(y.cpu().numpy(), A.astype(np.float64) @ x, a, x)
    # Poisoned padding past each chunk's width changes nothing.
    w = torch.arange(p["cols"].shape[3], device=cuda_device)
    pad = w >= p["chunk_w"][..., None, None]
    vals = p["vals"].masked_fill(pad, float("nan"))
    y2 = sell_spmv_blocked(p["cols"], vals, x_pad, p["row_perm"], n_rows=m,
                           slab_n=p["slab_n"], chunk_w=p["chunk_w"])
    assert torch.equal(y, y2)
    # Widths from elsewhere: not multiples of 4, past W, below 0.  The
    # kernel rounds each up to a multiple of 4 and clamps it to [0, W], as
    # the plain version's mask does.
    W = p["cols"].shape[3]
    odd = torch.as_tensor(rng.integers(-3, W + 9, size=cw.shape).astype(np.int32),
                          device=cuda_device)
    assert bool((odd % 4 != 0).any()) and bool((odd > W).any())
    y3 = sell_spmv_blocked(p["cols"], p["vals"], x_pad, p["row_perm"], n_rows=m,
                           slab_n=p["slab_n"], chunk_w=odd)
    yp3 = sell_spmv_blocked_plain(p["cols"], p["vals"], x_pad, p["row_perm"], m,
                                  p["slab_n"], odd)
    assert_rowtol(y3.cpu().numpy(), yp3.cpu().numpy(), a, x)


def _bcsr_case(a, block, k, device, seed):
    p = tops.bcsr_prepare(tf.bcsr_from_csr(a, block), device)
    gn, bk = p["grid_shape"][1], p["block_shape"][1]
    X = np.random.default_rng(seed).standard_normal((a.shape[1], k)).astype(np.float32)
    xb = torch.zeros((gn * bk, k), device=device)
    xb[: a.shape[1]] = torch.as_tensor(X, device=device)
    return p, X, xb.view(gn, bk, k)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(8, 8), (8, 16), (8, 128), (128, 128)])
def test_gpu_bcsr_kernel_matches_plain(cuda_device, block):
    a, _ = _gpu_case()
    m = a.shape[0]
    for k in (1, 3, 4, 16, 17, 64, 100):
        p, X, xb = _bcsr_case(a, block, k, cuda_device, k)
        y = bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)
        yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"], xb)
        y = y.reshape(-1, k)[:m].cpu().numpy()
        yp = yp.reshape(-1, k)[:m].cpu().numpy()
        for j in range(k):
            assert_rowtol(y[:, j], yp[:, j], a, X[:, j], f"{block} k={k}")


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(4, 4), (12, 8), (8, 32)])
def test_gpu_bcsr_generic_path_matches_plain(cuda_device, block):
    """Block shapes the specialised paths do not take (bm not a multiple of
    8, bk not 8, 16 or 128) run the generic kernel: held against the plain
    version, and the same bits on a second launch."""
    a, _ = _gpu_case()
    m = a.shape[0]
    for k in (1, 3, 64):
        p, X, xb = _bcsr_case(a, block, k, cuda_device, k)
        run = lambda: bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)
        before = _build.LAUNCHES["bcsr_spmm"]
        y = run()
        assert _build.LAUNCHES["bcsr_spmm"] == before + 1
        assert torch.equal(y, run()), (block, k)
        yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"], xb)
        y = y.reshape(-1, k)[:m].cpu().numpy()
        yp = yp.reshape(-1, k)[:m].cpu().numpy()
        for j in range(k):
            assert_rowtol(y[:, j], yp[:, j], a, X[:, j], f"{block} k={k}")


@pytest.mark.gpu
def test_gpu_wrappers_refuse_misaligned_operands(cuda_device):
    """The BCSR and column-slab kernels read their operands in 16-byte
    vectors: a contiguous view that does not start on a 16-byte boundary is
    refused with a ValueError before any launch, and the card still works."""
    a, x = _gpu_case()

    def shifted(t):  # the same values, one element past an aligned start
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16
        return v

    p, _, xb = _bcsr_case(a, (8, 8), 16, cuda_device, 0)
    before = _build.LAUNCHES["bcsr_spmm"]
    for blocks, x_b, name in ((shifted(p["blocks"]), xb, "blocks"),
                              (p["blocks"], shifted(xb), "x_blocked")):
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            bcsr_spmm(blocks, p["block_cols"], p["indptr"], x_b)
    q = tops.sell_prepare_blocked_stacked(a, 2, device=cuda_device)
    x_pad = torch.zeros(2 * q["slab_n"], device=cuda_device)
    x_pad[: a.shape[1]] = torch.as_tensor(x, device=cuda_device)
    for cols, vals, name in ((shifted(q["cols"]), q["vals"], "cols"),
                             (q["cols"], shifted(q["vals"]), "vals")):
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            sell_spmv_blocked(cols, vals, x_pad, q["row_perm"], n_rows=a.shape[0],
                              slab_n=q["slab_n"], chunk_w=q["chunk_w"])
    assert _build.LAUNCHES["bcsr_spmm"] == before
    y, yp = _blocked_run(q, x_pad, a.shape[0])
    assert_rowtol(y.cpu().numpy(), yp.cpu().numpy(), a, x)


@pytest.mark.gpu
def test_gpu_redesigned_kernels_are_bitwise_repeatable(cuda_device):
    """Two launches of the BCSR and column-slab kernels on the same operands
    agree bit for bit: every output is summed in a fixed order."""
    a, x = _gpu_case()
    for block in ((8, 8), (8, 128), (128, 128)):
        for k in (1, 4, 16, 64, 17):
            p, _, xb = _bcsr_case(a, block, k, cuda_device, 0)
            run = lambda: bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)
            assert torch.equal(run(), run()), (block, k)
    p = tops.sell_prepare_blocked_stacked(a, 3, device=cuda_device)
    x_pad = torch.zeros(3 * p["slab_n"], device=cuda_device)
    x_pad[: a.shape[1]] = torch.as_tensor(x, device=cuda_device)
    assert torch.equal(_blocked_run(p, x_pad, a.shape[0])[0],
                       _blocked_run(p, x_pad, a.shape[0])[0])


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
    """A suite matrix at 1/16 scale and a sparse x of n // frac entries that
    always holds the longest column (a hub spanning many blocks)."""
    a = generate(name, scale=1 / 16)
    m, n = a.shape
    nx = max(1, n // frac)
    rng = np.random.default_rng(0)
    hub = int(np.argmax(np.bincount(a.indices, minlength=n)))
    idx = np.union1d(rng.choice(n, size=nx, replace=False), [hub]).astype(np.int64)
    val = rng.standard_normal(idx.size).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[idx] = val
    prep = spmspv_prepare(a, device=device)
    xi, xv = pad_sparse_rhs(idx, val, idx.size, n)
    return a, x, prep, xi, xv


def _fused(prep, op):
    return spmspv_scatter(prep, op["xi"], op["xv"], op["flags"], op["plan"])


def _plain_on_cpu(a, op):
    """The plain version (expansion + index_add_, in stream order) on a CPU
    copy of the kernel's operands."""
    prep = spmspv_prepare(a, device="cpu")
    return spmspv_scatter_plain(prep, op["xi"].cpu(), op["xv"].cpu())


def _assert_bits(got, want, what=""):
    got = got.cpu().contiguous().view(torch.int32)
    want = want.cpu().contiguous().view(torch.int32)
    assert got.shape == want.shape, what
    assert torch.equal(got, want), (what, int((got != want).sum()))


def _sparse_checks(a, prep, xi, xv, x, what):
    """The kernel once through the request path's staging: SCATTER_LAUNCHES
    launches, bit for bit with the plain version on a CPU copy and on a
    second launch of the same staged operands, within 1e-5 of float64; the
    plain version on the card bit for bit with the CPU's too."""
    op = stage_sparse(prep, xi, xv)
    before = _build.LAUNCHES["spmspv_scatter"]
    y = _fused(prep, op)
    assert _build.LAUNCHES["spmspv_scatter"] == before + SCATTER_LAUNCHES
    yp = _plain_on_cpu(a, op)
    _assert_bits(y, yp, what)
    _assert_bits(_fused(prep, op), y, f"{what}: second launch")
    _assert_bits(spmspv_scatter_plain(prep, op["xi"], op["xv"]), yp,
                 f"{what}: the plain version on the card")
    assert_rowtol(y.cpu().numpy(), sp.csr_matrix(
        (a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape) @ x, a, x, what)
    return op, y


@pytest.mark.gpu
@pytest.mark.parametrize("name,frac", [("webbase-1M", 256), ("webbase-1M", 16),
                                       ("webbase-1M", 4), ("torso1", 256),
                                       ("torso1", 4)])
def test_gpu_spmspv_scatter_matches_plain(cuda_device, name, frac):
    """The SpMSpV kernel against its plain version (expansion + index_add_)
    on a CPU copy at three densities, the hub column included: bit for bit,
    and the same bits on a second launch; within 1e-5 of float64.  An x
    with no nonzero launches nothing."""
    a, x, prep, xi, xv = _sparse_case(name, frac, cuda_device)
    _sparse_checks(a, prep, xi, xv, x, name)
    before = _build.LAUNCHES["spmspv_scatter"]
    empty_x = spmspv_bind(prep, xi.size, impl="cuda")(
        (np.full_like(xi, a.shape[1]), np.zeros_like(xv)))
    assert not bool(empty_x.any()) and _build.LAUNCHES["spmspv_scatter"] == before


@pytest.mark.gpu
def test_gpu_spmspv_hub_row_spans_blocks_and_tiles(cuda_device):
    """A row with a product in every touched column (20 000 of them) spans
    many chunks of the stream and leaves its row tile's bucket longer than
    the shared-memory sort (the global-memory path): summed in stream
    order, bit for bit with the plain version on the CPU (and the card's),
    with -0.0 products kept out of the result's sign."""
    rng = np.random.default_rng(11)
    m, n = 50_000, 30_000
    A = sp.random(m, n, density=2e-4, random_state=3, format="lil", dtype=np.float32)
    A[17, :] = rng.standard_normal(n).astype(np.float32)  # the hub row
    A[40_000, :] = 0.0
    A[40_000, 5] = -1.0  # the row's only product below is -1.0 * +0.0
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    A.sort_indices()
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data.astype(np.float32))
    idx = np.union1d(np.sort(rng.choice(n, size=20_000, replace=False)), [5])
    val = rng.standard_normal(idx.size).astype(np.float32)
    val[np.searchsorted(idx, 5)] = 0.0
    prep = spmspv_prepare(a, device=cuda_device)
    xi, xv = pad_sparse_rhs(idx.astype(np.int64), val, idx.size, n)
    x = np.zeros(n, np.float32)
    x[idx] = val
    op, y = _sparse_checks(a, prep, xi, xv, x, "hub row")
    assert 1 << op["plan"].shift <= SCATTER_SMEM_TILE_ROWS
    assert int(y[40_000:40_001].cpu().view(torch.int32)[0]) == 0  # +0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n_hubs,per_hub,step", [(8, 8000, 8), (300, 300, 1)])
def test_gpu_spmspv_hub_rows_share_one_tile(cuda_device, n_hubs, per_hub, step):
    """Hub rows in one row tile: eight of 8 000 products, or 300 of 300
    (more long rows than a tile lists for its warps, so some are a
    thread's sum).  The tile's bucket (64 000 or 90 000+) sorts in global
    scratch and each hub row is one warp's sum; bit for bit with the plain
    version on the CPU and the card, on two launches."""
    rng = np.random.default_rng(12)
    m, n = 200_000, 60_000
    hubs = 98_304 + np.arange(0, n_hubs * step, step)  # in one 512-row tile or larger
    cols = rng.choice(n, size=per_hub, replace=False)
    rows = np.concatenate([rng.integers(0, m, 600_000), np.repeat(hubs, cols.size)])
    cc = np.concatenate([rng.integers(0, n, 600_000), np.tile(cols, hubs.size)])
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32), (rows, cc)),
                      shape=(m, n))
    A.sum_duplicates()
    A.sort_indices()
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data.astype(np.float32))
    idx = np.union1d(cols, rng.choice(n, size=4000, replace=False)).astype(np.int64)
    val = rng.standard_normal(idx.size).astype(np.float32)
    prep = spmspv_prepare(a, device=cuda_device)
    xi, xv = pad_sparse_rhs(idx, val, idx.size, n)
    x = np.zeros(n, np.float32)
    x[idx] = val
    op, y = _sparse_checks(a, prep, xi, xv, x, "hub rows")
    shift = op["plan"].shift
    assert len({int(r) >> shift for r in hubs}) == 1 and shift >= 9
    assert n_hubs * per_hub > sort_cap(shift)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1, 40_000_000])
def test_gpu_spmspv_tall_y_past_the_shared_memory_tiles(cuda_device, extra):
    """A y of SCATTER_MAX_TILES * SCATTER_SMEM_TILE_ROWS rows (the largest
    whose tiles sort in shared memory) and past it (tiles summed in y
    itself), products in the first and last rows and a row spread over many
    chunks: bit for bit with the plain version on the CPU, on two launches,
    every untouched row +0.0."""
    rng = np.random.default_rng(13)
    m, n = SCATTER_MAX_TILES * SCATTER_SMEM_TILE_ROWS + extra, 3000
    hub = m - 20_000
    rows = np.concatenate([rng.integers(0, m, 5000), [0, m - 1], np.full(n, hub)])
    cols = np.concatenate([rng.integers(0, n, 5002), np.arange(n)])
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32), (rows, cols)),
                      shape=(m, n))
    A.sum_duplicates()
    A.sort_indices()
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data.astype(np.float32))
    idx = np.union1d(rng.choice(n, size=2000, replace=False), cols[5000:5002])
    val = rng.standard_normal(idx.size).astype(np.float32)
    prep = spmspv_prepare(a, device=cuda_device)
    xi, xv = pad_sparse_rhs(idx.astype(np.int64), val, idx.size, n)
    op = stage_sparse(prep, xi, xv)
    assert ((1 << op["plan"].shift) > SCATTER_SMEM_TILE_ROWS) == (extra > 0)
    _build.reset_launches()
    y = _fused(prep, op)
    assert _build.LAUNCHES["spmspv_scatter"] == SCATTER_LAUNCHES
    yp = _plain_on_cpu(a, op)
    _assert_bits(y, yp, f"m = {m}")
    _assert_bits(_fused(prep, op), y, f"m = {m}: second launch")
    assert float(y[hub]) != 0.0 and float(y[m - 1]) != 0.0
    touched = np.zeros(m, bool)
    touched[A[:, idx].nonzero()[0]] = True
    assert not y.cpu().view(torch.int32)[torch.from_numpy(~touched)].any()  # +0.0
    x = np.zeros(n, np.float32)
    x[idx] = val
    assert_rowtol(y.cpu().numpy(), A.astype(np.float64) @ x, a, x, f"m = {m}")


@pytest.mark.gpu
def test_gpu_spmspv_long_runs_of_empty_columns(cuda_device):
    """A chunk whose products cross thousands of touched empty columns
    marks its slots over many rounds of its block, with the same bits; an
    x touching only empty columns (T = 0) launches the passes, which write
    zeros."""
    rng = np.random.default_rng(9)
    m, n = 4000, 6000
    d = sp.random(m, n, density=0.002, random_state=1, format="csc",
                  dtype=np.float32)
    d = d.tolil()
    d[:, 100:5000] = 0.0
    A = sp.csr_matrix(d)
    A.eliminate_zeros()
    a = tf.CSRMatrix((m, n), A.indptr.astype(np.int32), A.indices.astype(np.int32),
                     A.data.astype(np.float32))
    idx = np.arange(50, 5100, dtype=np.int64)  # 4900 empty columns in the middle
    val = rng.standard_normal(idx.size).astype(np.float32)
    x = np.zeros(n, np.float32)
    x[idx] = val
    prep = spmspv_prepare(a, device=cuda_device)
    xi, xv = pad_sparse_rhs(idx, val, idx.size, n)
    _sparse_checks(a, prep, xi, xv, x, "empty runs")
    zi, zv = pad_sparse_rhs(np.arange(100, 110, dtype=np.int64), np.ones(10, np.float32),
                            idx.size, n)
    _build.reset_launches()
    z = spmspv_bind(prep, idx.size, impl="cuda")((zi, zv))
    assert _build.LAUNCHES["spmspv_scatter"] == SCATTER_LAUNCHES
    _assert_bits(z, torch.zeros(m), "T = 0")


@pytest.mark.gpu
def test_gpu_spmspv_request_path_reuses_its_pinned_ring(cuda_device):
    """Twelve requests through one bound runner with no synchronise between
    them (the staging ring of 4 pinned buffers wraps three times): each
    equals its own request staged alone, bit for bit, on both impls; xi
    that repeat a column past the plan's t_max give NaN rows, not a write
    out of bounds."""
    a, _, prep, xi, xv = _sparse_case("webbase-1M", 64, cuda_device)
    n, B = a.shape[1], xi.size
    rng = np.random.default_rng(3)
    reqs = []
    for _ in range(12):
        idx = np.sort(rng.choice(n, size=B - 5, replace=False)).astype(np.int64)
        reqs.append(pad_sparse_rhs(idx, rng.standard_normal(idx.size).astype(np.float32),
                                   B, n))
    for impl in ("cuda", "ref"):
        fn = spmspv_bind(prep, B, impl=impl)
        ys = [fn(r) for r in reqs]
        for r, y in zip(reqs, ys):
            _assert_bits(y, _plain_on_cpu(a, stage_sparse(prep, *r)), impl)
    lens = np.bincount(a.indices, minlength=n)
    assert B * int(lens.max()) > scatter_plan(prep, B).t_max
    dup = np.full(B, int(np.argmax(lens)), np.int32), np.ones(B, np.float32)
    y = spmspv_bind(prep, B, impl="cuda")(dup)
    assert bool(torch.isnan(y).all())


@pytest.mark.gpu
def test_gpu_spmspv_refused_launch_raises(cuda_device, monkeypatch):
    """A refused launch raises, naming its pass, at the wrapper and in a
    search: the CUDA path never hands its work to the plain version."""
    a, _, prep, xi, xv = _sparse_case("webbase-1M", 256, cuda_device)
    op = stage_sparse(prep, xi, xv)
    with pytest.raises(ValueError, match="xi is on cpu"):
        spmspv_scatter(prep, op["xi"].cpu(), op["xv"], op["flags"], op["plan"])
    with pytest.raises(ValueError, match="flags must start on a 8-byte boundary"):
        spmspv_scatter(prep, op["xi"], op["xv"],
                       torch.zeros(op["flags"].numel() + 1, dtype=torch.int32,
                                   device=cuda_device)[1:], op["plan"])
    _build.ensure_built()
    monkeypatch.setattr(_build, "function", lambda *args: (lambda *cargs: 1))
    before = _build.LAUNCHES["spmspv_scatter"]
    with pytest.raises(RuntimeError,
                       match="spmspv_scatter launch, offsets pass: CUDA error 1"):
        _fused(prep, op)
    assert _build.LAUNCHES["spmspv_scatter"] == before  # a refused pass is not counted
    cands = [make("csr", "vector"), make("spmspv", "cuda", slab=4096)]
    with pytest.raises(RuntimeError, match="spmspv/cuda.*CUDA error 1"):
        SparseOperator.build(a, x_nnz=a.shape[1] // 256, cache=PlanCache(),
                             candidates=cands, prune_factor=1e9, warmup=0, timed=1,
                             device=cuda_device)


# ---------------------------------------------------------------------------
# The plain tiers, reordering and supervision on the card
# ---------------------------------------------------------------------------
def _oracle(a, x):
    A = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape)
    return A @ np.asarray(x, np.float64)


def _prefix_max(a, x):
    """Largest |float64 prefix sum| of the products, per column of x."""
    x2 = np.asarray(x, np.float64).reshape(a.shape[1], -1)
    prods = a.data.astype(np.float64)[:, None] * x2[a.indices]
    return np.abs(np.cumsum(prods, axis=0)).max(axis=0).reshape(np.shape(x)[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,k", [(2048, 1), (16384, 1), (2048, 4)])
def test_gpu_merge_tier_within_its_limit(cuda_device, chunk, k):
    """|y - y64| <= 1e-5 (|A| |x|)_i + 8 * 2**-24 * max|P| (a row is a
    difference of global prefix sums)."""
    a = generate("cant", scale=1 / 4)
    x = np.random.default_rng(0).standard_normal(
        a.shape[1] if k == 1 else (a.shape[1], k)).astype(np.float32)
    op = SparseOperator.from_candidate(a, make("merge", "scan", chunk=chunk),
                                       k=None if k == 1 else k, device=cuda_device)
    y = (op @ torch.as_tensor(x, device=cuda_device)).cpu().numpy().astype(np.float64)
    abs_a = sp.csr_matrix((np.abs(a.data).astype(np.float64), a.indices, a.indptr),
                          shape=a.shape)
    lim = TOL * (abs_a @ np.abs(x.astype(np.float64))) + 8 * 2.0**-24 * _prefix_max(a, x)
    assert np.all(np.abs(y - _oracle(a, x)) <= lim)


@pytest.mark.gpu
def test_gpu_scalar_tier_and_reordered_sell(cuda_device):
    from repro_torch.core.reorder import random_order

    a, x = _gpu_case()
    op = SparseOperator.from_candidate(a, make("csr", "scalar"), device=cuda_device)
    xt = torch.as_tensor(x, device=cuda_device)
    assert_rowtol((op @ xt).cpu().numpy(), _oracle(a, x), a, x, "csr/scalar")
    scr = a.permuted(random_order(a, 0))
    base = make("sell", "cuda", C=8, sigma=64, chunk_tile=8)
    _build.reset_launches()
    for cand in (base, make("sell", "cuda", C=8, sigma=64, chunk_tile=8, reorder="rcm")):
        op = SparseOperator.from_candidate(scr, cand, device=cuda_device)
        y = op @ xt
        assert y.data_ptr() != xt.data_ptr()
        assert_rowtol(y.cpu().numpy(), _oracle(scr, x), scr, x, cand.key())
    assert _build.LAUNCHES["sell_spmv"] == 2


@pytest.mark.gpu
def test_gpu_demote_repair_promote_on_the_engines_stream(cuda_device):
    """Faults exhaust the retries of bucket 1 and poison bucket 4; both
    buckets demote, the repair thread probes the saved closures on the
    engine's stream, and the tuned kernels serve again after promotion."""
    import time as _time

    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.supervisor import Supervisor

    a, _ = _gpu_case()
    ops = {1: SparseOperator.from_candidate(a, make("sell", "cuda", C=8, sigma=64,
                                                     chunk_tile=8), device=cuda_device),
           4: SparseOperator.from_candidate(a, make("bcsr", "cuda", block=(8, 8)), k=4,
                                            device=cuda_device)}
    plan = FaultPlan({"engine.dispatch": {"n": 2, "bucket": "1"},
                      "engine.nan": {"n": 2, "bucket": "4"}})
    sup = Supervisor(max_retries=1, backoff_base_s=0.0, repair_interval_s=0.01)
    eng = SparseEngine(a, ks=(1, 4), ops=ops, device=cuda_device, faults=plan,
                       nan_guard=True, supervisor=sup)
    stream = torch.cuda.current_stream(cuda_device)
    assert eng._stream == stream
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(a.shape[1]).astype(np.float32) for _ in range(5)]

    def serve():
        reqs = [eng.submit(torch.as_tensor(xs[0], device=cuda_device))]
        eng.step()
        reqs += [eng.submit(torch.as_tensor(x, device=cuda_device)) for x in xs[1:]]
        eng.drain()
        for r, x in zip(reqs, xs):
            assert_rowtol(r.result(timeout=5).cpu().numpy(), _oracle(a, x), a, x)

    serve()
    assert sup.demotions == 2 and {e.info["bucket"] for e in sup.events_of("demote")} == {1, 4}
    deadline = _time.perf_counter() + 10
    while sup.promotions < 2 and _time.perf_counter() < deadline:
        _time.sleep(0.01)
    assert sup.promotions == 2
    _build.reset_launches()
    serve()
    assert {k: op.plan.candidate.key() for k, op in eng.ops.items()} == {
        k: op.plan.candidate.key() for k, op in ops.items()}
    assert _build.LAUNCHES["sell_spmv"] >= 1 and _build.LAUNCHES["bcsr_spmm"] >= 1
    eng.close()


@pytest.mark.gpu
def test_gpu_real_refused_launch_fails_futures_and_never_demotes(cuda_device):
    """A kernel that really refuses its launch on a card (a blocks operand
    off its 16-byte boundary) fails its batch's futures: no retry, no
    demotion, the bucket keeps its tuned plan, and the other buckets serve."""
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.supervisor import Supervisor
    from repro_torch.tune.operator import runner

    a, x = _gpu_case()
    op4 = SparseOperator.from_candidate(a, make("bcsr", "cuda", block=(8, 8)), k=4,
                                        device=cuda_device)
    prep = dict(op4._prep)
    buf = torch.empty(prep["blocks"].numel() + 1, device=cuda_device)
    prep["blocks"] = buf[1:].view(prep["blocks"].shape)
    prep["blocks"].copy_(op4._prep["blocks"])
    op4._run = runner(a, op4.plan.candidate, prep, k=4)
    ops = {1: SparseOperator.from_candidate(a, make("sell", "cuda", C=8, sigma=64,
                                                     chunk_tile=8), device=cuda_device),
           4: op4}
    sup = Supervisor(max_retries=2, backoff_base_s=0.0, repair_interval_s=0.01)
    eng = SparseEngine(a, ks=(1, 4), ops=ops, device=cuda_device, supervisor=sup)
    xt = torch.as_tensor(x, device=cuda_device)
    reqs = [eng.submit(xt) for _ in range(4)]
    eng.drain()
    for r in reqs:
        assert r.failed
        with pytest.raises(ValueError, match="16-byte"):
            r.result()
    y = eng.submit(xt).result(timeout=5)  # bucket 1 still serves
    assert_rowtol(y.cpu().numpy(), _oracle(a, x), a, x)
    eng.close()
    assert [e.kind for e in sup.events] == ["batch_failed", "batch_abandoned"]
    assert sup.demotions == 0 and sup.retries == 0 and eng.stats.demotions == 0
    assert eng.stats.failed_requests == 4 and eng.ops[4] is op4


@pytest.mark.gpu
def test_gpu_build_skips_a_prepare_that_runs_out_of_memory(cuda_device):
    from repro_torch.runtime.faults import FaultPlan, set_active

    a, x = _gpu_case()
    prev = set_active(FaultPlan({"prepare.oom": {"n": 1}}))
    try:
        op = SparseOperator.build(a, cache=PlanCache(), warmup=0, timed=1,
                                  force_search=True, device=cuda_device)
    finally:
        set_active(prev)
    (exc,) = op.search_failures.values()
    assert isinstance(exc, MemoryError)
    y = op @ torch.as_tensor(x, device=cuda_device)
    assert_rowtol(y.cpu().numpy(), _oracle(a, x), a, x, op.plan.candidate.key())


@pytest.mark.gpu
def test_gpu_unfaulted_engine_records_no_supervisor_event(cuda_device):
    from repro_torch.runtime.engine import SparseEngine

    a, x = _gpu_case()
    eng = SparseEngine(a, ks=(1, 4, 16), cache=PlanCache(), device=cuda_device,
                       nan_guard=True)
    xt = torch.as_tensor(x, device=cuda_device)
    ys = eng.run([xt] * 21)
    eng.close()
    for y in ys:
        assert_rowtol(y.cpu().numpy(), _oracle(a, x), a, x)
    assert eng.supervisor.events == [] and eng.stats.demotions == 0


@pytest.mark.gpu
def test_gpu_sparse_repair_probe_launches_the_fused_kernel(cuda_device):
    """A faulted sparse bucket pinned to spmspv/cuda demotes to the dense
    fallback; the repair probe that promotes it back runs a product, so it
    launches the SpMSpV kernel's passes once each (the only launches
    between demotion and promotion: the fallback serves through
    csr/vector)."""
    import time as _time

    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.runtime.supervisor import Supervisor

    a, x = _gpu_case()
    n = a.shape[1]
    B = n // 64
    sup = Supervisor(max_retries=0, backoff_base_s=0.0, repair_interval_s=0.01)
    pinned = make("spmspv", "cuda", slab=4096)
    cache = PlanCache()  # searched here, so the engine loads the plan
    SparseOperator.build(a, x_nnz=B, cache=cache, candidates=[pinned],
                         device=cuda_device)
    dense = SparseOperator.from_candidate(a, make("csr", "vector"), device=cuda_device)
    eng = SparseEngine(a, ks=(1,), ops={1: dense}, cache=cache, device=cuda_device,
                       x_nnz_buckets=(B,), candidates=[pinned],
                       faults=FaultPlan({"engine.dispatch": {"n": 1, "bucket": f"('spmspv', {B})"}}),
                       supervisor=sup)
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(n, size=B, replace=False)).astype(np.int64)
    val = rng.standard_normal(B).astype(np.float32)
    xd = np.zeros(n, np.float32)
    xd[idx] = val
    _build.reset_launches()
    y = eng.submit_sparse(idx, val).result(timeout=10)  # demoted, served by csr/vector
    assert [e.kind for e in sup.events][:2] == ["batch_failed", "demote"]
    deadline = _time.perf_counter() + 10
    while sup.promotions < 1 and _time.perf_counter() < deadline:
        _time.sleep(0.01)
    assert sup.promotions == 1
    assert [e.kind for e in sup.events] == ["batch_failed", "demote", "promote"]
    assert _build.LAUNCHES["spmspv_scatter"] == SCATTER_LAUNCHES  # the probe's product
    y2 = eng.submit_sparse(idx, val).result(timeout=10)
    assert _build.LAUNCHES["spmspv_scatter"] == 2 * SCATTER_LAUNCHES
    eng.close()
    for got in (y, y2):
        assert_rowtol(got.cpu().numpy(), _oracle(a, xd), a, xd,
                      terms=np.bincount(
                          np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))[
                              np.isin(a.indices, idx)], minlength=a.shape[0]))


@pytest.mark.gpu
def test_gpu_device_loop_equals_host_loop_on_the_sell_kernel(cuda_device):
    """CG on a pinned sell/cuda plan: the device-decided loop and the host
    loop give the same count, flag and x (the same step functions on the
    same kernel), the loop reads the card once per block, and a tol met
    inside a block (masked steps after it) changes nothing."""
    from repro_torch.core.spmv import spd_shift
    from repro_torch.runtime.solver import SparseSolver, cg_host_loop

    a = spd_shift(generate("cant", scale=1 / 16))
    b = np.random.default_rng(4).standard_normal(a.shape[0]).astype(np.float32)
    s = SparseSolver(a, cache=PlanCache(), device=cuda_device,
                     candidates=[make("sell", "cuda", C=8, sigma=64, chunk_tile=8)])
    _build.reset_launches()
    fused = s.cg(b, tol=1e-5, maxiter=500)
    assert fused.plan.startswith("sell/cuda") and _build.LAUNCHES["sell_spmv"] > 0
    host = cg_host_loop(s.op(1)._run, b, tol=1e-5, maxiter=500, device=cuda_device)
    assert fused.converged and host.converged
    assert fused.iterations == host.iterations
    np.testing.assert_allclose(fused.x.cpu().numpy(), host.x.cpu().numpy(), rtol=0,
                               atol=1e-6)
    # a flag read after each block (1, 2, 4, ... up to 16 iterations) until
    # one finds the loop done, then the final state; the host loop reads
    # every iteration
    done, reads, size = 0, 0, 1
    while True:
        done, reads, size = done + size, reads + 1, min(2 * size, s.block)
        if done >= fused.iterations:
            break
    assert fused.syncs == reads + 1
    assert host.syncs == host.iterations + 3
    x64 = fused.x.cpu().numpy().astype(np.float64)
    r = b - _oracle(a, x64)
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)
    # a tol the host loop first meets at iteration 5, inside the block of
    # iterations 4-7: iterations 6 and 7 run masked
    res45 = [cg_host_loop(s.op(1)._run, b, tol=-1.0, maxiter=i,
                          device=cuda_device).residual for i in (4, 5)]
    tol = float(np.sqrt(res45[0] * res45[1]) / np.linalg.norm(b))
    fused = s.cg(b, tol=tol, maxiter=500)
    host = cg_host_loop(s.op(1)._run, b, tol=tol, maxiter=500, device=cuda_device)
    assert (fused.iterations, fused.converged, fused.syncs) == (5, True, 4)
    assert (host.iterations, host.converged) == (5, True)
    np.testing.assert_allclose(fused.x.cpu().numpy(), host.x.cpu().numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
def test_gpu_solver_step_search_times_the_bare_product(cuda_device, monkeypatch):
    """On a card the solver_step search times each candidate's bare product
    (the probe's time there is host launch overhead), and the plan is still
    cached as kind solver_step."""
    from repro_torch.core.spmv import spd_shift
    from repro_torch.tune import operator as top

    def refuse(*args, **kwargs):
        raise AssertionError("the probe was timed on the card")

    monkeypatch.setattr(top, "solver_step_probe", refuse)
    a = spd_shift(generate("cant", scale=1 / 16))
    op = SparseOperator.build(a, solver_step=True, cache=PlanCache(), device=cuda_device)
    assert op.plan.kind == "solver_step" and op.measurements


# ---------------------------------------------------------------------------
# The fleet (runtime/fleet.py) on the card
def _drop_one_entry(a):
    """A near-identical neighbour: ``a`` without the last entry of its
    longest row (another fingerprint, near-identical features)."""
    r = int(np.argmax(np.diff(a.indptr)))
    keep = np.ones(a.nnz, bool)
    keep[a.indptr[r + 1] - 1] = False
    indptr = a.indptr.copy()
    indptr[r + 1:] -= 1
    return tf.CSRMatrix(shape=a.shape, indptr=indptr, indices=a.indices[keep],
                        data=a.data[keep])


@pytest.mark.gpu
def test_gpu_fleet_serves_two_tenants_through_both_kernels(cuda_device):
    """cant (measured k = 1 sell/cuda and k = 64 bcsr/cuda plans in the
    cache) and webbase-1M (every bucket predicted) at full scale: no served
    plan is merge, webbase-1M's k = 64 byte-model pick is the kernel, both
    kernels launch, every result holds 1e-5 of float64, no event."""
    from repro_torch.runtime.fleet import SparseFleet

    cant, web = generate("cant", scale=1.0), generate("webbase-1M", scale=1.0)
    cache = PlanCache()
    SparseOperator.build(cant, cache=cache, device=cuda_device,
                         candidates=[make("sell", "cuda", C=8, sigma=64, chunk_tile=8)])
    SparseOperator.build(cant, k=64, cache=cache, device=cuda_device,
                         candidates=[make("bcsr", "cuda", block=(8, 8))])
    # a budget that holds both: webbase-1M's BCSR alone is about 770 MB
    fl = SparseFleet(cache=cache, retune=False, budget_bytes=4 << 30, device=cuda_device)
    t_cant = fl.add_tenant("cant", cant)
    t_web = fl.add_tenant("web", web)
    assert t_cant.admitted_from[1] == "cache" and t_cant.admitted_from[64] == "cache"
    for k, op in t_web.engine.ops.items():
        assert op.plan.fmt != "merge" and op.plan.n_measured == 0, (k, op.plan)
    assert t_web.engine.ops[64].plan.candidate.key() == "bcsr/cuda[block=(8, 8)]"
    rng = np.random.default_rng(5)
    _build.reset_launches()
    for name, a in (("cant", cant), ("web", web)):
        xs = [rng.standard_normal(a.shape[1]).astype(np.float32) for _ in range(65)]
        reqs = [fl.submit(name, torch.as_tensor(xs[0], device=cuda_device))]
        fl.step()
        reqs += [fl.submit(name, torch.as_tensor(x, device=cuda_device)) for x in xs[1:]]
        fl.drain()
        for r, x in zip(reqs, xs):
            assert_rowtol(r.result().cpu().numpy(), _oracle(a, x), a, x, name)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sell_spmv"] > 0 and _build.LAUNCHES["bcsr_spmm"] > 0
    for t in fl.tenants.values():
        assert not t.engine.supervisor.events and not t.engine.stats.demotions
    fl.close()


@pytest.mark.gpu
def test_gpu_retune_on_its_stream_hot_swaps_with_in_flight_futures_bitwise(cuda_device):
    """Two batches in flight on the old (predicted) table while the retune
    runs on the worker's own stream: they resolve bit for bit as a pinned
    engine of the old table answers, and later batches serve the measured
    table within 1e-5 of float64."""
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.fleet import SparseFleet

    a = generate("cant", scale=1 / 4)
    fl = SparseFleet(ks=(1, 4), cache=PlanCache(), retune=False, device=cuda_device)
    t = fl.add_tenant("t", a)
    old = dict(t.engine.ops)
    rng = np.random.default_rng(6)
    xs = [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32),
                          device=cuda_device) for _ in range(16)]
    pinned = SparseEngine(a, ks=(1, 4), ops=old, device=cuda_device)
    ref = [y.clone() for y in pinned.run(xs[:8])]
    reqs = [fl.submit("t", x) for x in xs[:8]]
    assert t.engine.step(force=True) == 4 and t.engine.step(force=True) == 4
    assert t.engine.in_flight == 2
    fl.retune("t")
    assert fl.wait_retunes(timeout=600)
    assert fl.stats_fleet.retunes_done == 1 and t.retuned
    side = fl._side_stream
    assert side is not None and side != torch.cuda.current_stream(cuda_device)
    late = [fl.submit("t", x) for x in xs[8:]]
    fl.drain()
    assert t.engine.swaps_applied == 1
    # the retune's graphs share a pool of their own, not the engine's
    pools = {fn.executable.pool for fn in t.engine._execs.values()}
    assert len(pools) == 1 and t.engine.graph_pool not in pools
    for r, y in zip(reqs, ref):
        assert torch.equal(r.result(), y)
    for r, x in zip(late, xs[8:]):
        xh = x.cpu().numpy()
        assert_rowtol(r.result().cpu().numpy(), _oracle(a, xh), a, xh)
    assert not t.engine.supervisor.events
    fl.close()


@pytest.mark.gpu
def test_gpu_predicted_merge_is_passed_over_on_webbase(cuda_device):
    """A confident transfer of merge/scan (from a near-identical neighbour)
    to webbase-1M breaks the accuracy check on the card: build_predicted
    records it and serves the next byte-model candidate within 1e-5."""
    from repro_torch.core.device import backend_name
    from repro_torch.tune import InaccurateTier, Plan, extract, fingerprint

    web = generate("webbase-1M", scale=1.0)
    nb = _drop_one_entry(web)
    dev = torch.device("cuda", torch.cuda.current_device())
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(nb), kind="spmv", fmt="merge", impl="scan",
                   params={"chunk": 2048}, est_cost=1.0, measured_s=1e-4,
                   n_candidates=1, n_measured=1, k=1, backend=backend_name(dev),
                   scale=[nb.shape[0], nb.shape[1], nb.nnz],
                   features=extract(nb).to_dict()))
    op = SparseOperator.build_predicted(web, cache=cache, device=cuda_device)
    merge = "merge/scan[chunk=2048]"
    assert isinstance(op.search_failures.get(merge), InaccurateTier), op.search_failures
    assert op.plan.fmt != "merge" and op.plan.predicted_from == "byte_model"
    x = np.random.default_rng(7).standard_normal(web.shape[1]).astype(np.float32)
    y = (op @ torch.as_tensor(x, device=cuda_device)).cpu().numpy()
    assert_rowtol(y, _oracle(web, x), web, x)
    assert len(cache) == 1


# -- the mesh: P shards on the card ------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 64])
def test_gpu_mesh_schedules_match_float64(cuda_device, k):
    """Both collective schedules at P = 4 on the card (the shards share
    the visible cards round-robin) within 1e-5 of float64, and the same
    bits on a second run."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_spmm_mesh

    a = generate("cant", scale=1 / 4)
    mesh = make_spmm_mesh(4)
    assert mesh.devices[0].type == "cuda"
    x = np.random.default_rng(8).standard_normal((a.shape[1], k)).astype(np.float32)
    want = _oracle(a, x)
    for schedule in dist.SCHEDULES:
        prep = dist.place_mesh_operand(dist.build_mesh_operand(a, 4, schedule), mesh,
                                       "shard")
        fn = dist.mesh_spmm_runner(mesh, "shard", prep)
        xd = torch.as_tensor(x[:, 0] if k == 1 else x, device=mesh.devices[0])
        y = fn(xd)
        assert torch.equal(y, fn(xd)), schedule
        got = y.cpu().numpy().reshape(a.shape[0], k)
        for j in range(k):
            assert_rowtol(got[:, j], want[:, j], a, x[:, j], schedule)


@pytest.mark.gpu
def test_gpu_mesh_engine_async_equals_sync_bitwise(cuda_device):
    """A mesh engine at P = 4 on the card: async_depth=2 gives the bits of
    async_depth=0 on every bucket, within 1e-5 of float64, no event."""
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.runtime.engine import SparseEngine

    a = generate("cant", scale=1 / 4)
    mesh = make_spmm_mesh(4)
    cache = PlanCache()
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(a.shape[1]).astype(np.float32) for _ in range(25)]
    runs = []
    for depth in (2, 0):
        eng = SparseEngine(a, ks=(1, 4, 16), mesh=mesh, cache=cache, async_depth=depth)
        assert all(op.plan.fmt == "dist" for op in eng.ops.values())
        reqs = [eng.submit(torch.as_tensor(xs[0], device=eng.device))]
        eng.step()
        reqs += [eng.submit(torch.as_tensor(x, device=eng.device)) for x in xs[1:]]
        eng.drain()
        runs.append([r.result() for r in reqs])
        assert not eng.supervisor.events
        eng.close()
    assert all(torch.equal(p, q) for p, q in zip(*runs))
    for y, x in zip(runs[0], xs):
        assert_rowtol(y.cpu().numpy(), _oracle(a, x), a, x)


@pytest.mark.gpu
def test_gpu_mesh_on_cuda_without_a_card_raises(cuda_device, monkeypatch):
    """Through the device check: with no card visible, a CUDA mesh, and a
    mesh engine or solver over a CUDA mesh, raise; nothing falls back to
    the CPU."""
    from repro_torch.core.distributed import Mesh
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.solver import SparseSolver

    a = generate("cant", scale=1 / 64)
    mesh = Mesh([torch.device("cuda", 0)] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_spmm_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseEngine(a, mesh=mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseSolver(a, mesh=mesh)


# ---------------------------------------------------------------------------
# The bf16 BCSR path (the sparse FFN's)
# ---------------------------------------------------------------------------
def _ffn_weights(device, which="w1", d_model=2560, d_ff=6912):
    """One bcsr FFN weight of qwen1.5-4b's shapes (the seeded block pattern
    at (128, 128), density 0.25), bf16 blocks from default_rng."""
    from repro_torch.models.ffn import SparseFFN, SparseFFNConfig

    p = SparseFFN(d_model, d_ff, SparseFFNConfig(kind="bcsr"), torch.bfloat16, device)
    blocks = p[f"{which}_blocks"]
    blocks.copy_(torch.as_tensor(
        np.random.default_rng(0).standard_normal(tuple(blocks.shape)).astype(np.float32)
        * 0.05))
    n_cb = (d_model if which == "w1" else d_ff) // 128
    return blocks, p[f"{which}_cols"], p[f"{which}_indptr"], n_cb


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["w1", "w2"])
def test_gpu_bf16_bcsr_matches_plain_at_the_ffn_shapes(cuda_device, which):
    """bf16 blocks and X, float32 Y: the kernel against its plain version
    (widened to float32, summed per block row) at 1e-5·(|A|·|x|)_i for
    k in {1, 4, 32, 100}, the same bits on a second launch, one launch
    counted under ``bcsr_spmm_bf16`` each and none under ``bcsr_spmm``."""
    blocks, cols, indptr, n_cb = _ffn_weights(cuda_device, which)
    for k in (1, 4, 32, 100):
        xb = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (n_cb, 128, k)).astype(np.float32), device=cuda_device).to(torch.bfloat16)
        before = dict(_build.LAUNCHES)
        y = bcsr_spmm(blocks, cols, indptr, xb)
        assert _build.LAUNCHES["bcsr_spmm_bf16"] == before.get("bcsr_spmm_bf16", 0) + 1
        assert _build.LAUNCHES["bcsr_spmm"] == before.get("bcsr_spmm", 0)
        assert y.dtype == torch.float32
        assert torch.equal(y, bcsr_spmm(blocks, cols, indptr, xb)), k
        yp = bcsr_spmm_plain(blocks, cols, indptr, xb)
        scale = bcsr_spmm_plain(blocks.abs(), cols, indptr, xb.abs())
        err = (y.double() - yp.double()).abs()
        assert bool((err <= TOL * scale.double()).all()), (which, k, float(err.max()))


def _rand_bf16_bcsr(device, gm, n_cb, bm, bk, seed=0, density=0.25):
    """A seeded random bf16 BCSR operand of gm x n_cb block positions."""
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.random((gm, n_cb)) < density)
    indptr = np.zeros(gm + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    blocks = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
    return (torch.as_tensor(blocks, device=device).to(torch.bfloat16),
            torch.as_tensor(cols.astype(np.int32), device=device),
            torch.as_tensor(np.cumsum(indptr).astype(np.int32), device=device))


def _check_bf16(args, xb, counters):
    """One launch against the plain version at 1e-5·(|A|·|x|)_i, the same
    bits on a second launch, and the counters each launch adds to."""
    before = dict(_build.LAUNCHES)
    y = bcsr_spmm(*args, xb)
    for name in ("bcsr_spmm_bf16", "bcsr_spmm_bf16_mma", "bcsr_spmm"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + (name in counters), name
    assert y.dtype == torch.float32
    assert torch.equal(y, bcsr_spmm(*args, xb))
    yp = bcsr_spmm_plain(*args, xb)
    scale = bcsr_spmm_plain(args[0].abs(), *args[1:], xb.abs()).double()
    err = (y.double() - yp.double()).abs()
    assert bool((err <= TOL * scale).all()), float((err - TOL * scale).max())
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ffn-w1", "ffn-w2", (64, 128), (128, 64)])
def test_gpu_bf16_tensor_core_path_matches_plain(cuda_device, shape):
    """The tensor-core kernel at the FFN's (128, 128) weights and at (64, 128)
    and (128, 64) blocks, for k from 1 to 256 (ragged N tiles included):
    within 1e-5·(|A|·|x|)_i of the plain version, bit for bit on a second
    launch, each launch counted under ``bcsr_spmm_bf16`` and
    ``bcsr_spmm_bf16_mma``."""
    from repro_torch.kernels.bcsr_spmm import bf16_tensor_core_path

    if isinstance(shape, str):
        blocks, cols, indptr, n_cb = _ffn_weights(cuda_device, shape[4:])
    else:
        n_cb = 9
        blocks, cols, indptr = _rand_bf16_bcsr(cuda_device, 12, n_cb, *shape, seed=1)
    assert bf16_tensor_core_path(*blocks.shape[1:])
    for k in (1, 3, 4, 17, 100, 128, 256):
        xb = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (n_cb, blocks.shape[2], k)).astype(np.float32), device=cuda_device
        ).to(torch.bfloat16)
        _check_bf16((blocks, cols, indptr), xb, {"bcsr_spmm_bf16", "bcsr_spmm_bf16_mma"})


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bk", [(128, 8), (24, 32)])
def test_gpu_bf16_cuda_core_shapes_count_under_bf16_only(cuda_device, bm, bk):
    """Blocks the tensor-core kernel does not take (bk = 8, bm not a multiple
    of 16) run on the CUDA-core kernel: right, repeatable, and counted under
    ``bcsr_spmm_bf16`` alone."""
    from repro_torch.kernels.bcsr_spmm import bf16_tensor_core_path

    assert not bf16_tensor_core_path(bm, bk)
    blocks, cols, indptr = _rand_bf16_bcsr(cuda_device, 10, 7, bm, bk, seed=2)
    for k in (1, 4, 17, 64):
        xb = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (7, bk, k)).astype(np.float32), device=cuda_device).to(torch.bfloat16)
        _check_bf16((blocks, cols, indptr), xb, {"bcsr_spmm_bf16"})


@pytest.mark.gpu
def test_gpu_bf16_empty_block_row_and_k1_on_w2_rows(cuda_device):
    """W2's 20 block rows with block row 3 emptied, at k = 1 and 4: the empty
    row's outputs are zeros and every other row matches the plain version."""
    blocks, cols, indptr, n_cb = _ffn_weights(cuda_device, "w2")
    counts = (indptr[1:] - indptr[:-1]).long()
    brows = torch.repeat_interleave(torch.arange(indptr.shape[0] - 1, device=cuda_device),
                                    counts)
    keep = brows != 3
    counts[3] = 0
    indptr = torch.cat([torch.zeros(1, dtype=torch.long, device=cuda_device),
                        counts.cumsum(0)]).int()
    args = (blocks[keep].contiguous(), cols[keep].contiguous(), indptr)
    assert indptr.shape[0] == 21 and int(indptr[4] - indptr[3]) == 0
    for k in (1, 4):
        xb = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (n_cb, 128, k)).astype(np.float32), device=cuda_device).to(torch.bfloat16)
        y = _check_bf16(args, xb, {"bcsr_spmm_bf16", "bcsr_spmm_bf16_mma"})
        assert bool((y[3] == 0).all())


@pytest.mark.gpu
def test_gpu_bf16_bcsr_refuses_misaligned_and_mixed_operands(cuda_device):
    blocks, cols, indptr, n_cb = _ffn_weights(cuda_device)
    xb = torch.zeros((n_cb, 128, 4), dtype=torch.bfloat16, device=cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16
        return v

    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="blocks must start on a 16-byte"):
        bcsr_spmm(shifted(blocks), cols, indptr, xb)
    with pytest.raises(ValueError, match="x_blocked must start on a 16-byte"):
        bcsr_spmm(blocks, cols, indptr, shifted(xb))
    with pytest.raises(TypeError, match="x_blocked has dtype torch.float32"):
        bcsr_spmm(blocks, cols, indptr, xb.float())
    with pytest.raises(TypeError, match="x_blocked has dtype torch.bfloat16"):
        bcsr_spmm(blocks.float(), cols, indptr, xb)
    with pytest.raises(ValueError, match="must be contiguous"):
        bcsr_spmm(blocks, cols, indptr, xb.transpose(1, 2))
    assert dict(_build.LAUNCHES) == before
    y = bcsr_spmm(blocks, cols, indptr, xb)  # the card still works
    assert bool((y == 0).all())


@pytest.mark.gpu
def test_gpu_reduced_bcsr_model_serves_through_the_bf16_kernel(cuda_device):
    """A reduced qwen1.5-4b with a (32, 32) bcsr FFN in bf16 on the card:
    every prefill and decode step launches the bf16 kernel twice a layer,
    and the served model's logits match the same model on the CPU."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer, Request

    cfg = dataclasses.replace(get_reduced("qwen1.5-4b"),
                              sparse_ffn=SparseFFNConfig(kind="bcsr", block=(32, 32)))
    model = lm.init_model(cfg, 0, device=cuda_device)
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    rng = np.random.default_rng(0)
    for i in range(3):
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                           max_new=4))
    _build.reset_launches()
    warm = srv.warmups  # the decode graph's warm-up ran before the count
    done = srv.run_until_drained()
    assert len(done) == 3
    # every replay counts its captured launches, every warm-up pass its own
    assert _build.LAUNCHES["bcsr_spmm_bf16"] == 2 * cfg.n_layers * (
        srv.prefills + srv.steps + srv.warmups - warm)
    assert _build.LAUNCHES["bcsr_spmm"] == 0
    toks = rng.integers(0, cfg.vocab, (2, 9))
    got, _ = lm.forward(cfg, model, {"tokens": toks})
    host = lm.init_model(cfg, 0, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref, _ = lm.forward(cfg, host, {"tokens": toks})
    err = (got.float().cpu() - ref.float()).abs().max()
    assert float(err) <= 3e-2 * float(ref.float().abs().max())


# ---------------------------------------------------------------------------
# CUDA graphs: every captured path against its eager twin
# ---------------------------------------------------------------------------
_AOT_CASES = {
    "sell/cuda k=1": (lambda: make("sell", "cuda", C=8, sigma=64, chunk_tile=8), None),
    "sell_blocked/cuda k=1": (
        lambda: make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8),
        None),
    "bcsr/cuda k=4": (lambda: make("bcsr", "cuda", block=(8, 8)), 4),
    "csr/vector k=16": (lambda: make("csr", "vector"), 16),
}
_KERNEL = {"sell": "sell_spmv", "sell_blocked": "sell_spmv_blocked", "bcsr": "bcsr_spmm"}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_AOT_CASES))
def test_gpu_aot_replay_equals_eager_bitwise(cuda_device, case):
    """op.aot() on a card is a graph: bit for bit op @ x on two calls, the
    first result untouched by the second call, and exactly one launch of
    the plan's kernel counted per call."""
    a, _ = _gpu_case()
    cand, k = _AOT_CASES[case]
    op = SparseOperator.from_candidate(a, cand(), k=k, device=cuda_device)
    exe = op.aot()
    assert exe is op.aot() and exe is not op._run
    rng = np.random.default_rng(8)
    shape = (a.shape[1],) if k is None else (a.shape[1], k)
    x1, x2 = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                              device=cuda_device) for _ in range(2))
    kernel = _KERNEL.get(op.plan.fmt)
    _build.reset_launches()
    y1 = exe(x1)
    y1_copy = y1.clone()
    y2 = exe(x2)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == ({kernel: 2} if kernel else {})
    assert torch.equal(y1, op @ x1) and torch.equal(y2, op @ x2)
    assert torch.equal(y1, y1_copy)


def _pinned_engine_ops(a, device):
    return {k: SparseOperator.from_candidate(
        a, make("sell", "cuda", C=8, sigma=64, chunk_tile=8) if k == 1
        else make("bcsr", "cuda", block=(8, 8)), k=None if k == 1 else k, device=device)
        for k in (1, 4, 16, 64)}


def _serve_groups(eng, xs, groups=(1, 3, 4, 12, 44)):
    reqs, i = [], 0
    for g in groups:
        reqs += [eng.submit(x) for x in xs[i:i + g]]
        i += g
        eng.step()
    eng.drain()
    return [r.result() for r in reqs]


@pytest.mark.gpu
def test_gpu_engine_graphs_equal_eager_and_async_equals_sync(cuda_device):
    """Every bucket of a pinned engine serves through its graph: the results
    equal an eager engine's (captured=False) bit for bit, and the async
    loop's equal the synchronous one's, with graphs on."""
    from repro_torch.runtime.engine import SparseEngine

    a, _ = _gpu_case()
    ops = _pinned_engine_ops(a, cuda_device)
    rng = np.random.default_rng(9)
    xs = [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32),
                          device=cuda_device) for _ in range(64)]
    out = {}
    for label, kw in (("graph", {}), ("eager", {"captured": False}),
                      ("graph sync", {"async_depth": 0})):
        eng = SparseEngine(a, ks=(1, 4, 16, 64), ops=ops, device=cuda_device, **kw)
        out[label] = _serve_groups(eng, xs)
        execs = dict(eng._execs)
        eng.close()
        assert sorted(eng.stats.summary()["by_bucket"]) == [1, 4, 16, 64]
        assert all(hasattr(fn, "executable") == (label != "eager")
                   for fn in execs.values())
        if label != "eager":  # the buckets' graphs share the engine's pool
            assert {fn.executable.pool for fn in execs.values()} == {eng.graph_pool}
    for label in ("eager", "graph sync"):
        assert all(torch.equal(g, e) for g, e in zip(out["graph"], out[label])), label
    for y, x in zip(out["graph"], xs):
        xh = x.cpu().numpy()
        assert_rowtol(y.cpu().numpy(), _oracle(a, xh), a, xh)


@pytest.mark.gpu
def test_gpu_engine_graph_launch_counts_are_exact_across_replays(cuda_device):
    """After a bucket's first dispatch (one warm-up launch, one replay),
    every further batch counts exactly one launch of the bucket's kernel."""
    from repro_torch.runtime.engine import SparseEngine

    a, x = _gpu_case()
    eng = SparseEngine(a, ks=(1, 64), ops={k: v for k, v in _pinned_engine_ops(
        a, cuda_device).items() if k in (1, 64)}, device=cuda_device)
    xt = torch.as_tensor(x, device=cuda_device)
    _build.reset_launches()
    eng.run([xt] * 65)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"bcsr_spmm": 2, "sell_spmv": 2}
    _build.reset_launches()
    eng.run([xt] * (3 * 64 + 1))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"bcsr_spmm": 3, "sell_spmv": 1}
    eng.close()


@pytest.mark.gpu
def test_gpu_error_during_capture_fails_the_batch_and_leaves_the_stream_usable(
        cuda_device):
    """A runner that synchronises (legal eagerly, forbidden while capturing)
    fails its bucket's capture: the batch fails with that error, no retry
    and no demotion, and afterwards the card launches, draws random
    numbers, captures and serves as before.  A failed capture drops its
    hold on its memory pool: the pool takes further captures, and once it
    and its graphs are gone its memory goes back to the card."""
    import gc
    import types

    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.runtime.executable import GraphPool, capture, pool_bytes
    from repro_torch.runtime.supervisor import Supervisor

    a, x = _gpu_case()
    ops = {k: v for k, v in _pinned_engine_ops(a, cuda_device).items() if k in (1, 4)}
    good = ops[4]._run

    def syncing(x2):
        y = good(x2)
        float(y.sum())  # a host read: invalidates a capture
        return y

    ops[4]._run = syncing
    sup = Supervisor(max_retries=2, backoff_base_s=0.0, repair_interval_s=0.01)
    eng = SparseEngine(a, ks=(1, 4), ops=ops, device=cuda_device, supervisor=sup)
    xt = torch.as_tensor(x, device=cuda_device)
    reqs = [eng.submit(xt) for _ in range(4)]
    eng.drain()
    assert all(r.failed for r in reqs)
    assert "capturing" in str(reqs[0]._exc)
    assert [e.kind for e in sup.events] == ["batch_failed", "batch_abandoned"]
    assert sup.retries == 0 and eng.stats.demotions == 0
    y = eng.submit(xt).result(timeout=5)  # bucket 1 captures and serves
    assert_rowtol(y.cpu().numpy(), _oracle(a, x), a, x)
    eng.close()
    r = torch.randn(16, device=cuda_device)
    assert not torch.cuda.is_current_stream_capturing()
    exe = SparseOperator.from_candidate(a, make("bcsr", "cuda", block=(8, 8)), k=4,
                                        device=cuda_device).aot()
    y4 = exe(torch.ones((a.shape[1], 4), device=cuda_device))
    assert bool(torch.isfinite(y4).all()) and bool(torch.isfinite(r).all())
    pool = GraphPool(cuda_device)
    x4 = torch.ones((a.shape[1], 4), device=cuda_device)
    handles = []
    for _ in range(2):  # the pool stays usable after a failed capture
        try:
            capture(syncing, x4, pool=pool)
            raise AssertionError("a synchronising capture did not raise")
        except RuntimeError as e:
            assert "capturing" in str(e)
        handles.append(types.SimpleNamespace(handle=pool.handle))  # the one that failed
    graph, y4 = capture(good, x4, pool=pool)
    graph.replay()
    assert torch.equal(y4, good(x4))
    handles.append(types.SimpleNamespace(handle=pool.handle))
    assert len({tuple(h.handle) for h in handles}) == 3  # a fresh pool after each failure
    del pool, graph, y4
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert pool_bytes(handles) == 0
    assert bool(torch.isfinite(exe(x4)).all())


@pytest.mark.gpu
def test_gpu_solver_blocks_as_graphs_equal_eager_blocks(cuda_device):
    """CG (pinned sell/cuda) and block power (pinned bcsr/cuda, k = 8) as
    graphs against the same solves with eager blocks: the same count, flag
    and reads, x and V bit for bit, theta equal; against the host loop the
    count and flag, x within 1e-6.  One graph per block size."""
    from repro_torch.core.spmv import spd_shift
    from repro_torch.runtime.solver import SparseSolver, cg_host_loop

    a = spd_shift(generate("cant", scale=1 / 16))
    b = np.random.default_rng(4).standard_normal(a.shape[0]).astype(np.float32)
    res = {}
    for captured in (True, False):
        kw = {"device": cuda_device, "captured": captured}
        s = SparseSolver(a, cache=PlanCache(), candidates=[
            make("sell", "cuda", C=8, sigma=64, chunk_tile=8)], **kw)
        sb = SparseSolver(a, cache=PlanCache(), candidates=[
            make("bcsr", "cuda", block=(8, 8))], **kw)
        res[captured] = (s.cg(b, tol=1e-5), s.cg(b, tol=-1.0, maxiter=40),
                         sb.block_power(8, tol=1e-4, maxiter=60))
        assert (s.n_graphs > 0) == captured and (sb.n_graphs > 0) == captured
        if captured:
            # block sizes 1, 2, 4, 8, 16, and 9 to end the 40-iteration budget
            assert s.n_graphs == 6
            host = cg_host_loop(s.op(1)._run, b, tol=1e-5, device=cuda_device)
    for g, e in zip(res[True], res[False]):
        assert (g.iterations, g.converged, g.syncs) == (e.iterations, e.converged,
                                                        e.syncs)
        if g.x is not None:
            assert torch.equal(g.x, e.x)
        else:
            assert torch.equal(g.eigenvectors, e.eigenvectors)
            assert np.array_equal(g.eigenvalues, e.eigenvalues)
    cg = res[True][0]
    assert (cg.iterations, cg.converged) == (host.iterations, host.converged)
    np.testing.assert_allclose(cg.x.cpu().numpy(), host.x.cpu().numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.gpu
def test_gpu_decode_graph_equals_eager_decode(cuda_device):
    """A reduced float32 qwen1.5-4b with a (32, 32) bcsr FFN on the kernel:
    one replay of the server's decode graph gives eager decode_step's
    logits within 1e-3 max|logits| and the same cache; captured and eager
    servers give every request the same tokens."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer, Request, _merge_slot

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("qwen1.5-4b"), dtype=torch.float32,
                              sparse_ffn=SparseFFNConfig(kind="bcsr", block=(32, 32)))
    model = lm.init_model(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9, 5)]
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    assert srv.graphs == 1 and srv.warmups == 1
    state = lm.init_decode_state(cfg, 2, 32, cuda_device)
    for i, p in enumerate(prompts[:2]):
        one, _ = lm.prefill(cfg, model, {"tokens": p[None]}, 32)
        _merge_slot(state, one, i)
    for key, t in state["kv"].items():
        srv.state["kv"][key].copy_(t)
    toks = torch.as_tensor([[3], [7]], device=cuda_device)
    _, ref = lm.decode_step(cfg, model, state, toks)
    graph, tokens, _, logits = srv._decode
    tokens.copy_(toks)
    graph.replay()
    torch.cuda.synchronize()
    assert float((logits - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    for key, t in state["kv"].items():
        assert torch.equal(srv.state["kv"][key], t), key
    outs = {}
    for captured in (True, False):
        s = BatchedServer(cfg, model, batch_slots=2, max_seq=32, captured=captured)
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            s.submit(r)
        s.run_until_drained()
        outs[captured] = [r.out for r in reqs]
        assert s.graphs == (3 if captured else 0)  # decode + prompt lengths 5, 9
    assert outs[True] == outs[False]


@pytest.mark.gpu
@pytest.mark.parametrize("top_k,n_experts", [(2, 8), (1, 4)])
def test_gpu_moe_combine_through_the_spmspv_kernel(cuda_device, top_k, n_experts):
    """The port's ``moe_apply_spmspv(impl="cuda")`` launches the SpMSpV
    kernel's passes once per token that keeps a slot, and at
    capacity_factor E / top_k (nothing drops) agrees with
    ``moe_apply_dense_ref`` within 1e-5 of ``moe._combine_scale`` (the
    (|A| |x|)_i of the products behind each output, float32); at 1.25 it
    agrees with ``moe_apply`` the same way.  The combine of one set of
    operands through the kernel equals it through the plain version on the
    CPU bit for bit."""
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    for cf in (n_experts / top_k, 1.25):
        cfg = moe.MoEConfig(n_experts=n_experts, top_k=top_k, d_ff=64,
                            capacity_factor=cf)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        p = moe.moe_init(gen, 128, cfg)
        x = torch.randn(2, 12, 128, generator=gen, device=cuda_device)
        scale = moe._combine_scale(p, x, cfg)
        dest = moe._dispatch_expert_outputs(p, x, cfg, aux=False)[1]
        _build.reset_launches()
        y = moe.moe_apply_spmspv(p, x, cfg, impl="cuda")
        # a token whose every slot dropped has no product: no launch
        nonempty = int((dest.reshape(2, 12, top_k)
                        < n_experts * moe.moe_capacity(12, cfg)).any(-1).sum())
        assert _build.LAUNCHES["spmspv_scatter"] == nonempty * SCATTER_LAUNCHES
        assert nonempty == 24 or cf < n_experts / top_k
        ref = (moe.moe_apply_dense_ref(p, x, cfg) if cf >= n_experts / top_k
               else moe.moe_apply(p, x, cfg)[0])
        err = (y.double() - ref.double()).abs()
        assert bool((err <= TOL * scale).all()), float((err - TOL * scale).max())
        out_flat, dest, weights = moe._dispatch_expert_outputs(p, x, cfg, aux=False)[:3]
        _assert_bits(moe.moe_combine_spmspv(out_flat, dest, weights),
                     moe.moe_combine_spmspv(out_flat.cpu(), dest.cpu(), weights.cpu()),
                     f"combine cf={cf}")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b"])
def test_gpu_moe_and_rwkv6_decode_graphs_equal_eager_bitwise(cuda_device, arch):
    """A reduced float32 granite-moe (routing, capacity scatter, batched
    experts) and rwkv6 (recurrent state updated in place): one replay of
    the server's decode graph gives eager ``decode_step``'s logits and
    state bit for bit, and captured and eager servers give every request
    the same tokens."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.runtime.server import BatchedServer, Request, _merge_slot

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    model = lm.init_model(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9, 5)]
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    assert srv.graphs == 1
    for i, p in enumerate(prompts[:2]):
        one, _ = lm.prefill(cfg, model, {"tokens": p[None]}, 32)
        _merge_slot(srv.state, one, i)
    state = {g: {k: t.clone() for k, t in leaves.items()}
             for g, leaves in srv.state.items()}
    toks = torch.as_tensor([[3], [7]], device=cuda_device)
    _, ref = lm.decode_step(cfg, model, state, toks)
    graph, tokens, _, logits = srv._decode
    tokens.copy_(toks)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(logits, ref)
    for g, leaves in state.items():
        for key, t in leaves.items():
            assert torch.equal(srv.state[g][key], t), (g, key)
    outs = {}
    for captured in (True, False):
        s = BatchedServer(cfg, model, batch_slots=2, max_seq=32, captured=captured)
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            s.submit(r)
        s.run_until_drained()
        outs[captured] = [r.out for r in reqs]
        assert all(t < cfg.vocab for o in outs[captured] for t in o)
    assert outs[True] == outs[False]


def _perturb_hybrid(model, seed: int = 0) -> None:
    """A hybrid's Mamba-2 layers and LoRA made live in place (at init its
    Mamba-2 layers are the identity and its LoRA zero: ROADMAP C.23):
    ``conv_w`` 0.2·N(0, 1), ``conv_b`` 0.1·N(0, 1), ``A_log`` log U(1, 16),
    ``dt_bias`` softplus⁻¹(U(0.001, 0.1)), ``lora_b`` 0.02·N(0, 1)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)

    def draw(t, fn):
        t.copy_(fn(torch.empty(t.shape, dtype=torch.float32, device=t.device)))

    for group in model.blocks:
        for layer in group:
            m = layer.mamba
            draw(m.conv_w, lambda e: e.normal_(generator=gen).mul_(0.2))
            draw(m.conv_b, lambda e: e.normal_(generator=gen).mul_(0.1))
            draw(m.A_log, lambda e: e.uniform_(1.0, 16.0, generator=gen).log_())
            draw(m.dt_bias, lambda e: e.uniform_(0.001, 0.1, generator=gen).expm1_().log_())
    draw(model.lora_b, lambda e: e.normal_(generator=gen).mul_(0.02))


@pytest.mark.gpu
def test_gpu_zamba2_decode_graph_equals_eager_bitwise(cuda_device):
    """The reduced zamba2 in float32 on perturbed weights (its Mamba-2
    states, (n_super, period, B, ...), updated in place): one replay of the
    server's decode graph gives eager ``decode_step``'s logits and state
    bit for bit, and captured and eager servers give every request the same
    tokens."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.runtime.server import BatchedServer, Request, _merge_slot

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("zamba2-2.7b"), dtype=torch.float32)
    model = lm.init_model(cfg, 0, device=cuda_device)
    _perturb_hybrid(model)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9, 5)]
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    assert srv.graphs == 1
    for i, p in enumerate(prompts[:2]):
        one, _ = lm.prefill(cfg, model, {"tokens": p[None]}, 32)
        _merge_slot(srv.state, one, i)
    state = {g: {k: t.clone() for k, t in leaves.items()}
             for g, leaves in srv.state.items()}
    assert set(state) == {"kv", "mamba"}
    toks = torch.as_tensor([[3], [7]], device=cuda_device)
    _, ref = lm.decode_step(cfg, model, state, toks)
    graph, tokens, _, logits = srv._decode
    tokens.copy_(toks)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(logits, ref)
    for g, leaves in state.items():
        for key, t in leaves.items():
            assert torch.equal(srv.state[g][key], t), (g, key)
    outs = {}
    for captured in (True, False):
        s = BatchedServer(cfg, model, batch_slots=2, max_seq=32, captured=captured)
        reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            s.submit(r)
        s.run_until_drained()
        outs[captured] = [r.out for r in reqs]
        assert all(t < cfg.vocab for o in outs[captured] for t in o)
    assert outs[True] == outs[False]


@pytest.mark.gpu
def test_gpu_zamba2_bcsr_shared_ffn_launches_twice_per_super_block(cuda_device):
    """The reduced zamba2 in bf16 with a (32, 32) bcsr shared FFN on the
    kernel (tensor cores): an eager decode step and each replay of the
    server's decode graph launch exactly 2 x n_super kernels (W1 and W2 at
    each application of the shared block), each counted under both
    ``bcsr_spmm_bf16`` and ``bcsr_spmm_bf16_mma``."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer

    cfg = dataclasses.replace(get_reduced("zamba2-2.7b"),
                              sparse_ffn=SparseFFNConfig(kind="bcsr", block=(32, 32)))
    model = lm.init_model(cfg, 0, device=cuda_device)
    _perturb_hybrid(model)
    per_step = 2 * (cfg.n_layers // cfg.hybrid_period)
    want = {"bcsr_spmm_bf16": per_step, "bcsr_spmm_bf16_mma": per_step}
    state = lm.init_decode_state(cfg, 2, 32, cuda_device)
    toks = torch.as_tensor([[3], [7]], device=cuda_device)
    _build.reset_launches()
    lm.decode_step(cfg, model, state, toks)
    assert dict(_build.LAUNCHES) == want
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    graph, tokens, _, logits = srv._decode
    for replays in (1, 2, 3):
        _build.reset_launches()
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {k: v * replays for k, v in want.items()}
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_gpu_audio_and_vlm_graphs_equal_eager(cuda_device, arch):
    """The reduced whisper-tiny and qwen2-vl in float32, requests with their
    own seeded frames or vision embeddings and M-RoPE positions: each
    replay of a prefill graph (its static inputs refilled per request)
    gives eager ``prefill``'s logits and state bit for bit, and captured
    and eager servers give every request the same tokens."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.modality import request_inputs
    from repro_torch.models import lm
    from repro_torch.runtime.server import BatchedServer, Request, prompt_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    model = lm.init_model(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(1)
    n = 6 + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    reqs = [(p, request_inputs(cfg, n, rng))
            for p in (rng.integers(0, cfg.vocab, n).astype(np.int32) for _ in range(3))]
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    for p, x in reqs:
        st, lg = srv._prefill_one(p, **x)
        torch.cuda.synchronize()
        batch = {k: torch.as_tensor(v, device=cuda_device)
                 for k, v in prompt_batch(p, **x).items()}
        st_e, lg_e = lm.prefill(cfg, model, batch, 32)
        assert torch.equal(lg, lg_e)
        for g, leaves in st_e.items():
            for key, t in leaves.items():
                assert torch.equal(st[g][key], t), (g, key)
    assert srv.graphs == 2
    outs = {}
    for captured in (True, False):
        s = BatchedServer(cfg, model, batch_slots=2, max_seq=32, captured=captured)
        rs = [Request(rid=i, prompt=p, max_new=6, **x) for i, (p, x) in enumerate(reqs)]
        for r in rs:
            s.submit(r)
        s.run_until_drained()
        outs[captured] = [[r._first, *r.out] for r in rs]
    assert outs[True] == outs[False]


@pytest.mark.gpu
def test_gpu_whisper_bcsr_ffn_launches_per_encoder_and_decoder_layer(cuda_device):
    """The reduced whisper-tiny in bf16 with a (32, 32) bcsr FFN on the
    kernel (tensor cores): a prefill launches 2 x (enc_layers + n_layers)
    kernels (W1 and W2 of every encoder and decoder layer) and a decode
    step 2 x n_layers, eager and at each graph replay, each counted under
    both ``bcsr_spmm_bf16`` and ``bcsr_spmm_bf16_mma``."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.modality import request_inputs
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.runtime.server import BatchedServer

    cfg = dataclasses.replace(get_reduced("whisper-tiny"),
                              sparse_ffn=SparseFFNConfig(kind="bcsr", block=(32, 32)))
    model = lm.init_model(cfg, 0, device=cuda_device)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, 4).astype(np.int32)
    x = request_inputs(cfg, 4, rng)
    counters = ("bcsr_spmm_bf16", "bcsr_spmm_bf16_mma")
    per_prefill = {c: 2 * (cfg.enc_layers + cfg.n_layers) for c in counters}
    per_step = {c: 2 * cfg.n_layers for c in counters}
    srv = BatchedServer(cfg, model, batch_slots=2, max_seq=32)
    srv._prefill_one(prompt, **x)  # warm-up and capture
    for replays in (1, 2):
        _build.reset_launches()
        for _ in range(replays):
            srv._prefill_one(prompt, **x)
            srv._decode_once(np.zeros((2, 1), np.int64))
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {c: (per_prefill[c] + per_step[c]) * replays
                                         for c in counters}
    _build.reset_launches()
    lm.decode_step(cfg, model, srv.state, torch.zeros((2, 1), dtype=torch.long,
                                                      device=cuda_device))
    assert dict(_build.LAUNCHES) == per_step


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _tiny_lm_cfg(**kw):
    from repro_torch.models.lm import ModelConfig

    return ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab=64, dtype=torch.float32,
                       remat="none", attn_chunk=16, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n_micro", [1, 2])
def test_gpu_train_step_equals_the_cpu_step(cuda_device, n_micro):
    """A float32 train step (TF32 off) of the same model on the card and on
    the CPU, launching no kernel: the metrics within 1e-5 relative, each
    gradient leaf within 1e-4 max|g|, and the parameters within 2e-5 plus
    what AdamW's first step, lr g / (|g| + eps), makes of the two devices'
    gradient rounding (an element whose clipped |g| is near eps moves by up
    to lr for a rounding-sized change of g: ROADMAP C.30)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptimConfig, adamw_init, global_norm
    from repro_torch.runtime.trainer import _on, _split_micro, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _tiny_lm_cfg()
    opt_cfg = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    batch = SyntheticTokens(vocab=64, batch=8, seq=16, seed=1).batch_at(0)
    cpu = lm.init_model(cfg, 0, device="cpu")
    runs = {}
    _build.reset_launches()
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        model = lm.init_model(cfg, 0, device=dev)
        model.load_state_dict(cpu.state_dict())
        params = lm.trainable(model)
        # the step's gradient as make_train_step forms it (summed microbatches / n)
        micro = _split_micro(_on(batch, dev), n_micro)
        grads = {n: torch.zeros(p.shape) for n, p in params.items()}
        for i in range(n_micro):
            loss, _ = lm.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                grads[n] += g.cpu()
        grads = {n: g / n_micro for n, g in grads.items()}
        scale = min(1.0, opt_cfg.clip_norm / float(global_norm(grads)))
        opt = adamw_init(params, opt_cfg)
        model, opt, metrics = make_train_step(cfg, opt_cfg, n_micro)(model, opt, batch)
        runs[name] = ({k: float(v) for k, v in metrics.items()}, model, grads, scale)
    assert not _build.LAUNCHES
    (m_cpu, cpu, g_cpu, s_cpu), (m_card, card, g_card, s_card) = runs["cpu"], runs["card"]
    for key, value in m_cpu.items():
        assert abs(m_card[key] - value) <= 1e-5 * max(abs(value), 1e-30), key
    for (name, a), b in zip(cpu.state_dict().items(), card.state_dict().values()):
        g1, g2 = g_cpu[name].double(), g_card[name].double()
        assert float((g2 - g1).abs().max()) <= 1e-4 * float(g1.abs().max()), name
        h1, h2 = g1 * s_cpu, g2 * s_card
        amp = 1e-3 * (h2 / (h2.abs() + opt_cfg.eps) - h1 / (h1.abs() + opt_cfg.eps)).abs()
        assert bool(((b.cpu() - a).abs().double() <= 2e-5 + amp).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("n_micro", [1, 2])
def test_gpu_sharded_step_on_a_2x4_mesh_equals_the_single_device_step(cuda_device, n_micro):
    """Phase 16a at the reduced size: ``make_mesh(1, 2, 4)`` puts all 8
    cells on the one card; a float32 sharded step (TF32 off, labels masked
    unevenly across the two data halves) against the single-device step on
    the card from the same weights, launching no kernel: the metrics within
    1e-5 relative, the gradient within 1e-4 of each leaf's max, the
    parameters within 2e-5 plus C.30's term.  Every block stays on the card."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import default_rules
    from repro_torch.optim.adamw import OptimConfig, adamw_init
    from repro_torch.runtime import trainer as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("qwen1.5-4b"), dtype=torch.float32)
    opt_cfg = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    batch = make_batch(cfg, 4, 32, step=0)
    batch["labels"][:2, 3:] = -1  # the first data half keeps 6 labels
    mesh = make_mesh(1, 2, 4, device=cuda_device)
    assert mesh.n_devices == 1 and mesh.devices[0] == torch.device("cuda", 0)
    _build.reset_launches()
    single = lm.init_model(cfg, 0, device=cuda_device)
    params = lm.trainable(single)
    micro = tt._split_micro(tt._on(batch, cuda_device), n_micro)
    g1 = {n: torch.zeros(p.shape, device=cuda_device) for n, p in params.items()}
    for i in range(n_micro):
        loss, _ = lm.loss_fn(cfg, single, {k: v[i] for k, v in micro.items()})
        for n, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
            g1[n] += g
    g1 = {n: (g / n_micro).double() for n, g in g1.items()}
    opt = adamw_init(params, opt_cfg)
    single, _, m1 = tt.make_train_step(cfg, opt_cfg, n_micro)(single, opt, batch)
    rules = default_rules(False)
    sm = tt.shard_model(cfg, lm.init_model(cfg, 0, device=cuda_device), mesh, rules)
    acc, _, _ = tt.sharded_grads(cfg, sm, batch, n_micro)
    g2 = {n: sm.full(n, acc, device=cuda_device).double() for n in acc}
    del acc
    o2 = tt.sharded_adamw_init(sm, opt_cfg, rules)
    sm, o2, m2 = tt.make_sharded_train_step(cfg, opt_cfg, n_micro)(sm, o2, batch)
    assert not _build.LAUNCHES
    assert all(s.device.type == "cuda" for tree in (sm.blocks, o2["m"], o2["v"])
               for stacks in tree.values() for s in stacks.values())
    for key, value in m1.items():
        assert abs(float(m2[key]) - float(value)) <= 1e-5 * max(abs(float(value)), 1e-30), key
    s1, s2 = (min(1.0, opt_cfg.clip_norm / float(torch.sqrt(sum((g * g).sum()
                                                              for g in gs.values()))))
              for gs in (g1, g2))
    for name, a in single.state_dict().items():
        assert float((g2[name] - g1[name]).abs().max()) <= 1e-4 * float(g1[name].abs().max())
        h1, h2 = g1[name] * s1, g2[name] * s2
        amp = 1e-3 * (h2 / (h2.abs() + opt_cfg.eps) - h1 / (h1.abs() + opt_cfg.eps)).abs()
        b = sm.full(name, device=cuda_device)
        assert bool(((b - a).abs().double() <= 2e-5 + amp).all()), name


@pytest.mark.gpu
def test_gpu_kernel_wrappers_and_the_cuda_tier_ffn_refuse_autograd(cuda_device):
    """No kernel output reaches autograd as a constant on the card: each
    wrapper raises ``NotImplementedError`` on an operand that requires grad
    and launches nothing; a bcsr model at ``impl="cuda"`` refuses its
    backward, and at ``impl="ref"`` it trains."""
    import dataclasses

    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import lm
    from repro_torch.models.ffn import SparseFFNConfig
    from repro_torch.optim.adamw import OptimConfig, adamw_init
    from repro_torch.runtime.trainer import make_train_step

    rng = np.random.default_rng(0)
    dense = ((rng.random((64, 64)) < 0.1) * rng.standard_normal((64, 64))).astype(np.float32)
    csr = tf.csr_from_dense(dense)
    sell = tops.sell_prepare(tf.sell_from_csr(csr, C=8, sigma=16), device=cuda_device)
    slabs = tops.sell_prepare_blocked_stacked(csr, 2, device=cuda_device)
    bcsr = tops.bcsr_prepare(tf.bcsr_from_csr(csr, (8, 8)), device=cuda_device)
    spv = spmspv_prepare(csr, device=cuda_device)
    st = stage_sparse(spv, np.array([1, 5, 9], np.int32), np.array([1.0, -2.0, 0.5], np.float32))
    calls = (
        ("sell_spmv", torch.ones(64, device=cuda_device), lambda x: tops.sell_spmv(sell, x)),
        ("sell_spmv_blocked", torch.ones(64, device=cuda_device),
         lambda x: tops.sell_spmv_blocked_stacked(slabs, x)),
        ("bcsr_spmm", torch.ones(64, 3, device=cuda_device), lambda x: tops.bcsr_spmm(bcsr, x)),
        ("spmspv_scatter", st["xv"].clone(),
         lambda x: spmspv_scatter(spv, st["xi"], x, st["flags"], st["plan"])),
    )
    for name, x, call in calls:
        once = SCATTER_LAUNCHES if name == "spmspv_scatter" else 1
        _build.reset_launches()
        y = call(x)
        assert _build.LAUNCHES[name] == once, name
        x.requires_grad_(True)
        with pytest.raises(NotImplementedError, match=name):
            call(x)
        assert _build.LAUNCHES[name] == once, name  # the refused call launched nothing
        with torch.no_grad():
            assert torch.equal(call(x), y), name
    cfg = dataclasses.replace(_tiny_lm_cfg(), sparse_ffn=SparseFFNConfig(
        kind="bcsr", block=(16, 16), density=0.5))
    model = lm.init_model(cfg, 0, device=cuda_device)
    params = lm.trainable(model)
    batch = make_batch(cfg, 2, 16, 0)
    _build.reset_launches()
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        lm.loss_fn(cfg, model, batch)[0].backward()
    assert not _build.LAUNCHES
    ref = dataclasses.replace(cfg, sparse_ffn=dataclasses.replace(cfg.sparse_ffn, impl="ref"))
    opt_cfg = OptimConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    before = model.blocks[0].ffn.w1_blocks.detach().clone()
    _, _, metrics = make_train_step(ref, opt_cfg)(model, adamw_init(params, opt_cfg), batch)
    assert float(metrics["grad_norm"]) > 0 and not _build.LAUNCHES
    assert not torch.equal(model.blocks[0].ffn.w1_blocks, before)


# ---------------------------------------------------------------------------
# the dry run's analyzer against the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_train_step_matches_its_op_analysis(cuda_device):
    """Phase 17a at 2 layers: qwen1.5-4b's bf16 train step at full width (8
    x 128, AdamW with float32 moments) analysed on meta
    (``launch.dryrun.analyze_train_step``) and run on the card under
    ``torch.profiler`` (``with_flops``), launching no kernel: the analyzer's
    matmul FLOPs within 0.1 % of the profiler's FLOPs of the ``aten::mm``,
    ``addmm``, ``bmm`` and ``baddbmm`` calls that launched a kernel (one
    call a block launches none: the recomputation's early stop); its FLOPs over 989 TFLOP/s and its
    bytes over 3.35 TB/s each at most the step's device-busy time;
    ``argument_size`` within 1 % of the allocator's bytes once the state is
    built."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTokens
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptimConfig, adamw_init
    from repro_torch.runtime.trainer import make_train_step

    cfg = dataclasses.replace(get_config("qwen1.5-4b"), n_layers=2)
    opt_cfg = OptimConfig(lr_peak=3e-4, warmup_steps=1, total_steps=6)
    meta = {k: torch.empty((8, 128), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    an = dryrun.analyze_train_step(cfg, meta, opt_cfg)
    _build.reset_launches()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = lm.init_model(cfg, 0, device=cuda_device)
    opt = adamw_init(lm.trainable(model), opt_cfg)
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - before
    assert abs(an["argument_bytes"] - state) <= 0.01 * state
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in
             MarkovTokens(cfg.vocab, batch=8, seq=128, seed=0).batch_at(0).items()}
    step = make_train_step(cfg, opt_cfg)
    model, opt, _ = step(model, opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        model, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
    events = prof.events()
    # the matmul calls that launched a kernel: remat's early stop raises in
    # each recomputed block's last matmul after the profiler records it
    mm = [e for e in events if e.name in ("aten::mm", "aten::addmm", "aten::bmm",
                                          "aten::baddbmm")]
    flops = sum(e.flops or 0 for e in mm if e.kernels)
    assert abs(an["cost"].matmul_flops - flops) <= 1e-3 * flops
    assert sum(1 for e in mm if not e.kernels) == cfg.n_layers
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_s = busy / 1e6
    assert an["cost"].flops / roofline.PEAK_FLOPS <= busy_s
    assert an["cost"].hbm_bytes / roofline.HBM_BW <= busy_s
    assert not _build.LAUNCHES


@pytest.mark.gpu
def test_gpu_quickstart_twin_launches_and_holds_its_kernels(cuda_device):
    """``examples/quickstart_torch.py`` on the card (its default device):
    the SELL kernel and the float32 BCSR kernel launch, and their products,
    the tuned operator's and the engine's are within 1e-5 (|A| |x|)_i of a
    float64 oracle and of the plain tier; the engine records no event."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("example_quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _build.reset_launches()
    out = mod.main([])
    launches = dict(_build.LAUNCHES)
    assert launches.get("sell_spmv", 0) >= 1 and launches.get("bcsr_spmm", 0) >= 1, launches
    a = out["a"]
    A = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape)
    x, X = out["x"].cpu().numpy(), out["X"].cpu().numpy()
    for key in ("y_k", "y_t"):
        assert out[key].device.type == "cuda"
        assert_rowtol(out[key].cpu().numpy(), A @ x.astype(np.float64), a, x, key)
        assert_rowtol(out[key].cpu().numpy(), out["y"].cpu().numpy(), a, x, key)
    assert_rowtol(out["Y_k"].cpu().numpy(), A @ X.astype(np.float64), a, X, "Y_k")
    assert_rowtol(out["Y_k"].cpu().numpy(), out["Y"].cpu().numpy(), a, X, "Y_k")
    for xi, yi in zip(out["engine_xs"], out["engine_ys"]):
        assert_rowtol(yi.cpu().numpy(), A @ xi.astype(np.float64), a, xi, "engine")
    assert not {"batch_failed", "demote", "batch_abandoned"} & set(out["engine_events"])

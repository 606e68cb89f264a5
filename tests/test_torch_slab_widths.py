"""Per-(slab, chunk) widths of the stacked column-slab SELL format.

``chunk_w`` (n_slabs, n_chunks) says how many slots of each chunk the
column-slab kernel reads.  It is derived from the prepared arrays alone, so
the port's own prepare and ``repro``'s prepared dict carried across with
``repro_torch.interop`` must give the same widths: the exact largest
per-(row, slab) nonzero count of each chunk, rounded up to 4.  The masked
plain version is held against ``repro``'s Pallas kernel in interpret mode;
tolerance per row i: |port - repro| <= 1e-5 * (|A| |x|)_i, since only the
summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.kernels import ops as jops
from repro.kernels.sell_spmv import sell_spmv_blocked_pallas

from repro_torch import interop
from repro_torch.core import formats as tf
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sell_spmv import sell_spmv_blocked_plain

torch.set_num_threads(1)

TOL = 1e-5


def _matrix(case: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    m, n = 150, 132
    if case == "empty":
        return np.zeros((m, n), np.float32)
    lengths = rng.integers(0, 30, size=m)  # rows of very different lengths
    d = np.zeros((m, n), np.float32)
    for r, cnt in enumerate(lengths):
        d[r, rng.choice(n, size=cnt, replace=False)] = rng.standard_normal(cnt)
    d[5:17] = 0.0  # empty rows, a chunk's worth and more
    if case == "empty_slab":
        d[:, 44:88] = 0.0  # the middle of three slabs holds no entries
    return d


def _exact_widths(d: np.ndarray, prep) -> np.ndarray:
    """The largest per-(row, slab) count of every chunk, rounded up to 4,
    counted from the dense matrix and the prepare's row order."""
    n_slabs, n_chunks = prep["cols"].shape[:2]
    slab_n = prep["slab_n"]
    perm = np.asarray(prep["row_perm"])
    want = np.zeros((n_slabs, n_chunks), np.int64)
    for s in range(n_slabs):
        counts = (d[:, s * slab_n : (s + 1) * slab_n] != 0).sum(axis=1)
        per_pos = np.where(perm >= 0, counts[np.maximum(perm, 0)], 0)
        want[s] = per_pos.reshape(n_chunks, 8).max(axis=1)
    return -(-want // 4) * 4


@pytest.mark.parametrize("case", ["random", "empty_slab", "empty"])
def test_chunk_widths_equal_carried_and_exact(case):
    d = _matrix(case)
    own = tops.sell_prepare_blocked_stacked(tf.csr_from_dense(d), 3, device="cpu")
    jprep = jops.sell_prepare_blocked_stacked(jf.csr_from_dense(d), 3)
    carried = interop.prep_from_arrays("sell_blocked_stacked",
                                       *interop.split(jprep), "cpu")
    cw = own["chunk_w"]
    assert cw.dtype == torch.int32 and tuple(cw.shape) == own["cols"].shape[:2]
    np.testing.assert_array_equal(cw.numpy(), carried["chunk_w"].numpy())
    np.testing.assert_array_equal(cw.numpy(), _exact_widths(d, own))
    if case == "empty_slab":
        assert not bool(cw[1].any()) and bool(cw[0].any())
    if case == "empty":
        assert not bool(cw.any())
    # what the widths leave unread is padding: (column 0, value 0.0)
    slot = torch.arange(own["cols"].shape[3])
    past = slot >= cw[..., None, None]
    assert not bool(own["vals"].masked_select(past).any())
    assert not bool(own["cols"].masked_select(past).any())


@pytest.mark.parametrize("n_slabs", [2, 3])
def test_masked_plain_matches_pallas_kernel(n_slabs):
    d = _matrix("empty_slab")
    x = np.random.default_rng(4).standard_normal(d.shape[1]).astype(np.float32)
    jprep = jops.sell_prepare_blocked_stacked(jf.csr_from_dense(d), n_slabs)
    slab_n = int(jprep["slab_n"])
    x_pad = np.zeros(n_slabs * slab_n, np.float32)
    x_pad[: d.shape[1]] = x
    sums = np.asarray(sell_spmv_blocked_pallas(
        jprep["cols"], jprep["vals"], jnp.asarray(x_pad), slab_n=slab_n,
        interpret=True))
    perm = np.asarray(jprep["row_perm"])
    y_pallas = np.zeros(d.shape[0], np.float32)
    y_pallas[perm[perm >= 0]] = sums[perm >= 0]
    p = interop.prep_from_arrays("sell_blocked_stacked", *interop.split(jprep), "cpu")
    y = sell_spmv_blocked_plain(p["cols"], p["vals"], torch.as_tensor(x_pad),
                                p["row_perm"], d.shape[0], slab_n,
                                p["chunk_w"]).numpy()
    scale = np.abs(d.astype(np.float64)) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(y - y_pallas) <= TOL * scale)
    assert np.all(np.abs(y - d.astype(np.float64) @ x) <= TOL * scale)


def test_skipped_padding_changes_no_finite_answer():
    """Padding is (column 0, value 0.0).  With x = inf at a slab's first
    column, every row that holds that column is non-finite, and so is every
    row whose chunk reads padding there, masked or not; the slots past
    chunk_w add no NaN of their own, and every finite row is unchanged."""
    d = _matrix("random")
    n_slabs = 3
    p = tops.sell_prepare_blocked_stacked(tf.csr_from_dense(d), n_slabs, device="cpu")
    slab_n = p["slab_n"]
    x = torch.ones(n_slabs * slab_n)
    x[slab_n] = float("inf")  # first column of slab 1
    args = (p["cols"], p["vals"], x, p["row_perm"], d.shape[0], slab_n)
    y = sell_spmv_blocked_plain(*args, p["chunk_w"])
    full = torch.full_like(p["chunk_w"], p["cols"].shape[3])
    y_unmasked = sell_spmv_blocked_plain(*args, full)
    touches = torch.as_tensor(d[:, slab_n] != 0)
    assert bool(touches.any()) and not bool(torch.isfinite(y[touches]).any())
    finite = torch.isfinite(y)
    assert bool(finite.any())
    assert bool((finite | ~torch.isfinite(y_unmasked)).all())
    assert torch.equal(y[torch.isfinite(y_unmasked)],
                       y_unmasked[torch.isfinite(y_unmasked)])


def test_widths_from_elsewhere_round_up_to_4_and_clamp_to_row():
    """A width the prepare did not make (not a multiple of 4, past W, below
    0) reads slots w < min(max(round_up_4(width), 0), W), as the kernel
    does: summed slot by slot here, in float64."""
    rng = np.random.default_rng(6)
    n_slabs, n_chunks, W, slab_n = 2, 3, 8, 5
    cols = rng.integers(0, slab_n, (n_slabs, n_chunks, 8, W)).astype(np.int32)
    vals = rng.standard_normal((n_slabs, n_chunks, 8, W)).astype(np.float32)
    x = rng.standard_normal(n_slabs * slab_n).astype(np.float32)
    cw = np.array([[-5, 1, 9], [3, 8, 13]], np.int32)
    y = sell_spmv_blocked_plain(
        torch.as_tensor(cols), torch.as_tensor(vals), torch.as_tensor(x),
        torch.arange(n_chunks * 8, dtype=torch.int32), n_chunks * 8, slab_n,
        torch.as_tensor(cw)).numpy()
    want = np.zeros(n_chunks * 8)
    scale = np.zeros(n_chunks * 8)
    for s in range(n_slabs):
        for c in range(n_chunks):
            w = min(max(-(-int(cw[s, c]) // 4) * 4, 0), W)
            for r in range(8):
                t = (vals[s, c, r, :w].astype(np.float64)
                     * x[s * slab_n + cols[s, c, r, :w]])
                want[c * 8 + r] += t.sum()
                scale[c * 8 + r] += np.abs(t).sum()
    assert np.all(np.abs(y - want) <= TOL * scale)

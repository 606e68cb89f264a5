"""The port's partition (``repro_torch.core.partition``) and mesh operands
against the JAX package's, on the same numpy inputs.

The partition is host numpy on both sides, so ``repro``'s functions run in
this process at any shard count.  Every array must equal ``repro``'s bit for
bit: dtype, shape and bytes, including shapes not divisible by P, more
shards than rows (empty shards and cells) and all-zero rows and columns.
``assemble_rows`` must round-trip exactly."""
import numpy as np
import pytest
import torch

from repro.core import distributed as jd
from repro.core import partition as jp
from repro.core.formats import csr_from_dense as j_csr_from_dense
from repro.data.suite import generate as j_generate

from repro_torch.core import distributed as td
from repro_torch.core import partition as tp
from repro_torch.core.formats import CSRMatrix, csr_from_dense
from repro_torch.data.suite import generate

torch.set_num_threads(1)

# (m, n, density, seed): square, wide, tall, a single row, and one whose
# first rows and last columns are empty.
SHAPES = [(40, 40, 0.15, 0), (23, 57, 0.2, 1), (61, 19, 0.25, 2), (1, 30, 0.5, 3),
          (33, 35, 0.2, 4)]


def pair(m, n, density, seed):
    rng = np.random.default_rng(seed)
    d = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    if seed == 4:
        d[:5] = 0.0
        d[:, -7:] = 0.0
    return d, j_csr_from_dense(d), csr_from_dense(d)


def same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype,
                                                                  want.dtype)
    assert np.array_equal(got, want), what


def same_csr(t, j, what=""):
    assert tuple(t.shape) == tuple(j.shape), what
    for f in ("indptr", "indices", "data"):
        same(getattr(t, f), getattr(j, f), f"{what} {f}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("P", [1, 2, 3, 4, 7])
def test_rows_balanced_matches_repro(shape, P):
    _, ja, ta = pair(*shape)
    jpart, tpart = jp.rows_balanced(ja, P), tp.rows_balanced(ta, P)
    same(tpart.bounds, jpart.bounds, "bounds")
    assert tpart.n_shards == jpart.n_shards == P
    for p, (t, j) in enumerate(zip(tpart.shards, jpart.shards)):
        same_csr(t, j, f"shard {p}")
    assert tpart.nnz_imbalance() == jpart.nnz_imbalance()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("grid", [(1, 1), (2, 3), (4, 4), (3, 2), (8, 8)])
def test_grid_2d_matches_repro(shape, grid):
    """(8, 8) on a single row or 19 columns leaves cells empty."""
    _, ja, ta = pair(*shape)
    jg, tg = jp.grid_2d(ja, grid), tp.grid_2d(ta, grid)
    assert len(tg) == len(jg) == grid[0]
    for i, (trow, jrow) in enumerate(zip(tg, jg)):
        assert len(trow) == len(jrow) == grid[1]
        for j, (t, jc) in enumerate(zip(trow, jrow)):
            same_csr(t, jc, f"cell {i},{j}")


def test_grid_2d_on_a_suite_matrix_matches_repro():
    """A Table 1 matrix (cant, scaled down) in the ring's (4, 4) grid."""
    ja, ta = j_generate("cant", scale=1 / 16), generate("cant", scale=1 / 16)
    for trow, jrow in zip(tp.grid_2d(ta, (4, 4)), jp.grid_2d(ja, (4, 4))):
        for t, j in zip(trow, jrow):
            same_csr(t, j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("P", [1, 3, 4])
def test_stacked_shards_match_repro(shape, P):
    _, ja, ta = pair(*shape)
    jst = jp.stack_csr_shards(jp.rows_balanced(ja, P).shards)
    tst = tp.stack_csr_shards(tp.rows_balanced(ta, P).shards)
    assert sorted(tst) == sorted(jst)
    for key in jst:
        same(tst[key], jst[key], key)
    jgr = jp.stack_grid_shards(jp.grid_2d(ja, (P, P)))
    tgr = tp.stack_grid_shards(tp.grid_2d(ta, (P, P)))
    assert sorted(tgr) == sorted(jgr)
    for key in jgr:
        same(tgr[key], jgr[key], f"grid {key}")


@pytest.mark.parametrize("schedule", td.SCHEDULES)
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_mesh_operands_match_repro(schedule, P):
    """Both schedules' operands, columns padded to a multiple of P."""
    for shape in SHAPES:
        _, ja, ta = pair(*shape)
        jop, top = jd.build_mesh_operand(ja, P, schedule), td.build_mesh_operand(
            ta, P, schedule)
        assert (top["schedule"], top["n_shards"], top["n_pad"], top["shape"]) == (
            jop["schedule"], jop["n_shards"], jop["n_pad"], jop["shape"])
        same(top["shard_rows"], jop["shard_rows"], "shard_rows")
        assert sorted(top["arrays"]) == sorted(jop["arrays"])
        for key in jop["arrays"]:
            same(top["arrays"][key], jop["arrays"][key], f"{schedule} {key}")


def test_ring_operand_pads_every_cell_to_the_largest():
    """The ring grid stores P*P cells of the largest cell's nnz, as in the
    JAX package: on a banded matrix the off-diagonal cells are near empty,
    so the ring stores several times nnz(A) (ROADMAP C.16)."""
    a = generate("cant", scale=1 / 16)
    P = 4
    ring = td.build_mesh_operand(a, P, "ring")["arrays"]
    allg = td.build_mesh_operand(a, P, "allgather")["arrays"]
    cells = ring["indptr"][:, :, -1]  # each cell's stored (unpadded) nnz
    assert int(cells.sum()) == a.nnz
    assert ring["indices"].shape == (P, P, int(cells.max()))
    assert ring["indices"].size > 3 * a.nnz > allg["indices"].size


@pytest.mark.parametrize("P", [1, 2, 4, 6])
def test_assemble_rows_round_trips(P):
    """Rows split at arbitrary (possibly empty-shard) boundaries, padded to
    a common count and assembled, as stacked tensors or a per-shard list,
    give Y back exactly; ``repro``'s assemble_rows agrees."""
    rng = np.random.default_rng(P)
    for m, k in ((0, 2), (1, 1), (17, 3), (50, 8)):
        y = rng.standard_normal((m, k)).astype(np.float32)
        bounds = np.concatenate([[0], np.sort(rng.integers(0, m + 1, P - 1)), [m]])
        counts = np.diff(bounds)
        stacked = np.zeros((P, max(int(counts.max()), 1), k), np.float32)
        for p in range(P):
            stacked[p, : counts[p]] = y[bounds[p]:bounds[p + 1]]
        got = td.assemble_rows(torch.as_tensor(stacked), counts)
        same(got.numpy(), y)
        same(td.assemble_rows(list(torch.as_tensor(stacked)), counts).numpy(), y)
        same(np.asarray(jd.assemble_rows(stacked, counts)), got.numpy())


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_mesh_operands_are_lossless(P):
    """Re-assembled from the stacked arrays, both operands give A back: no
    entry dropped or duplicated by the row split, the column padding or the
    ring's slab-local indices."""
    for shape in SHAPES:
        d, _, a = pair(*shape)
        m, n = a.shape
        for schedule in td.SCHEDULES:
            op = td.build_mesh_operand(a, P, schedule)
            arrs, slab = op["arrays"], op["n_pad"] // P
            total = np.zeros((m, op["n_pad"]), np.float64)
            row0 = 0
            for p in range(P):
                rows = int(op["shard_rows"][p])
                cells = ([(arrs["indptr"][p], arrs["indices"][p], arrs["data"][p], 0)]
                         if schedule == "allgather" else
                         [(arrs["indptr"][p, j], arrs["indices"][p, j], arrs["data"][p, j],
                           j * slab) for j in range(P)])
                for indptr, indices, data, col0 in cells:
                    for r in range(rows):
                        s, e = int(indptr[r]), int(indptr[r + 1])
                        np.add.at(total[row0 + r], col0 + indices[s:e], data[s:e])
                row0 += rows
            assert row0 == m
            same(total[:, :n].astype(np.float32), d)
            assert not total[:, n:].any()


def test_row_partition_counts_shards_and_imbalance():
    a = CSRMatrix((4, 4), np.array([0, 4, 4, 4, 4], np.int32),
                  np.arange(4, dtype=np.int32), np.ones(4, np.float32))
    part = tp.rows_balanced(a, 2)
    assert part.n_shards == 2 and [s.nnz for s in part.shards] == [4, 0]
    assert part.nnz_imbalance() == 2.0

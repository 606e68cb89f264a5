"""The yardstick on the CPU: the frozen generators, the data drawn from the
seed, the traffic schedules, the format-free bound, the trace reduction and
the plain reference with its control."""
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "bench"))

from benchkit import bound, data, spec, trace, traffic  # noqa: E402
from benchkit.cell import Reservoir  # noqa: E402

REF = spec.reference(ROOT, "csr_spmv")
CONFIGS = {p.stem: spec.load_json(p) for p in sorted((ROOT / "bench/configs").glob("*.json"))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frozen_rows_are_table1s(name):
    from repro_torch.data.suite import SUITE

    row = next(s for s in SUITE if s.name == name)
    mine = CONFIGS[name]["matrix"]
    assert (mine["idx"], mine["n_rows"], mine["nnz"], mine["family"], mine["band"],
            mine["max_row"]) == (row.idx, row.n_rows, row.nnz, row.family, row.band,
                                 row.max_row)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("scale", [1 / 512, 1 / 128])
def test_frozen_generator_reproduces_the_programs(name, scale):
    from repro_torch.data.suite import generate

    a = generate(name, scale=scale)
    n, indptr, indices = data.generate(ROOT, CONFIGS[name]["matrix"], scale)
    assert (n, n) == a.shape
    np.testing.assert_array_equal(indptr, a.indptr)
    np.testing.assert_array_equal(indices, a.indices)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frozen_generator_keeps_table1s_row_statistics(name):
    row = CONFIGS[name]["matrix"]
    n, indptr, indices = data.generate(ROOT, row, 1 / 64)
    per_row = np.diff(indptr)
    assert n == int(row["n_rows"] / 64)
    assert per_row.max() <= row["max_row"] and per_row.min() >= 1
    # within the departure each configuration states under "assumed"
    assert abs(per_row.mean() / (row["nnz"] / row["n_rows"]) - 1) < 0.2
    cols = np.diff(indices.astype(np.int64))
    starts = indptr[1:-1]
    assert np.all(np.delete(cols, starts[starts < cols.size] - 1) > 0)  # ascending


def test_structure_cache_round_trip(tmp_path):
    conf = CONFIGS["cage14"]
    assert not data.structure_path(ROOT, conf, 1 / 512, tmp_path).exists()
    first = data.structure(ROOT, conf, 1 / 512, cache=tmp_path)
    assert data.structure_path(ROOT, conf, 1 / 512, tmp_path).exists()
    assert len(list(tmp_path.glob("cage14-*.npz"))) == 1
    again = data.structure(ROOT, conf, 1 / 512, cache=tmp_path)
    assert first[0] == again[0]
    for x, y in zip(first[1:], again[1:]):
        np.testing.assert_array_equal(x, y)


def test_values_and_pool_are_drawn_from_the_seed():
    seed = 2**31 + 12345
    v1, x1 = data.draw(seed, 1000, 300, 4, torch.device("cpu"))
    v2, x2 = data.draw(seed, 1000, 300, 4, torch.device("cpu"))
    v3, _ = data.draw(seed + 1, 1000, 300, 4, torch.device("cpu"))
    assert torch.equal(v1, v2) and torch.equal(x1, x2) and not torch.equal(v1, v3)
    assert x1.shape == (4, 300) and x1.dtype == torch.float32


def test_generated_counts_are_the_configurations_own():
    """At full size the stand-in's rows and stored values are those each
    configuration records under ``generated``: checked per row at 1/64
    scale, where the band narrows and overlaps shift the count by a few %
    (the full count is a CPU minute)."""
    for conf in CONFIGS.values():
        assert conf["generated"]["n_rows"] == conf["matrix"]["n_rows"]
        ratio = conf["generated"]["nnz"] / conf["matrix"]["nnz"] - 1
        n, indptr, _ = data.generate(ROOT, conf["matrix"], 1 / 64)
        assert abs(indptr[-1] / n / (conf["generated"]["nnz"] / conf["generated"]["n_rows"])
                   - 1) < 0.05
        assert f"{100 * ratio:.1f} %" in conf["assumed"]["nnz"] or abs(ratio) < 1e-3


def test_poisson_schedule_is_deterministic_and_keeps_its_gaps_across_seeds():
    mix = {"rate_per_s": 5000.0, "pool": 256}
    a = traffic.schedule(mix, 2**31 + 7, 20)
    b = traffic.schedule(mix, 2**31 + 7, 20)
    c = traffic.schedule(mix, 2**31 + 8, 20)
    np.testing.assert_array_equal(a.due_s, b.due_s)
    np.testing.assert_array_equal(a.order, b.order)
    assert not np.array_equal(a.due_s[:100], c.due_s[:100])
    # the same multiset of gaps, reordered: the counts differ only at the tail
    assert abs(a.due_s.shape[0] - c.due_s.shape[0]) < 0.01 * a.due_s.shape[0]
    assert abs(a.due_s.shape[0] / 20 / 5000 - 1) < 0.03
    assert a.due_s[0] == 0 and np.all(np.diff(a.due_s) >= 0) and a.due_s[-1] < 20


def test_closed_loop_is_deterministic_in_the_seed():
    mix = {"outstanding": 192, "pool": 256, "warm": [64]}
    a = traffic.schedule(mix, 99, 20)
    b = traffic.schedule(mix, 99, 20)
    c = traffic.schedule(mix, 100, 20)
    assert [a.pool_index(i) for i in range(600)] == [b.pool_index(i) for i in range(600)]
    assert [a.pool_index(i) for i in range(256)] != [c.pool_index(i) for i in range(256)]
    assert sorted(a.pool_index(i) for i in range(256)) == list(range(256))
    assert a.outstanding == 192 and a.warm == (64,) and a.due_s is None and not a.timed
    for bad in ({"kind": "bursts", "pool": 1}, {"pool": 1},
                {"pool": 1, "outstanding": 4, "phases": [[1, 1]]}):
        with pytest.raises(ValueError):
            traffic.schedule(bad, 0, 1)


def test_bursts_are_parameters_of_the_one_generator():
    """On/off bursts at 4x the mean rate: every arrival in an on piece, the
    mean rate kept, deterministic in the seed, the same count every seed."""
    mix = {"rate_per_s": 2000.0, "phases": [[0.064, 4.0], [0.192, 0.0]], "pool": 16,
           "outstanding": 256}
    a = traffic.schedule(mix, 2**31 + 5, 20)
    b = traffic.schedule(mix, 2**31 + 5, 20)
    c = traffic.schedule(mix, 2**31 + 6, 20)
    np.testing.assert_array_equal(a.due_s, b.due_s)
    assert np.all(np.mod(a.due_s, 0.256) < 0.064 + 1e-9) and a.outstanding == 256
    assert abs(a.due_s.shape[0] / 20 / 2000 - 1) < 0.03
    assert abs(a.due_s.shape[0] - c.due_s.shape[0]) < 0.01 * a.due_s.shape[0]
    assert np.all(np.diff(a.due_s) >= 0) and a.timed
    # with every factor 1, the cycle is the plain Poisson schedule
    flat = traffic.schedule(dict(mix, phases=[[0.5, 1.0]]), 9, 5).due_s
    np.testing.assert_allclose(flat, traffic.schedule({"rate_per_s": 2000.0, "pool": 16},
                                                      9, 5).due_s, rtol=0, atol=1e-9)


def test_reservoir_keeps_every_slot_of_a_wide_batch():
    res = Reservoir(
        64, 3, torch.device("cpu"), 2**31 + 1, 64)
    for batch in range(10):
        for slot in range(64):
            res.offer(torch.full((3,), float(slot)), 1000 * batch + slot, slot)
    Y, idx = res.kept()
    assert res.slots() == 64 and Y.shape == (64, 3)
    assert sorted(int(i) % 1000 for i in idx) == list(range(64))
    assert all(float(Y[j, 0]) == idx[j] % 1000 for j in range(64))
    narrow = Reservoir(
        64, 3, torch.device("cpu"), 7, 1)
    for i in range(500):
        narrow.offer(torch.zeros(3), i, 0)
    assert narrow.kept()[0].shape[0] == 64 and narrow.seen == 500


def test_bound_on_a_hand_counted_csr():
    # 3 x 4 matrix, 5 stored values, a batch of 2 requests:
    # bytes 4*5 + 4*(4+3)*2 = 76, flops 2*5*2 = 20
    assert bound.batch_bytes(5, 3, 4, 2) == 76
    assert bound.batch_flops(5, 2) == 20
    assert bound.batch_bound_s(5, 3, 4, 2) == pytest.approx(76 / 3.35e12)


@pytest.mark.parametrize("nnz,n,b,ms", [(23_701_107, 952_203, 64, 0.174),
                                        (27_132_179, 1_505_785, 64, 0.2625),
                                        (23_701_107, 952_203, 1, 0.0306)])
def test_bound_at_table1_size(nnz, n, b, ms):
    assert bound.batch_bound_s(nnz, n, n, b) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_trace_reduction():
    dev = [("k1", 10, 20), ("k1", 30, 40), ("copy", 35, 50), ("k2", 90, 95)]
    spans = [("step", 0, 12), ("wait", 50, 89)]
    r = trace.reduce(0, 100, dev, spans)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx((10 + 20 + 5) * 1e-9)
    assert r["device_s"] == pytest.approx((10 + 10 + 15 + 5) * 1e-9)
    assert r["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    assert [g[0] for g in r["idle_gaps"]] == ["wait", "step", "host", "host"]
    assert r["idle_gaps"][0][1] == pytest.approx(40e-9)


def _random_csr(m, n, density, seed):
    a = sp.random(m, n, density=density, format="csr", dtype=np.float64,
                  random_state=np.random.default_rng(seed))
    a.data = a.data.astype(np.float32) - np.float32(0.5)
    a.setdiag(np.ones(min(m, n), np.float32))
    a = a.tocsr()
    a.sort_indices()
    return a


def _operands(a, s, seed):
    X = torch.from_numpy(np.random.default_rng(seed).standard_normal((a.shape[1], s))
                         .astype(np.float32))
    return (torch.from_numpy(a.indptr.astype(np.int32)),
            torch.from_numpy(a.indices.astype(np.int32)),
            torch.from_numpy(a.data.astype(np.float32))), X


def test_reference_equals_scipy_in_float64():
    a = _random_csr(300, 250, 0.05, 1)
    arrays, X = _operands(a, 5, 2)
    Y64, AX = REF.reference(*arrays, X)
    a64 = a.astype(np.float64)
    np.testing.assert_allclose(Y64.numpy(), a64 @ X.double().numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(AX.numpy(), abs(a64) @ np.abs(X.double().numpy()),
                               rtol=1e-12, atol=1e-12)
    # a float32 product passes; the same rounded to bfloat16 is refused
    y32 = torch.from_numpy((a @ X.numpy()).astype(np.float32))
    assert REF.rel_err(y32, Y64, AX) <= REF.MAX_REL_ERR
    assert REF.rel_err(y32.bfloat16().float(), Y64, AX) > REF.MAX_REL_ERR
    bad = y32.clone()
    bad[7, 3] = float("nan")
    assert REF.rel_err(bad, Y64, AX) == float("inf")


@pytest.mark.parametrize("config", ["ldoor", "cage14"])
def test_control_reads_above_the_limit(config, tmp_path):
    """The reference one precision lower (bfloat16 operands) in the
    program's place fails the comparison by a wide margin, on the
    configuration's matrix at a size a test run holds, on three seeds."""
    n, indptr, indices = data.structure(ROOT, CONFIGS[config], 1 / 256, cache=tmp_path)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        values, X = data.draw(seed, indices.shape[0], n, 8, torch.device("cpu"))
        arrays = (torch.from_numpy(indptr), torch.from_numpy(indices), values)
        Xs = X.T.contiguous()
        Y64, AX = REF.reference(*arrays, Xs)
        assert REF.rel_err(REF.control(*arrays, Xs), Y64, AX) > 10 * REF.MAX_REL_ERR


def test_block_split_gives_the_same_answer(monkeypatch):
    a = _random_csr(200, 200, 0.05, 5)
    arrays, X = _operands(a, 7, 6)
    whole = REF.reference(*arrays, X)
    monkeypatch.setattr(REF, "_BLOCK_ELEMS", arrays[1].numel() * 2)
    split = REF.reference(*arrays, X)
    for w, s in zip(whole, split):
        torch.testing.assert_close(w, s, rtol=0, atol=1e-13)

"""BENCHMARK.json against the benchmark's contract, and the harness finding a
configuration, traffic mix and metric by name alone."""
import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "bench"))

from benchkit import data, spec, traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_only_allowed_characters(name):
    assert spec.NAME.match(name), name
    assert name.isascii()


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.UNIT.match(metric["unit"]) and metric["unit"].isascii()
    assert metric["better"] in ("lower", "higher")
    e2e = metric in BENCH["end_to_end"]
    keys = METRIC_KEYS | ({"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    assert spec.reader_path(ROOT, metric["name"]).is_file()


def test_unique_names_and_files():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_the_contract_asks(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    c = spec.find_cell(ROOT, cell)
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m.moves in e2e for m in c.per_layer)
    assert c.config["name"] == w["config"]
    assert (ROOT / "bench" / "references" / f"{c.config['reference']}.py").is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("bench/") and (ROOT / config["file"]).is_file()
    assert isinstance(config["reduced"], list) and len(config["reduced"]) <= 16
    conf = spec.load_json(ROOT / config["file"])
    assert conf["name"] == config["name"]
    assert spec.generator_path(ROOT, conf["matrix"]["family"]).is_file()
    for text in (config["source"], config["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


TRIDIAG = """import numpy as np


def structure(row, scale, rng):
    n = max(int(row["n_rows"] * scale), 8)
    i = np.arange(n)
    return n, np.concatenate([i, i[1:], i[:-1]]), np.concatenate([i, i[1:] - 1, i[:-1] + 1])
"""


def new_cell(root: Path) -> None:
    """Write into a copy of the harness at ``root``: a matrix of a new
    family (``bench/generators/tridiag.py``), its configuration, a traffic
    mix of a new shape (on/off bursts behind a concurrency limit), a cell
    and a metric, as new files and new entries only."""
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    (root / "bench/generators/tridiag.py").write_text(TRIDIAG)
    (root / "bench/configs/tri.json").write_text(json.dumps({
        "name": "tri", "source": "x", "reference": "csr_spmv", "dtype": "float32",
        "matrix": {"idx": 99, "n_rows": 3000, "nnz": 8998, "family": "tridiag",
                   "band": 1, "max_row": 3},
        "scale": 1.0, "generator_seed": 0}))
    (root / "bench/traffic/pulse.json").write_text(json.dumps(
        {"rate_per_s": 400.0, "phases": [[0.05, 4.0], [0.15, 0.0]], "outstanding": 24,
         "pool": 8, "warm": [1, 4, 16, 64]}))
    (root / "bench/metrics/dispatches.py").write_text(
        "def read(ctx):\n    return ctx.dispatches\n")
    bench["configs"].append({"name": "tri", "source": "x", "file": "bench/configs/tri.json",
                             "reduced": ["n_rows"], "why": "x"})
    bench["workloads"].append({"name": "tri.pulse", "config": "tri", "traffic": "pulse",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "dispatches", "unit": "batch", "better": "lower",
                               "source": "program_counter", "layer": "engine",
                               "moves": "latency_p95_ms", "workloads": ["tri.pulse"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append("tri.pulse")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_by_name(tmp_path):
    """A cell, a configuration of a new matrix family, a traffic mix of a
    new shape and a metric, added as new files and new entries, are found
    by the harness with no edit of any file (a whole run of such a cell:
    ``test_bench_run.py``)."""
    new_cell(tmp_path)
    c = spec.find_cell(tmp_path, "tri.pulse")
    assert c.config["name"] == "tri" and c.traffic["phases"][0] == [0.05, 4.0]
    assert [m.name for m in c.per_layer] == ["engine_build_s", "dispatches"]
    assert {m.name for m in c.end_to_end} == {"latency_p50_ms", "latency_p95_ms",
                                               "setup_s"}
    n, indptr, indices = data.structure(tmp_path, c.config)
    assert n == 3000 and indices.shape[0] == 8998 and indptr[-1] == 8998
    sched = traffic.schedule(c.traffic, 5, 2.0)
    assert sched.timed and sched.outstanding == 24
    assert np.all(np.mod(sched.due_s, 0.2) < 0.05 + 1e-9)

    class Ctx:
        dispatches = 7

    assert spec.reader(tmp_path, "dispatches")(Ctx()) == 7
    assert spec.reference(tmp_path, c.config["reference"]).MAX_REL_ERR > 0
    assert math.isfinite(spec.reference(tmp_path, "csr_spmv").MAX_REL_ERR)


@pytest.mark.parametrize("metric", ["idle_share.stream", "kernel_roofline.batch64",
                                    "step_host_us.stream", "throughput"])
def test_a_split_metric_is_read_by_its_base_reader(metric):
    path = spec.reader_path(ROOT, metric)
    assert path.name == metric.partition(".")[0] + ".py" and path.is_file()

"""A whole run of a cell on the CPU, at a size a test run holds (the
harness's look for a card skipped): the result line, the comparison that
decides ``correct``, and the faults it has to catch; the import guard."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "bench"))

from benchkit import cell, guard, plant, spec  # noqa: E402
from test_bench_spec import new_cell  # noqa: E402

SCALE = 1 / 512
SEED = 2**31 + 3


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    from repro_torch.tune import plan

    monkeypatch.setattr(plan, "_default", None, raising=False)
    return tmp_path


def _run(name, tmp_path, trace=False, seconds=1.0, root=ROOT, scale=SCALE):
    c = spec.find_cell(root, name)
    out = cell.run(c, SEED, seconds, trace, "cpu", time.perf_counter(), scale=scale,
                   cache=tmp_path, samples=16)
    return c, out, cell.result(c, out, trace)


@pytest.mark.parametrize("name", ["ldoor.batch64", "ldoor.stream"])
def test_a_run_is_correct_and_reports_its_metrics(name, plan_cache):
    c, out, line = _run(name, plan_cache)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m.name for m in c.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
    assert line["checks"]["rel_err"]["value"] <= line["checks"]["rel_err"]["limit"]
    assert line["cold"] == {"structure_generated": True, "plans_searched": True}
    assert set(line["plans"]) == {"1", "4", "16", "64"}
    json.dumps(line)
    again = cell.result(c, cell.run(c, SEED + 1, 0.5, False, "cpu", time.perf_counter(),
                                    scale=SCALE, cache=plan_cache, samples=16), False)
    assert again["cold"] == {"structure_generated": False, "plans_searched": False}
    assert again["plans"] == line["plans"] and again["correct"] is True


def test_a_traced_run_reports_its_per_layer_metrics(plan_cache):
    c, out, line = _run("ldoor.stream", plan_cache, trace=True, seconds=2.0)
    assert line["correct"] is True
    host = {"engine_build_s", "step_host_us.stream", "batch_width.stream"}
    assert host <= set(line["metrics"]) <= {m.name for m in c.per_layer}
    # the CPU has no device trace: the device shares are left out, never 0
    assert "idle_share.stream" not in line["metrics"]
    assert "busy_s" in line["device"] and "breakdown" in line


@pytest.mark.parametrize("fault", ["control", "answer", "half_batch", "one_slot"])
def test_a_broken_timed_path_is_not_correct(fault, plan_cache):
    """The control (the reference one precision lower) and each fault,
    planted where the program produces each batch's answers, read
    ``correct`` false through the run's own check; one wrong slot of a
    64-wide batch is caught, since every slot is kept."""
    c = spec.find_cell(ROOT, "ldoor.batch64")
    with plant.planted(fault, spec.reference(ROOT, c.config["reference"])):
        _, out, line = _run("ldoor.batch64", plan_cache)
    assert line["correct"] is False
    assert line["checks"]["rel_err"]["value"] > 10 * line["checks"]["rel_err"]["limit"]


def test_a_cell_of_new_files_runs(tmp_path, plan_cache):
    """The cell that ``test_bench_spec.new_cell`` adds as new files only (a
    new matrix family, bursts behind a concurrency limit, a new metric)
    runs whole and is correct."""
    new_cell(tmp_path)
    c, out, line = _run("tri.pulse", plan_cache, trace=True, seconds=1.0, root=tmp_path,
                        scale=None)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"]["dispatches"]["value"] > 0
    assert set(line["plans"]) == {"1", "4", "16", "64"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "ldoor.batch64",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_harness_loads_no_jax():
    """Every module a run imports, the program's included, leaves ``jax``,
    ``jaxlib``, ``flax`` and ``repro`` unloaded, compared as whole names."""
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1] + '/bench']\n"
        "from pathlib import Path\n"
        "import run\n"
        "from benchkit import cell, guard, plant, spec\n"
        "from repro_torch.runtime.engine import SparseEngine\n"
        "from repro_torch.core.formats import CSRMatrix\n"
        "root = Path(sys.argv[1])\n"
        "for p in (root / 'bench' / 'metrics').glob('*.py'): spec.reader(root, p.stem)\n"
        "for p in (root / 'bench' / 'references').glob('*.py'): spec.reference(root, p.stem)\n"
        "for p in (root / 'bench' / 'generators').glob('*.py'): spec.generator(root, p.stem)\n"
        "print(json.dumps(guard.loaded_forbidden()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("reader_imports_jax", [False, True])
def test_jax_loaded_by_a_reader_withholds_the_result(reader_imports_jax, tmp_path):
    """``bench/run.py`` looks for JAX once every metric's reader has run:
    a reader that loads a module named ``jax`` leaves the run with no
    result and a non-zero exit.  (A stub stands in for JAX; the run skips
    the look for a card and runs small on the CPU.)"""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    if reader_imports_jax:
        reader = tmp_path / "bench" / "metrics" / "throughput.py"
        reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import run; "
            "sys.exit(run.main(sys.argv[2:], device='cpu', scale=1 / 512))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(tmp_path / "stub")]))
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path / "bench"), "--workload",
                        "ldoor.batch64", "--seed", str(SEED), "--seconds", "0.5",
                        "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    if reader_imports_jax:
        assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
        assert "['jax']" in p.stderr
    else:
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and "throughput" in line["metrics"]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden(["repro_torch.runtime.engine", "reprox", "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["jax.numpy", "repro.core.spmv", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_harness_file_imports_jax(path):
    assert not guard.top_level_imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert guard.top_level_imports(path) <= {"__future__", "torch", "numpy", "math"}

"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under ``bench/``:

    bench/configs/<config>.json     the configuration (sizes, source, reference)
    bench/generators/<family>.py    a matrix family's generator, ``structure``
    bench/traffic/<traffic>.json    the traffic mix's parameters
    bench/metrics/<metric>.py       the metric's reader, ``read(ctx)``; a
                                    metric ``<base>.<part>`` without a file
                                    of its own is read by ``<base>.py``
    bench/references/<name>.py      a configuration's plain reference

so a later cell, configuration, matrix family, mix or metric is new files
and new entries in ``BENCHMARK.json``, and no edit of a file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: str | None  # per-layer metrics only
    workloads: tuple[str, ...] | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]
    root: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(d: dict) -> Metric:
    w = d.get("workloads")
    return Metric(d["name"], d["unit"], d["better"], d["source"], d.get("moves"),
                  None if w is None else tuple(w))


def cell_metrics(bench: dict, cell: str) -> tuple[tuple[Metric, ...], tuple[Metric, ...]]:
    """The end-to-end and per-layer metrics one cell reports: those whose
    ``workloads`` name it, and those without the key that the cell reports
    by what they move."""
    e2e = tuple(m for m in map(_metric, bench["end_to_end"])
                if m.workloads is None or cell in m.workloads)
    names = {m.name for m in e2e}
    layer = tuple(m for m in map(_metric, bench["per_layer"])
                  if (cell in m.workloads if m.workloads is not None
                      else m.moves in names))
    return e2e, layer


def find_cell(root: Path, name: str) -> Cell:
    """The cell called ``name`` in ``root/BENCHMARK.json``, with its
    configuration and traffic read from their files."""
    bench = load_json(root / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    e2e, layer = cell_metrics(bench, name)
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer, root)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)


def reader_path(root: Path, metric: str) -> Path:
    """``bench/metrics/<metric>.py``, or for a metric split by the cells it
    is read in (``<base>.<part>``) with no file of its own, ``<base>.py``."""
    metrics = root / "bench" / "metrics"
    own = metrics / f"{metric}.py"
    return own if own.is_file() else metrics / f"{metric.partition('.')[0]}.py"


def reader(root: Path, metric: str):
    """``read(ctx) -> float | None`` of the metric's reader file."""
    path = reader_path(root, metric)
    return load_module(path, _module_name("metric", path.stem)).read


def generator_path(root: Path, family: str) -> Path:
    return root / "bench" / "generators" / f"{family}.py"


def generator(root: Path, family: str) -> ModuleType:
    """``bench/generators/<family>.py``: ``structure(row, scale, rng) ->
    (n, rows, cols)``."""
    return load_module(generator_path(root, family), _module_name("generator", family))


def reference(root: Path, name: str) -> ModuleType:
    return load_module(root / "bench" / "references" / f"{name}.py",
                       _module_name("reference", name))

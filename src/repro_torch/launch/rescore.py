"""Re-score the dry run's saved op traces (``.ops.json.gz``) without
re-tracing: the port's counterpart of the JAX package's ``launch.rescore``.

Each trace holds the cell's pieces (rows of op, input and output shapes
and dtypes, and calls) and its card classes (the pieces each uses, with
scales, and its collectives).  Re-scoring runs
``launch.op_analysis.op_cost`` over the rows again, so a refinement of the
analyzer's conventions reaches every saved cell, and rewrites
``per_device`` and ``mesh_totals`` in the cell's JSON.

``--debug CELL`` prints the top byte and flop contributors of the cell's
busiest card: (piece, op, input shapes) weighted by calls and scales.

Usage:
  python -m repro_torch.launch.rescore --dir experiments/dryrun_torch
  python -m repro_torch.launch.rescore --debug 'llama3-405b__train_4k__16x16__baseline'
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import Counter

from repro_torch.launch.dryrun import OUTDIR, Piece, per_device_of
from repro_torch.launch.op_analysis import op_cost

__all__ = ["load_trace", "rescore", "debug_cell", "main"]

SUFFIX = ".ops.json.gz"


def _key(row) -> tuple:
    op, ins, outs, _ = row
    return (op, tuple((tuple(s), d) for s, d in ins), tuple((tuple(s), d) for s, d in outs))


def load_trace(path: str) -> dict:
    """A saved trace as :func:`~repro_torch.launch.dryrun.card_costs`'
    ``{"pieces", "classes"}`` (pieces as :class:`Piece`)."""
    with gzip.open(path, "rt") as f:
        raw = json.load(f)
    pieces = {pid: Piece(Counter({_key(r): r[3] for r in p["rows"]}), p["peak_bytes"],
                         p["end_bytes"])
              for pid, p in raw["pieces"].items()}
    return {"pieces": pieces, "classes": raw["classes"]}


def rescore(dirname: str) -> None:
    for trace_path in sorted(glob.glob(os.path.join(dirname, "*" + SUFFIX))):
        json_path = trace_path[: -len(SUFFIX)] + ".json"
        if not os.path.exists(json_path):
            continue
        with open(json_path) as f:
            rec = json.load(f)
        per_device, memory, totals = per_device_of(load_trace(trace_path))
        rec["per_device"], rec["mesh_totals"] = per_device, totals
        with open(json_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[rescored] {os.path.basename(json_path)} "
              f"flops={per_device['flops']:.3e} hbm={per_device['hbm_bytes']:.3e} "
              f"coll={per_device['collective_bytes']:.3e}")


def debug_cell(dirname: str, cell: str, top: int = 25) -> None:
    """Print the busiest card's top contributors by bytes and by flops."""
    trace = load_trace(os.path.join(dirname, cell + SUFFIX))
    per_device, _, _ = per_device_of(trace)
    cls = next(c for c in trace["classes"] if per_device["card"] in c["cards"])
    rows = []
    for pid, scale in cls["uses"]:
        for (op, ins, outs), n in trace["pieces"][pid].rows.items():
            f, b, _ = op_cost(op, ins, outs)
            w = n * scale
            rows.append((b * w, f * w, w, pid, op, [list(s) for s, _ in ins]))
    for label, index in (("bytes", 0), ("flops", 1)):
        print(f"card {per_device['card']}: top {top} by {label}")
        print(f"{'weighted_bytes':>15s} {'weighted_flops':>15s} {'calls':>10s}  piece :: op")
        for b, f, w, pid, op, shapes in sorted(rows, key=lambda r: -r[index])[:top]:
            print(f"{b:15.3e} {f:15.3e} {w:10.0f}  {pid} :: {op} {str(shapes)[:60]}")
    for kind, v in cls["collectives"].items():
        print(f"collective {kind}: {v:.3e} B")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Re-score saved dry-run op traces")
    ap.add_argument("--dir", default=OUTDIR)
    ap.add_argument("--debug", default=None)
    args = ap.parse_args(argv)
    if args.debug:
        debug_cell(args.dir, args.debug)
    else:
        rescore(args.dir)


if __name__ == "__main__":
    main()

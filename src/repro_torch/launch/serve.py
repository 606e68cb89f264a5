"""Serving launcher: SpMV requests over a Table-1 suite matrix through the
batch-aggregating ``repro_torch.runtime.engine.SparseEngine``.

Pending requests are aggregated into k-bucketed SpMM batches (Fig 9's
amortization applied to serving), each bucket dispatching the plan
``repro_torch.tune`` measured for that width.  The first launch searches
every bucket; plans persist in the on-disk plan cache
(~/.cache/repro_torch_tune, override with $REPRO_TORCH_TUNE_CACHE), so a
restarted engine reloads the whole k-indexed plan table:

  PYTHONPATH=src python -m repro_torch.launch.serve --sparse cant \\
      --scale 1.0 --requests 64 --k-buckets 1,4,16,64 [--max-wait-ms 5]

``--device`` is ``cuda`` (the default) or ``cpu``; ``--stats-json PATH``
dumps ``EngineStats.summary()`` plus throughput as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def serve_sparse(args) -> None:
    from repro_torch.data.suite import SUITE, generate
    from repro_torch.runtime.engine import SparseEngine

    names = [s.name for s in SUITE]
    if args.sparse not in names:
        raise SystemExit(
            f"unknown suite matrix {args.sparse!r}; choose from: {', '.join(names)}"
        )
    ks = tuple(int(k) for k in args.k_buckets.split(","))
    a = generate(args.sparse, scale=args.scale)
    max_wait_s = args.max_wait_ms / 1e3 if args.max_wait_ms else None
    t0 = time.perf_counter()
    eng = SparseEngine(a, ks=ks, max_wait_s=max_wait_s,
                       async_depth=args.async_depth, device=args.device)
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    xs = [
        torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32),
                        device=eng.device)
        for _ in range(args.requests)
    ]
    eng.run(xs[: min(len(xs), max(ks))])  # first calls outside the timed window
    eng.stats = type(eng.stats)()  # measure the steady state only

    t0 = time.perf_counter()
    reqs = [eng.submit(x) for x in xs]  # offered load: all pending at once
    if max_wait_s is None:
        eng.drain()
    else:
        # Full buckets dispatch at once; the partial tail waits out its SLO.
        while eng.pending:
            if eng.step() == 0:
                time.sleep(min(max_wait_s / 4, 1e-3))
        eng.flush()
    dt = time.perf_counter() - t0
    served = [r for r in reqs if not r.failed]
    flops = 2 * a.nnz * len(served)
    s = eng.stats.summary()
    plans = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    src = ("k-indexed plan table from cache" if eng.from_cache
           else f"searched in {t_build:.1f}s")
    lat = sorted(r.latency_s for r in served) or [0.0]
    raced = sum(op.plan.n_raced for op in eng.ops.values())
    print(
        f"served {len(served)}/{len(xs)} spmv requests on "
        f"{args.sparse}@{args.scale:g} "
        f"({a.shape[0]}x{a.shape[1]}, nnz={a.nnz}) in {dt:.3f}s "
        f"({len(served) / dt:.1f} req/s, {flops / dt / 1e9:.2f} GF/s, "
        f"async_depth={eng.async_depth}, device={eng.device})\n"
        f"  dispatches={s['dispatches']} by_bucket={s['by_bucket']} "
        f"occupancy={s['occupancy']:.2f} "
        f"(padding {s['padded_occupancy']:.2f} — not served work) "
        f"latency mean/p50/p99 = {s['latency_mean_ms']:.2f}/"
        f"{lat[len(lat) // 2] * 1e3:.2f}/{s['latency_p99_ms']:.2f} ms\n"
        f"  plans={plans}\n"
        f"  ({src}; {raced} candidates pruned by racing)"
    )
    if args.stats_json:
        p = Path(args.stats_json)
        if p.parent != Path("."):
            p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(
            {
                "mode": "sparse",
                "matrix": args.sparse,
                "scale": args.scale,
                "device": str(eng.device),
                "requests": len(xs),
                "served": len(served),
                "elapsed_s": round(dt, 6),
                "req_per_s": round(len(served) / dt, 3),
                "gflops": round(flops / dt / 1e9, 4),
                "plans": plans,
                "engine": s,
            },
            indent=1, sort_keys=True,
        ) + "\n")
        print(f"  stats written to {p}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sparse", required=True, metavar="MATRIX",
                    help="serve autotuned SpMV over this suite matrix")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine serves (the CPU runs the kernels' "
                         "plain torch versions)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the run's stats summary as JSON")
    ap.add_argument("--scale", type=float, default=1 / 64,
                    help="suite matrix scale (1.0 = the paper's Table 1 size)")
    ap.add_argument("--k-buckets", default="1,4,16,64",
                    help="tuned batch widths for the sparse engine")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="admission control: dispatch a partial bucket once "
                         "its oldest request has waited this long "
                         "(0 = dispatch immediately)")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="in-flight dispatch window (0 = fully synchronous; "
                         "2 = batch t+1 is enqueued while batch t computes)")
    ap.add_argument("--requests", type=int, default=8)
    serve_sparse(ap.parse_args(argv))


if __name__ == "__main__":
    main()

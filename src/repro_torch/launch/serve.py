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
dumps ``EngineStats.summary()`` (with the failure and overload counters),
the supervisor's summary and throughput as JSON.

Overload protection: ``--max-queue N`` bounds the queue with
``--overload-policy reject|shed-oldest|block``; ``--shed-after-ms`` fails
requests still queued after that long; ``--brownout`` arms a
``BrownoutController`` (widest-bucket dispatch under pressure, refusals
when shedding):

  PYTHONPATH=src python -m repro_torch.launch.serve --sparse cant \
      --scale 1.0 --requests 256 --max-queue 64 \
      --overload-policy shed-oldest --brownout

Row-partitioned serving: ``--shards P`` splits A into P nnz-balanced row
shards served in one stacked pass on the device; ``--mesh-shards P``
serves over a mesh of P shards (``launch.mesh.make_spmm_mesh``: round-robin
over the visible cards, so on one card all P share it) with a collective
schedule (allgather or ring) tuned per bucket.  The two are one of two;
the report names the path and the distinct devices the shards span:

  PYTHONPATH=src python -m repro_torch.launch.serve --sparse cant \
      --scale 1.0 --requests 64 --mesh-shards 4 [--device cpu]

Several matrices at once: ``--fleet M1,M2,...`` serves each as a
``repro_torch.runtime.fleet.SparseFleet`` tenant, admitted on predicted
plans (plan cache, nearest cached neighbour, byte model) with no measured
search, interleaving their requests; the background retune runs the
search and hot-swaps the measured plans, and the report waits up to
``--retune-wait-s`` for it:

  PYTHONPATH=src python -m repro_torch.launch.serve --fleet cant,webbase-1M \\
      --scale 1.0 --requests 64 --stats-json fleet.json

A language model: ``--arch`` serves ``--requests`` greedy requests of
``--prompt-len`` random tokens (``default_rng(0)``) and ``--max-new`` new
tokens each through ``repro_torch.runtime.server.BatchedServer`` with
``--slots`` decode slots, over the registered configuration at full width
or ``--reduced``, with weights drawn from seed 0.  The architectures are
``repro_torch.configs.ARCH_IDS``: qwen1.5-4b, h2o-danube-3-4b,
deepseek-67b and llama3-405b (dense), granite-moe-1b-a400m and
llama4-scout-17b-a16e (MoE), rwkv6-7b (RWKV-6), zamba2-2.7b (hybrid:
Mamba-2 and a shared attention block), whisper-tiny (audio: each request
carries seeded frame embeddings) and qwen2-vl-72b (VLM: each request's
prompt holds ``n_vision_tokens`` vision slots, whose seeded embeddings it
carries, before its ``--prompt-len`` text tokens, with M-RoPE positions in
Qwen2-VL's layout; ``repro_torch.data.modality``).  deepseek-67b,
llama3-405b and qwen2-vl-72b fit one card only ``--reduced``.
On a card the decode
step and each prompt length's prefill run as CUDA graphs; the report and
``--stats-json`` give the graphs captured and the seconds spent capturing:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --reduced --device cpu --requests 8 --slots 4

Exactly one of ``--sparse``, ``--fleet`` and ``--arch`` is required.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def _overload_kwargs(args) -> dict:
    """The overload flags as SparseEngine keyword arguments."""
    from repro_torch.runtime.overload import BrownoutController

    kw: dict = {}
    if args.max_queue > 0:
        kw["max_queue"] = args.max_queue
        kw["overload_policy"] = args.overload_policy
    if args.shed_after_ms > 0:
        kw["shed_after_s"] = args.shed_after_ms / 1e3
    if args.brownout:
        kw["brownout"] = BrownoutController()
    return kw


def offer(eng, xs, max_wait_s: float | None = None) -> tuple[list, int, float]:
    """Offer every request of ``xs`` to ``eng`` at once and serve them all;
    returns ``(requests, refused, seconds)``.  With ``max_wait_s`` full
    buckets dispatch at once and the partial tail waits out its SLO."""
    from repro_torch.runtime.engine import OverloadError

    t0 = time.perf_counter()
    reqs, refused = [], 0
    for x in xs:  # offered load: all pending at once
        try:
            reqs.append(eng.submit(x))
        except OverloadError:
            refused += 1  # a typed refusal: an open-loop caller backs off
    if max_wait_s is None:
        eng.drain()
    else:
        while eng.pending:
            if eng.step() == 0:
                time.sleep(min(max_wait_s / 4, 1e-3))
        eng.flush()
    return reqs, refused, time.perf_counter() - t0


def serve_sparse(args) -> None:
    from repro_torch.data.suite import SUITE, generate
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.runtime.engine import SparseEngine

    names = [s.name for s in SUITE]
    if args.sparse not in names:
        raise SystemExit(
            f"unknown suite matrix {args.sparse!r}; choose from: {', '.join(names)}"
        )
    if args.shards > 1 and args.mesh_shards > 1:
        raise SystemExit("--shards and --mesh-shards are mutually exclusive "
                         "(stacked shards on one device vs a device mesh)")
    ks = tuple(int(k) for k in args.k_buckets.split(","))
    a = generate(args.sparse, scale=args.scale)
    max_wait_s = args.max_wait_ms / 1e3 if args.max_wait_ms else None
    if args.mesh_shards > 1:
        mesh = make_spmm_mesh(args.mesh_shards, device=args.device)
        # both engines below share the placed operands and the plan cache
        topo: dict = {"mesh": mesh, "prep_cache": {}}
    else:
        mesh = None
        topo = {"n_shards": args.shards, "device": args.device}
    t0 = time.perf_counter()
    warm = SparseEngine(a, ks=ks, max_wait_s=max_wait_s,
                        async_depth=args.async_depth, **topo)
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    xs = [
        torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32),
                        device=warm.device)
        for _ in range(args.requests)
    ]
    # First calls outside the timed window, on an engine of the same plans
    # without overload protection: the warm-up burst is not offered load.
    warm.run(xs[: min(len(xs), max(ks))])
    warm.close()
    # Mesh and shard engines take no ops= table: a mesh engine reloads its
    # plans from the cache (no search) onto the shared operands.
    eng = SparseEngine(a, ks=ks, max_wait_s=max_wait_s, async_depth=args.async_depth,
                       **(topo if mesh is not None or args.shards > 1
                          else {"ops": warm.ops, "device": args.device}),
                       **_overload_kwargs(args))
    if mesh is None and args.shards <= 1:
        # the warm engine's closures, whose CUDA graphs it captured on a
        # card: the timed window captures nothing
        eng.hot_swap(warm.ops, execs=warm._execs)

    reqs, refused, dt = offer(eng, xs, max_wait_s)
    served = [r for r in reqs if not r.failed]
    shed = len(reqs) - len(served)
    flops = 2 * a.nnz * len(served)
    s = eng.stats.summary()
    plans = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    n_devices = mesh.n_devices if mesh is not None else 1
    if mesh is not None:
        hit = ("plan table from cache" if warm.from_cache
               else f"schedules searched in {t_build:.1f}s")
        src = (f"mesh-sharded over {args.mesh_shards} shards on {n_devices} "
               f"distinct device(s) (collective schedules per bucket; {hit})")
    elif args.shards > 1:
        src = (f"row-partitioned stacked dispatch over {args.shards} shards on "
               f"1 device")
    elif warm.from_cache:
        src = "k-indexed plan table from cache"
    else:
        src = f"searched in {t_build:.1f}s"
    lat = sorted(r.latency_s for r in served) or [0.0]
    raced = sum(op.plan.n_raced for op in eng.ops.values())
    overload = f" [overload: refused={refused} shed={shed}]" if refused or shed else ""
    print(
        f"served {len(served)}/{len(xs)} spmv requests on "
        f"{args.sparse}@{args.scale:g} "
        f"({a.shape[0]}x{a.shape[1]}, nnz={a.nnz}) in {dt:.3f}s "
        f"({len(served) / dt:.1f} req/s, {flops / dt / 1e9:.2f} GF/s, "
        f"async_depth={eng.async_depth}, device={eng.device}){overload}\n"
        f"  dispatches={s['dispatches']} by_bucket={s['by_bucket']} "
        f"occupancy={s['occupancy']:.2f} "
        f"(padding {s['padded_occupancy']:.2f} — not served work) "
        f"latency mean/p50/p99 = {float(np.mean(lat)) * 1e3:.2f}/"
        f"{lat[len(lat) // 2] * 1e3:.2f}/{float(np.quantile(lat, 0.99)) * 1e3:.2f} ms\n"
        f"  plans={plans}\n"
        f"  ({src}; {raced} candidates pruned by racing)\n"
        f"  counters: rejected={s['rejected']} shed_oldest={s['shed_oldest']} "
        f"shed_deadline={s['shed_deadline']} failed={s['failed_requests']} "
        f"retries={s['retries']} demotions={s['demotions']} "
        f"promotions={s['promotions']}"
        + (f" brownout={eng.brownout.summary()}" if eng.brownout else "")
    )
    if args.stats_json:
        _dump_stats(
            args.stats_json,
            {
                "mode": "sparse",
                "matrix": args.sparse,
                "scale": args.scale,
                "device": str(eng.device),
                "shards": eng.n_shards,
                "mesh": mesh is not None,
                "n_devices": n_devices,
                "requests": len(xs),
                "served": len(served),
                "refused": refused,
                "elapsed_s": round(dt, 6),
                "req_per_s": round(len(served) / dt, 3),
                "gflops": round(flops / dt / 1e9, 4),
                "plans": plans,
                "engine": s,
                "supervisor": eng.supervisor.summary(),
                "brownout": eng.brownout.summary() if eng.brownout else None,
            },
        )


def _dump_stats(path: str, payload: dict) -> None:
    p = Path(path)
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    print(f"  stats written to {p}")


def serve_fleet(args) -> None:
    from repro_torch.data.suite import SUITE, generate
    from repro_torch.runtime.fleet import SparseFleet
    from repro_torch.runtime.overload import OverloadError

    names = [s.name for s in SUITE]
    tenants = [t for t in args.fleet.split(",") if t]
    for t in tenants:
        if t not in names:
            raise SystemExit(
                f"unknown suite matrix {t!r}; choose from: {', '.join(names)}"
            )
    ks = tuple(int(k) for k in args.k_buckets.split(","))
    max_wait_s = args.max_wait_ms / 1e3 if args.max_wait_ms else None
    fleet = SparseFleet(ks=ks, max_wait_s=max_wait_s, async_depth=args.async_depth,
                        device=args.device, **_overload_kwargs(args))
    rng = np.random.default_rng(0)
    mats = {}
    t0 = time.perf_counter()
    for t in tenants:
        mats[t] = generate(t, scale=args.scale)
        fleet.add_tenant(t, mats[t])
    t_admit = time.perf_counter() - t0
    xs = {
        t: [torch.as_tensor(rng.standard_normal(mats[t].shape[1]).astype(np.float32),
                            device=fleet.device)
            for _ in range(args.requests)]
        for t in tenants
    }
    t0 = time.perf_counter()
    reqs, refused = [], 0
    for i in range(args.requests):  # interleaved tenants: a shared device
        for t in tenants:
            try:
                reqs.append(fleet.submit(t, xs[t][i]))
            except OverloadError:
                refused += 1  # a typed refusal: the caller backs off
                fleet.step()  # ...and a batch drains before the next offer
    # ``done`` (a result or an exception): a shed future never gets a result.
    while not all(r.done for r in reqs):
        if fleet.step() == 0:
            fleet.flush()
            if max_wait_s:
                time.sleep(min(max_wait_s / 4, 1e-3))
    fleet.flush()
    dt = time.perf_counter() - t0
    fleet.wait_retunes(timeout=args.retune_wait_s)
    fleet.close()
    summary = fleet.stats().summary()
    served = sum(1 for r in reqs if not r.failed)
    total = len(reqs)
    overload = (f" [overload: refused={refused} shed={total - served}]"
                if refused or served < total else "")
    card = (torch.cuda.get_device_name(fleet.device)
            if fleet.device.type == "cuda" else None)
    print(
        f"fleet served {served}/{total + refused} requests over {len(tenants)} "
        f"tenants ({', '.join(tenants)}) in {dt:.3f}s ({served / dt:.1f} req/s, "
        f"device={fleet.device}{f' {card}' if card else ''}){overload}; admitted in "
        f"{t_admit:.3f}s (cache={summary['cache_admissions']} "
        f"predicted={summary['predicted_admissions']}; "
        f"transferred_buckets={summary['transferred_buckets']} "
        f"byte_model_buckets={summary['byte_model_buckets']})\n"
        f"  retunes done={summary['retunes_done']} failed={summary['retunes_failed']} "
        f"swaps_applied={summary['swaps_applied']}; resident "
        f"{summary['resident_bytes']}/{summary['budget_bytes']} B, "
        f"evictions={summary['evictions']}"
    )
    if args.stats_json:
        _dump_stats(args.stats_json, {
            "mode": "fleet",
            "tenants": tenants,
            "scale": args.scale,
            "device": str(fleet.device),
            "card": card,
            "requests": total,
            "served": served,
            "refused": refused,
            "elapsed_s": round(dt, 6),
            "req_per_s": round(served / dt, 3),
            "admit_s": round(t_admit, 6),
            "fleet": summary,
        })


def serve_lm(args) -> dict:
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.modality import request_inputs
    from repro_torch.models.lm import init_model
    from repro_torch.runtime.server import BatchedServer, Request

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = init_model(cfg, 0, device=args.device)
    srv = BatchedServer(cfg, model, batch_slots=args.slots, max_seq=args.max_seq)
    rng = np.random.default_rng(0)
    n = args.prompt_len + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=args.max_new,
                            **request_inputs(cfg, n, rng)))
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    srv.run_until_drained()
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    lats = sorted(r.latency_s for r in reqs if r.done)
    p50 = lats[len(lats) // 2] if lats else None
    p99 = lats[int(len(lats) * 0.99)] if lats else None
    lat_txt = f", request latency p50 {p50:.2f}s p99 {p99:.2f}s" if lats else ""
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {srv.steps} decode steps, "
          f"{srv.prefills} prefills, "
          f"batch occupancy {srv.occupancy * args.slots:.2f}/{args.slots}"
          f"{lat_txt}; {srv.graphs} CUDA graphs captured in {srv.capture_s:.2f}s)")
    summary = {
        "arch": cfg.arch_id, "device": str(srv.device), "requests": len(reqs),
        "served": done, "tokens": toks, "elapsed_s": dt, "tok_per_s": toks / dt,
        "decode_steps": srv.steps, "prefills": srv.prefills,
        "occupancy": srv.occupancy, "latency_p50_s": p50, "latency_p99_s": p99,
        # CUDA graphs (decode + one prefill per prompt length) and the
        # seconds their warm-ups and captures took, inside elapsed_s but the
        # decode graph's, which the server captured when it was built
        "graphs": srv.graphs, "capture_s": srv.capture_s,
    }
    if args.stats_json:
        _dump_stats(args.stats_json, summary)
    return summary


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--arch", choices=ARCH_IDS, default=None,
                      help="serve greedy LM requests over this architecture")
    mode.add_argument("--sparse", default=None, metavar="MATRIX",
                      help="serve autotuned SpMV over this suite matrix")
    mode.add_argument("--fleet", default=None, metavar="M1,M2,...",
                      help="serve several suite matrices as SparseFleet tenants "
                           "(transfer-tuned admission + background retune)")
    ap.add_argument("--retune-wait-s", type=float, default=60.0,
                    help="--fleet: how long to wait for background retunes "
                         "before reporting (0 = don't wait)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine serves (the CPU runs the kernels' "
                         "plain torch versions)")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the run's stats summary as JSON")
    ap.add_argument("--scale", type=float, default=1 / 64,
                    help="suite matrix scale (1.0 = the paper's Table 1 size)")
    ap.add_argument("--k-buckets", default="1,4,16,64",
                    help="tuned batch widths for the sparse engine")
    ap.add_argument("--shards", type=int, default=1,
                    help="--sparse: row-partition the matrix into this many "
                         "shards, served in one stacked pass on the device")
    ap.add_argument("--mesh-shards", type=int, default=1,
                    help="--sparse: serve over a mesh of this many shards "
                         "(round-robin over the visible cards) with a "
                         "collective schedule (allgather/ring) tuned per "
                         "bucket; excludes --shards")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="admission control: dispatch a partial bucket once "
                         "its oldest request has waited this long "
                         "(0 = dispatch immediately)")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="in-flight dispatch window (0 = fully synchronous; "
                         "2 = batch t+1 is enqueued while batch t computes)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission: cap the pending queue at this "
                         "many requests (0 = unbounded)")
    ap.add_argument("--overload-policy", default="reject",
                    choices=("reject", "shed-oldest", "block"),
                    help="what submit() does at a full queue: reject fast "
                         "with a typed OverloadError, evict the oldest "
                         "queued request, or block (bounded) for space")
    ap.add_argument("--shed-after-ms", type=float, default=0.0,
                    help="deadline shedding: fail queued requests "
                         "(DeadlineExceededError) once they have waited this "
                         "long at a dispatch boundary (0 = never shed)")
    ap.add_argument("--brownout", action="store_true",
                    help="arm a BrownoutController (default watermarks): "
                         "under pressure dispatch pins to the widest bucket "
                         "and repair pauses; when shedding, submit refuses")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="--arch: the reduced configuration (a few narrow layers)")
    ap.add_argument("--slots", type=int, default=4, help="--arch: decode slots")
    ap.add_argument("--prompt-len", type=int, default=4,
                    help="--arch: prompt tokens (a VLM's text tokens, after its "
                         "vision slots)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    args = ap.parse_args(argv)
    if args.fleet is not None:
        serve_fleet(args)
    elif args.arch is not None:
        serve_lm(args)
    else:
        serve_sparse(args)


if __name__ == "__main__":
    main()

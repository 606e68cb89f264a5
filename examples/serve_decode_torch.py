"""Batch-aggregating serving on the PyTorch/CUDA port: the Fig 9
SpMV->SpMM move, twice.

The paper's framing: one request is SpMV (k=1, memory-bound); aggregating
requests into one dispatch is SpMM (k>1), amortizing the matrix/weight
streams.  This example shows the identical lever at both layers of the
serving stack:

1. ``SparseEngine`` — raw SpMV requests aggregated into k-bucketed SpMM
   batches, each bucket running the plan ``repro_torch.tune`` measured for
   that width.
2. ``BatchedServer`` — LM decode with continuous batching: prompts prefill
   into freed slots (one ``prefill`` pass each) while other slots keep
   decoding; tokens/s rises with slot occupancy.  On a card its decode
   step and each prompt length's prefill replay as CUDA graphs.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.data.suite import generate
from repro_torch.models.lm import ModelConfig, init_model
from repro_torch.runtime.engine import SparseEngine
from repro_torch.runtime.server import BatchedServer, Request
from repro_torch.tune import PlanCache

# The demo LM: 4 layers at d 256, float32.
DEMO_DIMS = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                 vocab=2048)
SLOTS = (1, 4, 8)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spmv_engine_demo(device) -> dict:
    a = generate("cant", scale=1 / 128)
    eng = SparseEngine(a, ks=(1, 4, 16), cache=PlanCache(), warmup=0, timed=2,
                       device=device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32),
                          device=device) for _ in range(32)]
    eng.run(xs[:16])  # capture each bucket outside the measured window
    eng.stats = type(eng.stats)()

    # Sequential k=1 baseline vs offered-load-32 aggregation.
    t0 = time.perf_counter()
    for x in xs:
        y = eng.ops[1] @ x
    _sync(y.device)
    t_seq = time.perf_counter() - t0

    t0 = time.perf_counter()
    reqs = [eng.submit(x) for x in xs]
    eng.drain()
    t_eng = time.perf_counter() - t0

    s = eng.stats.summary()
    p99_ms = float(np.quantile([r.latency_s for r in reqs], 0.99)) * 1e3
    print(f"SparseEngine on cant ({a.shape[0]}x{a.shape[1]}, nnz={a.nnz}):")
    print(f"  sequential k=1 : {len(xs) / t_seq:7.1f} req/s")
    print(f"  engine (load 32): {len(xs) / t_eng:7.1f} req/s  "
          f"dispatches={s['dispatches']} by_bucket={s['by_bucket']} "
          f"occupancy={s['occupancy']:.2f} "
          f"latency p99={p99_ms:.1f} ms")
    out = {"a": a, "xs": xs, "ys": [r.result() for r in reqs], "summary": s,
           "events": [e.kind for e in eng.supervisor.events],
           "seq_req_per_s": len(xs) / t_seq, "engine_req_per_s": len(xs) / t_eng}
    eng.close()
    return out


def lm_server_demo(batch_slots: int, n_requests: int, cfg, model, device):
    srv = BatchedServer(cfg, model, batch_slots=batch_slots, max_seq=128)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(np.int32),
                    max_new=16) for i in range(n_requests)]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    _sync(device)
    dt = time.perf_counter() - t0
    toks = n_requests * 16
    lats = sorted(r.latency_s for r in done)
    return toks / dt, srv, lats, [list(r.out) for r in reqs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    out = {"engine": spmv_engine_demo(device)}

    cfg = ModelConfig(arch_id="serve-demo", family="dense", dtype=torch.float32,
                      remat="none", attn_chunk=64, **DEMO_DIMS)
    model = init_model(cfg, 0, device=device)
    print("\nBatchedServer (LM decode, continuous batching):")
    out["lm"] = {}
    for slots in SLOTS:
        tps, srv, lats, tokens = lm_server_demo(slots, 8, cfg, model, device)
        print(f"  batch={slots}: {tps:7.1f} tok/s  ({srv.steps} decode steps, "
              f"{srv.prefills} prefills, occupancy {srv.occupancy:.2f}, "
              f"latency p50 {lats[len(lats) // 2]:.2f}s)")
        out["lm"][slots] = {"tok_per_s": tps, "steps": srv.steps,
                            "prefills": srv.prefills, "graphs": srv.graphs,
                            "occupancy": srv.occupancy, "tokens": tokens}
        del srv
    print("\nbatching amortizes weight reads over requests — the serving "
          "version of the paper's SpMV->SpMM k-amortization (Fig 9).")
    out.update(cfg=cfg, model=model)
    return out


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in ten lines of
public API.

Build a matrix from the (synthesized) UFL suite, inspect its UCLD, reorder
with RCM, pack into SELL / BCSR, and multiply — SpMV (k=1) and SpMM (k=16)
— through both the plain torch tier and the hand-written CUDA kernels
(their plain torch versions when ``--device cpu``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    bcsr_from_csr,
    matrix_bandwidth,
    rcm,
    sell_from_csr,
    spmm_csr,
    spmv_csr,
    ucld,
    utd,
)
from repro_torch.data.suite import generate
from repro_torch.kernels import ops as kops
from repro_torch.runtime.engine import SparseEngine
from repro_torch.tune import PlanCache, SparseOperator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = {}

    # 1. a Table-1 matrix (pattern-faithful synthesis of `cant`)
    a = generate("cant", scale=1 / 64)
    m, n = a.shape
    dev = a.device(args.device)  # the CSR dict on the card; raises without one
    device = dev["data"].device
    out.update(a=a, ucld=ucld(a), utd=utd(a), bandwidth=matrix_bandwidth(a))
    print(f"cant @1/64: {m}x{n}, nnz={a.nnz}, nnz/row={a.nnz/m:.1f}")
    print(f"  UCLD={out['ucld']:.3f}  UTD(8x128)={out['utd']:.4f}  "
          f"bandwidth={out['bandwidth']}")

    # 2. RCM reordering (paper §4.4)
    perm = rcm(a)
    ar = a.permuted(perm)
    out.update(rcm=perm, ucld_rcm=ucld(ar), bandwidth_rcm=matrix_bandwidth(ar))
    print(f"  after RCM: UCLD={out['ucld_rcm']:.3f} "
          f"bandwidth={out['bandwidth_rcm']}")

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    X = torch.as_tensor(rng.standard_normal((n, 16)).astype(np.float32), device=device)

    # 3. SpMV / SpMM on the plain torch tier
    y = spmv_csr(dev, x, n_rows=m)
    Y = spmm_csr(dev, X, n_rows=m)
    print(f"  SpMV |y|={float(torch.linalg.norm(y)):.3f}   "
          f"SpMM |Y|={float(torch.linalg.norm(Y)):.3f}")

    # 4. the hand-written kernels (SELL-C-sigma SpMV, BCSR SpMM); the BCSR
    #    kernel picks its own tiles, so there is no n_tile to pass
    sell = kops.sell_prepare(sell_from_csr(a, C=8, sigma=64, width_align=8),
                             device=device)
    y_k = kops.sell_spmv(sell, x)
    bcsr = kops.bcsr_prepare(bcsr_from_csr(a, (8, 16)), device)
    Y_k = kops.bcsr_spmm(bcsr, X)
    print(f"  kernels agree: SpMV {torch.allclose(y, y_k, atol=1e-3)}, "
          f"SpMM {torch.allclose(Y, Y_k, atol=1e-3)}")
    out.update(x=x, X=X, y=y, Y=Y, y_k=y_k, Y_k=Y_k, sell=sell, bcsr=bcsr)

    # 5. the autotuned facade: per-matrix kernel selection + plan cache
    cache = PlanCache()
    op = SparseOperator.build(a, cache=cache, warmup=1, timed=3, device=device)
    y_t = op @ x
    op2 = SparseOperator.build(a, cache=cache, device=device)  # same structure -> cache hit
    print(f"  autotuned plan: {op.plan.candidate.key()} "
          f"(timed {op.plan.n_measured}/{op.plan.n_candidates} candidates, "
          f"rebuild from cache: {op2.from_cache}); "
          f"agrees {torch.allclose(y, y_t, atol=1e-3)}")
    out.update(y_t=y_t, plan=op.plan.candidate.key(), from_cache=op2.from_cache)

    # 6. the serving engine: pending SpMV requests aggregate into k-bucketed
    #    SpMM batches, each bucket running its own tuned plan (Fig 9 as a
    #    runtime decision)
    eng = SparseEngine(a, ks=(1, 4, 16), cache=cache, warmup=1, timed=3,
                       device=device)
    xs = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
    reqs = [eng.submit(xi) for xi in xs]
    eng.drain()
    s = eng.stats.summary()
    print(f"  engine served {s['requests']} requests in {s['dispatches']} "
          f"dispatch(es) {s['by_bucket']} at occupancy {s['occupancy']:.2f}; "
          f"request 0 latency {reqs[0].latency_s * 1e3:.1f} ms")
    out.update(engine_xs=xs, engine_ys=[r.result() for r in reqs], engine=s,
               engine_events=[e.kind for e in eng.supervisor.events],
               engine_plans={k: o.plan.candidate.key() for k, o in eng.ops.items()})
    eng.close()
    return out


if __name__ == "__main__":
    main()

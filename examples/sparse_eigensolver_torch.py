"""The paper's motivating application (§5 cites LOBPCG eigensolvers), on the
PyTorch/CUDA port: a block power iteration computing the top-k eigenpairs
of a suite matrix with SpMM as the inner kernel — exactly why SpMM
throughput matters.

Runs on the solver runtime (`runtime.solver.SparseSolver`): the iteration —
SpMM through the autotuned k-wide plan, Rayleigh quotients, QR
re-orthogonalization, convergence test — runs on the device in blocks of
iterations (CUDA graphs on a card); the host reads only the convergence
flag between blocks, and the final eigenvalue estimates.

The mid-iteration eigenvalue estimates are the Rayleigh quotients
``diag(V^T A V)`` — for orthonormal V these are the Ritz values.  (The
diagonal of QR's R factor is NOT an eigenvalue estimate: its entries are
column norms up to sign, so printing ``R[0, 0]`` can show a sign-flipped
or permuted value even at convergence.)

Uses the symmetrized `2cubes_sphere` stand-in and k=8 simultaneous vectors;
validates the dominant eigenvalues against numpy on the densified matrix.

Run:  PYTHONPATH=src python examples/sparse_eigensolver_torch.py [--smoke] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import csr_to_dense, symmetrize
from repro_torch.data.suite import generate
from repro_torch.runtime.solver import SparseSolver


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="a quarter-size matrix, short search")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    smoke = args.smoke
    a = symmetrize(generate("2cubes_sphere", scale=1 / 256 if smoke else 1 / 128))
    k = 8

    solver = SparseSolver(a, device=args.device,
                          **({"warmup": 0, "timed": 1} if smoke else {}))
    res = solver.block_power(k, tol=1e-4, maxiter=60, seed=0)
    print(f"plan: {res.plan}  ({'cache' if solver.from_cache else 'search'})")
    print(
        f"{res.iterations} iterations in blocks on the device, {res.syncs} host "
        f"reads; converged={res.converged} (last rel change {res.residual:.2e})"
    )

    # Rayleigh quotients diag(V^T A V) — the Ritz values for orthonormal V.
    ritz = np.sort(np.abs(res.eigenvalues))[::-1]
    dense = csr_to_dense(a)
    true = np.sort(np.abs(np.linalg.eigvalsh(dense)))[::-1][:k]
    print("block-power |eig|:", np.round(ritz[:3], 4))
    print("numpy       |eig|:", np.round(true[:3], 4))
    err = abs(ritz[0] - true[0]) / true[0]
    print(f"dominant eigenvalue rel-err: {err:.2%}")
    assert err < 0.05
    return {"a": a, "solver": solver, "result": res, "ritz": ritz, "true": true,
            "rel_err": err, "plan": res.plan}


if __name__ == "__main__":
    main()

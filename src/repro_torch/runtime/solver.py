"""Iterative solvers over tuned plans: CG, Lanczos and block power, with
convergence decided on the device.

The paper motivates SpMV throughput by linear solvers and eigensolvers:
workloads that run the product hundreds of times, with the operand made
and used on the device between iterations.  A loop that reads the
convergence test back every iteration pays a host round trip (a device
synchronisation) per product.  This module keeps the loop's decision on
the device:

* One *solver step* (the product through the width's tuned plan, plus the
  axpys and dot reductions around it) is a function of device tensors.
  The plans are tuned at the step level (``SparseOperator.build(
  solver_step=True)``, kind ``"solver_step"``): the search times
  ``tune.operator.solver_step_probe`` under the fused byte model.
* CG and block power run in blocks of iterations enqueued on the current
  stream, the blocks growing 1, 2, 4, ... up to ``block``: a solve that
  converges in a few iterations masks out few, and a long one reads the
  card once every ``block`` iterations, where a host loop reads it every
  iteration.  Before each step the device computes the loop's condition
  (``rs > thresh2``; for block power ``diff > tol``; the host never
  enqueues more than ``maxiter`` steps); after it, every state tensor is
  selected by ``torch.where(active, new, old)`` and the counter adds
  ``active``.  The host reads one flag per block, and the iteration count
  equals the host loop's exactly: an iteration masked out after
  convergence costs its launches and changes nothing.  Nothing inside a block reads a device value
  (``torch.linalg.qr`` on a card may synchronise inside the solver
  library).
* Lanczos runs ``num_steps`` steps with no test and writes each (alpha,
  beta) into preallocated device tensors, read once at the end.
* A solve is supervised as the engine's batches are: the ``solver.dispatch``
  fault site, retry with capped backoff, demotion of the width's plan down
  the fallback chain (``runtime.supervisor``), then the failure is raised.
  On a card only injected faults are retried and demoted; a kernel that
  really fails raises from the solve.
* ``mesh=`` shards the product over a device mesh with the tuned collective
  schedule (``core.distributed``), and every dot reduces over the same
  shards (``psum_dot_runner``); the vectors live on the mesh's first
  device and the loop runs unchanged.  A mesh solve never demotes: the
  fallback tiers are single-device, and unsharding a solve laid out over a
  mesh would change where its memory lives, so the failure is raised.

* On a card (``captured=True``, the default) each block is a CUDA graph,
  the counterpart of the JAX package's compiled ``lax.while_loop`` body:
  one graph per block size (1, 2, 4, ... ``block``) per solver kind and
  width, all over one set of static tensors (the state, the iteration
  counter and the loop's constants).  A graph runs its masked steps and
  ends by copying the new state into those tensors, so the next replay
  continues from it; the host still reads one flag per block.
  ``captured=False`` enqueues the same steps eagerly.  Mesh solves stay
  eager.

``cg_host_loop`` / ``block_power_host_loop`` keep the loop on the host (one
read per iteration) as the measured baseline.  All loops run the same step
functions, so "the same count as the host loop" is a statement about where
the loop runs.

    from repro_torch.runtime.solver import SparseSolver
    s = SparseSolver(spd_csr)            # on cuda; device="cpu" for the host
    res = s.cg(b, tol=1e-5)
    res.x, res.residual, res.iterations, res.converged, res.syncs

Everything runs in float32; float64 inputs are cast on entry.  CG assumes
an SPD operator and Lanczos a symmetric one: ``core.spmv.spd_shift`` and
``symmetrize`` build them from any CSR.  The step arithmetic is the JAX
package's ``runtime/solver.py``, term for term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.device import resolve, resolve_on
from repro_torch.core.distributed import psum_dot_runner, sparse_axis
from repro_torch.core.formats import CSRMatrix
from repro_torch.runtime.executable import Graph, GraphPool, capture
from repro_torch.runtime.faults import FaultPlan, active_plan
from repro_torch.runtime.supervisor import (
    FALLBACK_TIERS,
    NonFiniteOutput,
    Supervisor,
    fallback_op,
    injected,
)
from repro_torch.tune import PlanCache, SparseOperator

__all__ = [
    "BLOCK",
    "SolverResult",
    "SparseSolver",
    "block_power_host_loop",
    "cg_host_loop",
    "tridiag_eigvalsh",
]

_TINY = 1e-30
BLOCK = 16  # the most iterations enqueued per host read of the flag


@dataclasses.dataclass
class SolverResult:
    """Final state of one solve.

    ``residual`` is the solver's own stopping quantity: ||b - Ax|| (the
    recursive residual) for CG, the last off-diagonal beta for Lanczos, the
    relative Ritz-value change for block power.  ``plan`` is the tuned
    candidate the step ran; ``syncs`` counts the solve's reads of device
    values on the host (one per block, plus the final state).
    """

    solver: str
    iterations: int
    residual: float
    converged: bool
    plan: str = ""
    x: torch.Tensor | None = None  # CG solution
    eigenvalues: np.ndarray | None = None
    eigenvectors: torch.Tensor | None = None  # block power's final V
    alphas: np.ndarray | None = None  # Lanczos tridiagonal diagonal
    betas: np.ndarray | None = None  # Lanczos off-diagonals (last = residual)
    syncs: int = 0


def tridiag_eigvalsh(alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Eigenvalues of the symmetric tridiagonal (alphas; betas off the
    diagonal), by scipy's tridiagonal solver."""
    from scipy.linalg import eigh_tridiagonal

    return eigh_tridiagonal(alphas, betas, eigvals_only=True)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n,) x (n,) -> 0-d; (n, k) x (n, k) -> (k,) per-column dots."""
    return torch.dot(u, v) if u.dim() == 1 else (u * v).sum(0)


def _f32(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"operand is on {v.device}, the solver on {device}")
        return v.to(torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# Step bodies: shared by the device-decided loops and the host loops.
# ---------------------------------------------------------------------------
def _cg_setup(b, x0, tol: float, run, dot=_dot):
    # tol < 0 is the fixed-budget mode: thresh2 = -inf keeps the loop
    # running for exactly maxiter iterations (rs >= 0 always exceeds it,
    # even when the float32 residual underflows to zero) and reports
    # converged=False.
    bb = torch.clamp(dot(b, b), min=_TINY)
    tol2 = float(np.float32(tol) * np.float32(tol))  # tol * tol in float32
    thresh2 = torch.full_like(bb, -torch.inf) if tol < 0 else tol2 * bb
    r0 = b - run(x0)
    return thresh2, r0, dot(r0, r0)


def _cg_body(run, dot=_dot):
    def body(state):
        x, r, p, rs = state
        Ap = run(p)
        pAp = dot(p, Ap)
        alpha = rs / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dot(r, r)
        beta = rs_new / torch.where(rs == 0, 1.0, rs)
        return (x, r, r + beta * p, rs_new)

    return body


def _lanczos_step(run, dot=_dot):
    def step(carry):
        v_prev, v, beta = carry
        w = run(v) - beta * v_prev
        alpha = dot(w, v)
        w = w - alpha * v
        beta_new = torch.sqrt(torch.clamp(dot(w, w), min=0.0))
        v_next = w / torch.where(beta_new == 0, 1.0, beta_new)
        return (v, v_next, beta_new), (alpha, beta_new)

    return step


def _block_power_body(run, dot=_dot):
    def body(state):
        V, theta, _ = state
        W = run(V)
        # Rayleigh quotients diag(V^T A V), taken before the QR: V's columns
        # are orthonormal, so these are the eigenvalue estimates.
        theta_new = dot(V, W)
        V_new = torch.linalg.qr(W).Q
        denom = torch.clamp(theta_new.abs().max(), min=_TINY)
        diff = (theta_new - theta).abs().max() / denom
        return (V_new, theta_new, diff)

    return body


def _masked_steps(body, cond, steps: int, ns: int) -> Callable:
    """``fn(*state, it, *consts)`` over ``ns`` state tensors: ``steps``
    iterations of ``body``, each masked by the device-side condition
    ``cond(state, consts)``; the new state and count are copied into the
    operands."""

    def fn(*flat):
        state, it, consts = flat[:ns], flat[ns], flat[ns + 1:]
        new, count = state, it
        for _ in range(steps):
            active = cond(new, consts)
            stepped = body(new)
            new = tuple(torch.where(active, a, b) for a, b in zip(stepped, new))
            count = count + active
        for dst, src in zip(state, new):
            dst.copy_(src)
        it.copy_(count)

    return fn


class _BlockGraphs:
    """The captured blocks of one solver kind at one width over one plan's
    runner: one graph per block size over shared static tensors, in one
    memory pool (a solve replays them one after another)."""

    def __init__(self, run: Callable):
        self.run = run
        self.static: tuple[torch.Tensor, ...] | None = None
        self.graphs: dict[int, Graph] = {}
        self.pool: GraphPool | None = None

    def load(self, flat: tuple) -> tuple:
        """Copy a solve's starting state, counter and constants into the
        static tensors (made on the first solve); returns them."""
        if self.static is None:
            self.static = tuple(t.clone() for t in flat)
        else:
            for dst, src in zip(self.static, flat):
                dst.copy_(src)
        return self.static

    def replay(self, steps: int, fn: Callable) -> None:
        graph = self.graphs.get(steps)
        if graph is None:
            scratch = tuple(t.clone() for t in self.static)  # the warm-up's
            if self.pool is None:
                self.pool = GraphPool(self.static[0].device)
            graph, _ = capture(fn, *self.static, warmup_args=scratch, pool=self.pool)
            self.graphs[steps] = graph
        graph.replay()


def _run_blocks(body, state: tuple, cond: Callable, consts: tuple, maxiter: int,
                block: int, graphs: _BlockGraphs | None = None
                ) -> tuple[tuple, torch.Tensor, int]:
    """Iterate ``body`` in blocks of 1, 2, 4, ... up to ``block`` steps,
    each step masked by the device-side condition ``cond(state, consts)``;
    the host reads that condition once per block and enqueues no more than
    ``maxiter`` steps.  With ``graphs`` each block is a replay of its
    captured graph, else it is enqueued eagerly.  Returns the final state,
    the device-side count of unmasked steps and the reads."""
    ns = len(state)
    it = torch.zeros((), dtype=torch.int32, device=state[0].device)
    flat = (*state, it, *consts)
    # the blocks write their operands: never the caller's (x0), nor one
    # tensor twice (CG starts with p = r)
    flat = graphs.load(flat) if graphs is not None else tuple(t.clone() for t in flat)
    done = reads = 0
    size = 1
    while done < maxiter:
        steps = min(size, maxiter - done)
        fn = _masked_steps(body, cond, steps, ns)
        if graphs is not None:
            graphs.replay(steps, fn)
        else:
            fn(*flat)
        done += steps
        size = min(2 * size, block)
        if done >= maxiter:
            break  # the budget is spent: no flag to read
        reads += 1
        if not bool(cond(flat[:ns], flat[ns + 1:])):
            break
    return flat[:ns], flat[ns], reads


def _cg_blocks(run, b, x0, tol: float, maxiter: int, block: int, dot=_dot,
               graphs: _BlockGraphs | None = None):
    thresh2, r0, rs0 = _cg_setup(b, x0, tol, run, dot)
    (x, _, _, rs), it, reads = _run_blocks(
        _cg_body(run, dot), (x0, r0, r0, rs0), lambda s, c: s[3] > c[0],
        (thresh2,), maxiter, block, graphs)
    it_h, res_h, conv_h = torch.stack(
        [it.double(), torch.sqrt(rs).double(), (rs <= thresh2).double()]).tolist()
    return x.clone(), res_h, int(it_h), bool(conv_h), reads + 1


def _lanczos_steps(run, v0, num_steps: int, dot=_dot):
    v = v0 / torch.sqrt(torch.clamp(dot(v0, v0), min=_TINY))
    coef = torch.empty((2, num_steps), dtype=torch.float32, device=v0.device)
    carry = (torch.zeros_like(v), v, torch.zeros((), dtype=torch.float32,
                                                  device=v0.device))
    step = _lanczos_step(run, dot)
    for i in range(num_steps):
        carry, (alpha, beta) = step(carry)
        coef[0, i] = alpha
        coef[1, i] = beta
    alphas, betas = coef.cpu().numpy()
    return alphas, betas, 1


def _block_power_blocks(run, v0, tol: float, maxiter: int, block: int, dot=_dot,
                        graphs: _BlockGraphs | None = None):
    k = v0.shape[1]
    dev = v0.device
    state = (torch.linalg.qr(v0).Q, torch.zeros(k, dtype=torch.float32, device=dev),
             torch.full((), torch.inf, dtype=torch.float32, device=dev))
    # tol as a float32 0-d tensor: the comparison the device makes with the
    # Python float, and a graph's input rather than a constant baked into it
    tol_t = torch.full((), tol, dtype=torch.float32, device=dev)
    (V, theta, diff), it, reads = _run_blocks(
        _block_power_body(run, dot), state, lambda s, c: s[2] > c[0], (tol_t,),
        maxiter, block, graphs)
    head = torch.cat([torch.stack([it.double(), diff.double(),
                                   (diff <= tol).double()]), theta.double()])
    it_h, diff_h, conv_h, *theta_h = head.tolist()
    return (V.clone(), np.asarray(theta_h, np.float32), diff_h, int(it_h),
            bool(conv_h), reads + 1)


def _finite(out) -> bool:
    for leaf in out:
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                return False
        elif isinstance(leaf, np.ndarray) and not np.isfinite(leaf).all():
            return False
        elif isinstance(leaf, float) and not np.isfinite(leaf):
            return False
    return True


class SparseSolver:
    """Autotuned iterative solvers over one square sparse operator.

    Holds a lazy table of solver-step plans, one per block width (as the
    engine holds k-buckets).  ``block`` caps the iterations enqueued per
    read of the convergence flag.  ``mesh=`` / ``axis=`` shard the
    product with the tuned collective schedule and reduce every dot over
    the same shards (``psum_dot_runner``); the solver then runs on the
    mesh's first device.  ``captured`` runs the blocks of CG and block
    power as CUDA graphs on a card (see the module docstring).  Remaining
    keyword arguments pass through to :meth:`SparseOperator.build` (warmup,
    timed, candidates, force_search, ...).
    """

    def __init__(
        self,
        a: CSRMatrix,
        *,
        cache: PlanCache | None = None,
        mesh: Any = None,
        axis: str | None = None,
        name: str | None = None,
        supervisor: Supervisor | None = None,
        faults: FaultPlan | None = None,
        nan_guard: bool = False,
        block: int = BLOCK,
        device: str | torch.device | None = None,
        captured: bool = True,
        **build_kwargs: Any,
    ):
        m, n = a.shape
        if m != n:
            raise ValueError(f"iterative solvers need a square operator, got {a.shape}")
        if int(block) < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.device = resolve_on(device, mesh)
        self.mesh = mesh
        self.axis = sparse_axis(mesh, axis) if mesh is not None else axis
        self._dot = psum_dot_runner(mesh, self.axis, n) if mesh is not None else _dot
        self.a = a
        self.shape = a.shape
        self.cache = cache
        self.name = name
        self.supervisor = supervisor if supervisor is not None else Supervisor()
        self.faults = faults if faults is not None else active_plan()
        self.nan_guard = bool(nan_guard)
        self.block = int(block)
        self.captured = bool(captured)
        self._build_kwargs = build_kwargs
        self._graphs: dict[tuple[str, int], _BlockGraphs] = {}
        self._ops: dict[int, SparseOperator] = {}
        self._demoted: dict[int, int] = {}  # k -> fallback-chain level

    # -- plan table ----------------------------------------------------------
    def op(self, k: int = 1) -> SparseOperator:
        """The solver-step plan at block width k (tuned or cache-loaded)."""
        k = int(k)
        op = self._ops.get(k)
        if op is None:
            op = self._ops[k] = SparseOperator.build(
                self.a, k=None if k == 1 else k, solver_step=True,
                cache=self.cache, device=self.device, mesh=self.mesh,
                axis=self.axis, **self._build_kwargs,
            )
        return op

    def _block_graphs(self, solver: str, k: int, run: Callable) -> _BlockGraphs | None:
        """The captured blocks of ``solver`` at width k over ``run`` (None
        where the blocks run eagerly: the CPU, a mesh, ``captured=False``);
        a new runner (a demotion) gets new graphs."""
        if not self.captured or self.mesh is not None or self.device.type != "cuda":
            return None
        graphs = self._graphs.get((solver, k))
        if graphs is None or graphs.run is not run:
            graphs = self._graphs[(solver, k)] = _BlockGraphs(run)
        return graphs

    @property
    def n_graphs(self) -> int:
        """CUDA graphs captured so far (one per block size, kind and width)."""
        return sum(len(g.graphs) for g in self._graphs.values())

    @property
    def from_cache(self) -> bool:
        """True when every built width's plan came from the cache."""
        return all(op.from_cache for op in self._ops.values())

    # -- supervised dispatch -------------------------------------------------
    def _call(self, solver: str, k: int, solve: Callable):
        """Run one solve, ``solve(run)`` on the width's current runner,
        under supervision: retry with capped backoff, then demote the
        width's plan down the fallback chain, then re-raise.  On a card a
        failure no fault plan injected is raised at once.  With
        ``nan_guard=True`` non-finite outputs count as failures."""
        sup = self.supervisor
        budget = sup.max_retries
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.fire("solver.dispatch", solver=solver, k=k,
                                     name=self.name)
                out = solve(self.op(k)._run)
                if self.nan_guard and not _finite(out):
                    raise NonFiniteOutput(
                        f"solver {solver!r} (k={k}) produced non-finite outputs")
                if attempt:
                    sup.record("solver_recovered", solver=solver, k=k,
                               attempts=attempt)
                return out
            except Exception as exc:
                sup.record("solver_attempt_failed", solver=solver, k=k,
                           error=repr(exc))
                if self.device.type != "cuda" or injected(exc):
                    if budget > 0:
                        budget -= 1
                        sup.retries += 1
                        sup.sleep(sup.backoff(attempt))
                        attempt += 1
                        continue
                    if self._demote(solver, k, exc):
                        budget = sup.max_retries
                        attempt += 1
                        continue
                sup.failures += 1
                sup.record("solver_failed", solver=solver, k=k, error=repr(exc))
                raise

    def _demote(self, solver: str, k: int, exc: BaseException) -> bool:
        """Walk width k's plan one tier down the fallback chain; a tier
        whose own build fails is skipped.  False when the chain is spent,
        and always on a mesh (see the module docstring)."""
        if self.mesh is not None:
            return False
        level = self._demoted.get(k, 0) + 1
        while level <= len(FALLBACK_TIERS):
            try:
                tier, op = fallback_op(self.a, k, level, device=self.device)
            except Exception:
                level += 1
                continue
            self._ops[k] = op
            self._demoted[k] = level
            self.supervisor.demotions += 1
            self.supervisor.record("demote", solver=solver, k=k, tier=tier,
                                   level=level, error=repr(exc))
            return True
        return False

    # -- CG ------------------------------------------------------------------
    def cg(self, b, *, x0=None, tol: float = 1e-5, maxiter: int = 500) -> SolverResult:
        """Solve A x = b (A SPD) by conjugate gradients.

        Stops when ||r|| <= tol * ||b|| or at ``maxiter``, decided on the
        device; the host reads one flag per block of iterations.
        ``tol < 0`` disables the test: exactly ``maxiter`` iterations run
        and ``converged`` is False (the fixed-budget rate mode).
        """
        b = _f32(b, self.device)
        if x0 is None:
            x0 = torch.zeros_like(b)
        else:
            x0 = _f32(x0, self.device)
            if x0.shape != b.shape:
                raise ValueError(f"expected x0 of shape {tuple(b.shape)}, got "
                                 f"{tuple(x0.shape)}")
        x, res, it, conv, syncs = self._call(
            "cg", 1,
            lambda run: _cg_blocks(run, b, x0, float(tol), int(maxiter), self.block,
                                   self._dot, self._block_graphs("cg", 1, run)))
        return SolverResult(solver="cg", iterations=it, residual=res, converged=conv,
                            plan=self.op(1).plan.candidate.key(), x=x, syncs=syncs)

    # -- Lanczos -------------------------------------------------------------
    def lanczos(self, *, num_steps: int = 32, v0=None, seed: int = 0) -> SolverResult:
        """Lanczos tridiagonalisation of symmetric A: exactly ``num_steps``
        three-term recurrences with no test, the coefficients read once.
        ``eigenvalues`` are the Ritz values of the tridiagonal; the last
        beta is the residual (how far the Krylov space has closed)."""
        n = self.shape[1]
        if v0 is None:
            v0 = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        v0 = _f32(v0, self.device)
        alphas, betas, syncs = self._call(
            "lanczos", 1, lambda run: _lanczos_steps(run, v0, int(num_steps), self._dot))
        ritz = tridiag_eigvalsh(alphas, betas[:-1]) if num_steps > 1 else alphas
        return SolverResult(solver="lanczos", iterations=int(num_steps),
                            residual=float(betas[-1]), converged=True,
                            plan=self.op(1).plan.candidate.key(), eigenvalues=ritz,
                            alphas=alphas, betas=betas, syncs=syncs)

    # -- block power ---------------------------------------------------------
    def block_power(self, k: int = 8, *, tol: float = 1e-4, maxiter: int = 200,
                    v0=None, seed: int = 0) -> SolverResult:
        """Top-k eigenpairs of symmetric A by block power iteration.

        The step is W = A V (the plan tuned at SpMM width k), the Rayleigh
        quotients diag(V^T A V), then a QR of W.  Converges when the
        largest relative Ritz-value change drops to ``tol``, decided on the
        device; ``tol < 0`` runs exactly ``maxiter`` iterations.
        """
        n = self.shape[1]
        k = int(k)
        if v0 is None:
            v0 = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
        v0 = _f32(v0, self.device)
        if tuple(v0.shape) != (n, k):
            raise ValueError(f"expected v0 of shape {(n, k)}, got {tuple(v0.shape)}")
        V, theta, diff, it, conv, syncs = self._call(
            "block_power", k,
            lambda run: _block_power_blocks(run, v0, float(tol), int(maxiter),
                                            self.block, self._dot,
                                            self._block_graphs("block_power", k, run)))
        return SolverResult(solver="block_power", iterations=it, residual=diff,
                            converged=conv, plan=self.op(k).plan.candidate.key(),
                            eigenvalues=theta, eigenvectors=V, syncs=syncs)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        plans = {k: op.plan.candidate.key() for k, op in self._ops.items()}
        where = f"device={self.device}" if self.mesh is None else repr(self.mesh)
        return (f"SparseSolver({self.shape[0]}x{self.shape[1]}, nnz={self.a.nnz}, "
                f"plans={plans}, {where})")


# ---------------------------------------------------------------------------
# The loop on the host: one read per iteration (the measured baseline).
# ---------------------------------------------------------------------------
def cg_host_loop(matvec: Callable[[torch.Tensor], torch.Tensor], b, *, x0=None,
                 tol: float = 1e-5, maxiter: int = 500,
                 device: str | torch.device = "cuda") -> SolverResult:
    """CG with the loop on the host: every iteration reads ``rs`` back
    (``float(rs)``, a synchronisation).  Runs the same step functions as
    :meth:`SparseSolver.cg`, so counts and flags agree with it."""
    device = resolve(device)
    b = _f32(b, device)
    x = torch.zeros_like(b) if x0 is None else _f32(x0, device)
    thresh2, r, rs = _cg_setup(b, x, float(tol), matvec)
    thresh2 = float(thresh2)
    state = (x, r, r, rs)
    step = _cg_body(matvec)
    it = 0
    rs_h = float(rs)
    while it < maxiter and rs_h > thresh2:
        state = step(state)
        rs_h = float(state[3])
        it += 1
    x, _, _, rs = state
    return SolverResult(solver="cg", iterations=it, residual=float(torch.sqrt(rs)),
                        converged=rs_h <= thresh2, x=x, syncs=it + 3)


def block_power_host_loop(matvec: Callable[[torch.Tensor], torch.Tensor], v0, *,
                          tol: float = 1e-4, maxiter: int = 200,
                          device: str | torch.device = "cuda") -> SolverResult:
    """Block power iteration with the loop on the host (see
    :func:`cg_host_loop`)."""
    device = resolve(device)
    v0 = _f32(v0, device)
    k = v0.shape[1]
    state = (torch.linalg.qr(v0).Q, torch.zeros(k, dtype=torch.float32, device=device),
             torch.full((), torch.inf, dtype=torch.float32, device=device))
    step = _block_power_body(matvec)
    tol = float(np.float32(tol))  # the device compares in float32
    it = 0
    diff_h = float("inf")
    while it < maxiter and diff_h > tol:
        state = step(state)
        diff_h = float(state[2])
        it += 1
    V, theta, diff = state
    return SolverResult(solver="block_power", iterations=it, residual=float(diff),
                        converged=diff_h <= tol, eigenvalues=theta.cpu().numpy(),
                        eigenvectors=V, syncs=it + 2)

"""The SparseOperator facade: one object wrapping prepare + dispatch.

    from repro_torch.tune import SparseOperator
    op = SparseOperator.build(csr)          # autotuned (plan-cached) SpMV, on cuda
    y = op @ x
    sop = SparseOperator.build(csr, x_nnz=B)  # tuned for a sparse x of <= B nonzeros
    y = sop.apply_sparse(indices, values)     # or sop @ (indices, values)

``build`` runs the paper's whole selection pipeline: extract structural
features, enumerate the format x impl x params cross-product, prune it with
the byte-model cost estimate, time the survivors with the benchmark timer,
persist the winning :class:`~repro_torch.tune.plan.Plan` (keyed by structure
fingerprint, so a rebuild skips the search), and return an operator holding
the prepared device tensors of the winning candidate.

Every entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card visible a CUDA request raises.

On a device mesh (``build(mesh=...)``, :mod:`repro_torch.core.distributed`)
the search is over the collective schedules, each shard running the plain
CSR product; x and y live on the mesh's first device.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import os
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core.device import backend_name, resolve, resolve_on
from repro_torch.core.formats import CSRMatrix, bcsr_from_csr, sell_from_csr
from repro_torch.core import reorder as ro
from repro_torch.core.spmv import (
    csr_bind,
    csr_prepare,
    csr_scalar_prepare,
    spmm_bcsr_dense,
    spmm_csr,
    spmm_sell,
    spmv_csr,
    spmv_csr_scalar,
    spmv_sell,
)
from repro_torch.kernels import _build
from repro_torch.kernels import merge_spmv as kmerge
from repro_torch.kernels import ops as kops
from repro_torch.kernels import spmspv as kspmspv
from repro_torch.runtime.executable import aot_compile
from repro_torch.runtime.faults import active_plan

from .candidates import (
    DEFAULT_PRUNE_FACTOR,
    REORDER_METHODS,
    Candidate,
    enumerate_candidates,
    enumerate_mesh_candidates,
    estimate_cost,
    prune,
    split_reorder,
)
from .features import MatrixFeatures, extract
from .plan import Plan, PlanCache, default_cache, fingerprint, mesh_backend
from .predict import PREDICT_RADIUS, Prediction, byte_model_order, predict_candidate
from .timing import RACE_FACTOR, time_fn

__all__ = [
    "InaccurateTier",
    "NoSpMMTier",
    "SparseOperator",
    "PrepCache",
    "evict_prepared",
    "prep_memo_stats",
    "prep_nbytes",
    "prepare",
    "prepare_cached",
    "runner",
    "search_skips",
    "solver_step_probe",
    "sparse_rhs_runner",
]


class NoSpMMTier(ValueError):
    """Raised at bind time by a tier that serves k = 1 only, asked for k > 1.

    The one failure the measured search on a card may record and pass over:
    the SpMM space enumerates column-slab candidates that cannot serve it.
    """


class InaccurateTier(ValueError):
    """A candidate whose answer on the search's probe is farther from the
    float64 product than any float32 sum of each row's own terms can be:
    ``|y_i - y64_i| > max(1e-5, k_i 2**-24) (|A| |x|)_i`` with k_i the row's
    nonzero terms.  On that matrix the tier does not compute the same
    function to float32 rounding (the merge tier, whose rows are
    differences of global prefix sums, on rows small beside max|P|).  The
    search passes over a plain tier that fails the check; a ``cuda`` kernel
    that fails it on a card ends the build (``kernel=True``)."""

    def __init__(self, msg: str, *, kernel: bool):
        super().__init__(msg)
        self.kernel = kernel


# ---------------------------------------------------------------------------
# Prepare + dispatch per candidate
# ---------------------------------------------------------------------------
_ORDERINGS = {"rcm": ro.rcm, "degree": ro.degree_order}
_REORDERED: collections.OrderedDict = collections.OrderedDict()
_REORDERED_KEEP = 4  # (perm, permuted matrix) pairs kept across candidates
_reorder_lock = threading.Lock()


def _reordered(a: CSRMatrix, method: str) -> tuple[np.ndarray, CSRMatrix]:
    """(perm, A permuted by it), memoized: every reordered candidate of one
    search shares one ordering (RCM is a host BFS, about a second on
    cant)."""
    key = (fingerprint(a), _value_digest(a), method)
    with _reorder_lock:
        hit = _REORDERED.get(key)
        if hit is not None:
            _REORDERED.move_to_end(key)
            return hit
    perm = _ORDERINGS[method](a)
    hit = (perm, a.permuted(perm))
    with _reorder_lock:
        _REORDERED[key] = hit
        while len(_REORDERED) > _REORDERED_KEEP:
            _REORDERED.popitem(last=False)
    return hit


def prepare(a: CSRMatrix, cand: Candidate, *, device, mesh=None,
            axis: str | None = None, prep_cache: dict | None = None) -> dict[str, Any]:
    """Host-side format construction for one candidate, placed on ``device``.

    A reordered candidate holds its permutation (new -> old) on the device,
    the permuted matrix and the base candidate's prepared dict for it.
    A ``dist`` candidate (a collective schedule) is partitioned and placed
    on ``mesh`` over ``axis``; ``prep_cache``, keyed by (schedule, shards),
    shares that operand across the engine's buckets, which differ only in
    the width of x."""
    if cand.fmt == "dist":
        if mesh is None or axis is None:
            raise ValueError("dist candidates need mesh= and axis=")
        n_shards = int(cand.param_dict["n_shards"])
        key = (cand.impl, n_shards)
        if prep_cache is not None and key in prep_cache:
            return prep_cache[key]
        prep = dist.place_mesh_operand(
            dist.build_mesh_operand(a, n_shards, cand.impl), mesh, axis)
        if prep_cache is not None:
            prep_cache[key] = prep
        return prep
    method, base = split_reorder(cand)
    if method is not None:
        perm, ar = _reordered(a, method)
        return {"perm": torch.as_tensor(perm, device=device), "matrix": ar,
                "inner": prepare(ar, base, device=device)}
    p = cand.param_dict
    if cand.fmt == "csr":
        if cand.impl == "scalar":
            return {"dev": csr_scalar_prepare(a, device)}
        return {"dev": csr_prepare(a, device)}
    if cand.fmt == "merge":
        return kmerge.merge_prepare(a, int(p.get("chunk", kmerge.DEFAULT_CHUNK)),
                                    device=device)
    if cand.fmt == "sell":
        return kops.sell_prepare(
            sell_from_csr(a, C=int(p["C"]), sigma=int(p["sigma"]), width_align=8),
            int(p.get("chunk_tile", 8)),
            device=device,
        )
    if cand.fmt == "sell_blocked":
        if cand.impl == "cuda":
            # One launch over slabs that share one row permutation.
            return kops.sell_prepare_blocked_stacked(
                a, int(p["n_slabs"]), C=int(p["C"]), sigma=int(p["sigma"]),
                device=device,
            )
        return kops.sell_prepare_blocked(
            a, int(p["n_slabs"]), chunk_tile=int(p.get("chunk_tile", 8)),
            C=int(p["C"]), sigma=int(p["sigma"]), device=device,
        )
    if cand.fmt == "bcsr":
        return kops.bcsr_prepare(bcsr_from_csr(a, tuple(p["block"])), device)
    if cand.fmt == "spmspv":
        return kspmspv.spmspv_prepare(a, device=device)
    raise ValueError(f"unknown candidate format: {cand.fmt}")


def prep_nbytes(obj: Any) -> int:
    """Bytes pinned by a prepared format dict (recursive over dicts/lists,
    and the permuted matrix a reordered candidate holds)."""
    if isinstance(obj, CSRMatrix):
        return prep_nbytes([obj.indptr, obj.indices, obj.data])
    if isinstance(obj, dict):
        if "placed" in obj:  # a mesh operand: what it holds on its devices
            return dist.mesh_operand_nbytes(obj)
        return sum(prep_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(prep_nbytes(v) for v in obj)
    nbytes = getattr(obj, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0


_ENV_PREP_BUDGET = "REPRO_PREP_BUDGET_BYTES"
_DEFAULT_PREP_BUDGET = 256 * 1024 * 1024


class PrepCache:
    """Byte-budgeted, thread-safe LRU memo of prepared format dicts.

    Preparation depends on the matrix and the candidate, never on k, so the
    engine's k-buckets and pinned candidates share one instance per
    (structure, values, candidate, device).  Eviction is by bytes, never
    of the entry just inserted (the caller holds it).
    """

    def __init__(self, budget_bytes: int | None = None):
        if budget_bytes is None:
            budget_bytes = int(os.environ.get(_ENV_PREP_BUDGET, _DEFAULT_PREP_BUDGET))
        self.budget_bytes = int(budget_bytes)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._bytes: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        return sum(self._bytes.values())

    def get_or_build(self, key: tuple, build: Callable[[], dict]) -> dict:
        with self._lock:
            prep = self._entries.get(key)
            if prep is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return prep
            self.misses += 1
        # Build outside the lock: preparation is O(nnz) host work.  A racing
        # duplicate build is wasted work, not corruption.
        prep = build()
        nbytes = prep_nbytes(prep)
        with self._lock:
            self._entries[key] = prep
            self._entries.move_to_end(key)
            self._bytes[key] = nbytes
            while len(self._entries) > 1 and self.resident_bytes > self.budget_bytes:
                old_key, _ = self._entries.popitem(last=False)
                self._bytes.pop(old_key, None)
                self.evictions += 1
        return prep

    def evict_fp(self, fp: str) -> int:
        """Drop every entry of one fingerprint; returns the bytes released
        (the arrays go once no operator holds them)."""
        with self._lock:
            keys = [k for k in self._entries if k[0] == fp]
            for k in keys:
                del self._entries[k]
                self.evictions += 1
            return sum(self._bytes.pop(k, 0) for k in keys)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "resident_bytes": self.resident_bytes,
                    "budget_bytes": self.budget_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


_PREP_MEMO = PrepCache()


def evict_prepared(fp: str) -> int:
    """Release every memoized prepared dict of one fingerprint; returns the
    bytes released."""
    return _PREP_MEMO.evict_fp(fp)


def prep_memo_stats() -> dict[str, int]:
    """Hit, miss and eviction counters and the residency of the
    process-wide prep memo (``FleetStats.summary()`` reports them).  The
    brownout does not read them: a filled LRU is not pressure."""
    return _PREP_MEMO.stats()


def _value_digest(a: CSRMatrix) -> str:
    return hashlib.sha256(np.ascontiguousarray(a.data).tobytes()).hexdigest()[:16]


def prepare_cached(
    a: CSRMatrix, cand: Candidate, *, device, fp: str | None = None, mesh=None,
    axis: str | None = None, prep_cache: dict | None = None,
) -> dict[str, Any]:
    """:func:`prepare`, memoized on (fingerprint, value digest, candidate,
    device) in the process-wide byte-budgeted :class:`PrepCache`.  A
    ``dist`` candidate bypasses the memo: its placement is bound to its
    mesh and shared through the caller's ``prep_cache``.

    The ``prepare.oom`` fault site fires here, memo hit or not: format
    preparation is where the large allocations happen."""
    faults = active_plan()
    if faults is not None:
        faults.fire("prepare.oom", exc=MemoryError, candidate=cand.key())
    if cand.fmt == "dist":
        return prepare(a, cand, device=device, mesh=mesh, axis=axis,
                       prep_cache=prep_cache)
    device = torch.device(device)
    key = (fp or fingerprint(a), _value_digest(a), cand.key(), str(device))
    return _PREP_MEMO.get_or_build(key, lambda: prepare(a, cand, device=device))


def runner(
    a: CSRMatrix, cand: Candidate, prep: dict[str, Any], *, k: int = 1,
    mesh=None, axis: str | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a candidate + prepared tensors into ``fn(x) -> y``.

    k == 1 binds SpMV (x is (n,)); k > 1 binds SpMM (x is (n, k)).  The
    SELL kernel and both column-slab tiers serve k = 1 only and raise
    :class:`NoSpMMTier` at bind time for k > 1.  A ``dist`` candidate runs
    its collective schedule over ``mesh`` and takes either shape.
    """
    m, n = a.shape
    if cand.fmt == "spmspv":
        raise ValueError(
            "spmspv candidates take a sparse operand — bind them through "
            "sparse_rhs_runner(a, cand, prep, x_nnz=...) instead of runner()"
        )
    if cand.fmt == "dist":
        if mesh is None or axis is None:
            raise ValueError("dist candidates need mesh= and axis=")
        return dist.mesh_spmm_runner(mesh, axis, prep)
    method, base = split_reorder(cand)
    if method is not None:
        # y = A x == P^T (P A P^T) (P x): gather x by the permutation, run
        # the base candidate on the permuted matrix, scatter y back into a
        # fresh tensor (never a view of the operand).
        inner = runner(prep["matrix"], base, prep["inner"], k=k)
        perm = prep["perm"]

        def fn(x):
            yp = inner(x[perm])
            y = torch.empty_like(yp)
            y[perm] = yp
            return y

        return fn
    if cand.fmt == "csr":
        if cand.impl == "scalar":
            if k > 1:
                raise NoSpMMTier("csr/scalar has no SpMM tier (k > 1)")
            return lambda x: spmv_csr_scalar(prep["dev"], x, n_rows=m)
        return csr_bind(prep["dev"], n_rows=m, k=k)

    if cand.fmt == "merge":
        if k == 1:
            return lambda x: kmerge.merge_spmv(prep, x)
        return lambda x: kmerge.merge_spmm(prep, x)

    if cand.fmt == "sell":
        if cand.impl == "cuda":
            if k > 1:
                raise NoSpMMTier("sell/cuda has no SpMM tier (k > 1)")
            return lambda x: kops.sell_spmv(prep, x)
        if k > 1:
            return lambda x: spmm_sell(prep, x, n_rows=m)
        return lambda x: spmv_sell(prep, x, n_rows=m)

    if cand.fmt == "sell_blocked":
        if k > 1:
            raise NoSpMMTier(f"sell_blocked/{cand.impl} has no SpMM tier (k > 1)")
        if cand.impl == "cuda":
            return lambda x: kops.sell_spmv_blocked_stacked(prep, x)
        return lambda x: kops.sell_spmv_blocked(prep, x)

    if cand.fmt == "bcsr":
        if cand.impl == "cuda":
            if k == 1:
                return lambda x: kops.bcsr_spmm(prep, x[:, None])[:, 0]
            return lambda x: kops.bcsr_spmm(prep, x)
        gm, gn = prep["grid_shape"]
        bm, bk = prep["block_shape"]

        def fn(x):
            x2 = x[:, None] if x.dim() == 1 else x
            kk = x2.shape[-1]
            xp = torch.zeros((gn * bk, kk), dtype=x2.dtype, device=x2.device)
            xp[:n] = x2
            out = spmm_bcsr_dense(prep, xp.view(gn, bk, kk), n_block_rows=gm)
            out = out.reshape(gm * bm, kk)[:m]
            return out[:, 0] if x.dim() == 1 else out

        return fn

    raise ValueError(f"unknown candidate format: {cand.fmt}")


def sparse_rhs_runner(
    a: CSRMatrix,
    cand: Candidate,
    prep: dict[str, Any],
    *,
    x_nnz: int,
    device: torch.device,
) -> Callable[[tuple], torch.Tensor]:
    """Bind ANY candidate into ``fn((xi, xv)) -> y`` over a sparse RHS.

    ``xi``/``xv`` are (x_nnz,) padded host arrays (sentinel index n, value
    0; see :func:`~repro_torch.kernels.spmspv.pad_sparse_rhs`).  ``spmspv``
    candidates run the bucket tier; every dense tier is wrapped in a
    densify step ahead of its k = 1 runner, so the search times dense and
    sparse tiers on the same operand.  The densify writes into an (n + 1,)
    buffer and keeps ``[:n]``: the sentinel slots land in the dropped
    entry.  Real indices are validated unique, so it is deterministic.
    """
    bucket = max(int(x_nnz), 1)
    n = a.shape[1]
    if cand.fmt == "spmspv":
        return kspmspv.spmspv_bind(prep, bucket, impl=cand.impl, **cand.param_dict)
    base = runner(a, cand, prep, k=1)

    def fn(sx):
        xi, xv = sx
        x = torch.zeros(n + 1, dtype=torch.float32, device=device)
        x[torch.as_tensor(np.asarray(xi), device=device).long()] = torch.as_tensor(
            np.asarray(xv, dtype=np.float32), device=device)
        return base(x[:n])

    return fn


def solver_step_probe(run: Callable, k: int) -> Callable:
    """Wrap a bound runner into the composite one solver step runs:
    kind="solver_step" plans are timed on it instead of the bare product
    (on the CPU; a card times the bare product, see ``SparseOperator.build``).

    At k == 1 it is CG-shaped (one y = A x, two dot reductions, two axpys
    over m-vectors); at k > 1 block-power-shaped (A V, the per-column
    Rayleigh quotients diag(V^T A V) and a column-normalised update).  The
    QR a block step adds costs the same under every candidate and is left
    out.  The arithmetic is the JAX package's ``solver_step_probe``.
    """
    if k == 1:

        def step(x):
            y = run(x)
            curve = torch.dot(x, y)
            alpha = torch.dot(x, x) / torch.where(curve == 0, 1.0, curve)
            r = x - alpha * y
            return r + alpha * x

    else:

        def step(v):
            w = run(v)
            theta = (v * w).sum(0)
            scale = torch.linalg.vector_norm(w, dim=0)
            return w / torch.where(scale == 0, 1.0, scale) + 0.0 * theta

    return step


def search_skips(exc: Exception, device: torch.device, *,
                 stage: str = "run") -> bool:
    """Whether the measured search records ``exc`` and passes over the
    candidate that raised it.  On the CPU any failure only disqualifies its
    candidate.  On a card, while binding or running a candidate
    (``stage="run"``), only :class:`NoSpMMTier` does: a kernel that fails
    to launch (or a sticky CUDA fault, which would poison every candidate
    timed after it) must end the build, not hand the work to a plain tier.
    While *preparing* a candidate (``stage="prepare"``) running out of
    memory does too: a host ``MemoryError`` (injected at ``prepare.oom`` or
    real) or ``torch.cuda.OutOfMemoryError`` (a ``RuntimeError``: the caching
    allocator refused one format's tensors and the context stays usable).
    The other candidates' formats may still fit.  A plain tier that fails
    the accuracy check (:class:`InaccurateTier`) loses; a kernel that
    fails it on a card ends the build."""
    if isinstance(exc, InaccurateTier):
        return device.type != "cuda" or not exc.kernel
    if device.type != "cuda" or isinstance(exc, NoSpMMTier):
        return True
    return stage == "prepare" and isinstance(
        exc, (MemoryError, torch.cuda.OutOfMemoryError))


ACCURACY_TOL = 1e-5  # the repo's row tolerance, relative to (|A| |x|)_i


def probe_reference(a: CSRMatrix, x, *, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(y64, limit) of the search's probe ``x`` (a dense (n,) or (n, k)
    tensor, or the padded host ``(xi, xv)`` of a sparse one): the float64
    product on ``device`` and the per-row limit ``max(1e-5, 1.01 k_i
    2**-24) (|A| |x|)_i``.  k_i 2**-24 (|A| |x|)_i bounds the error of any
    float32 sum of row i's k_i nonzero products, in any order; the 1 %
    covers the second-order terms."""
    n = a.shape[1]
    if isinstance(x, tuple):  # sentinel slots (index n) land in a dropped entry
        xi, xv = x
        dense = torch.zeros(n + 1, dtype=torch.float64, device=device)
        dense[torch.as_tensor(np.asarray(xi), device=device).long()] = torch.as_tensor(
            np.asarray(xv, dtype=np.float64), device=device)
        x = dense[:n]
    X = x.double().reshape(n, -1)
    offsets = torch.as_tensor(a.indptr, device=device).long()
    prods = (torch.as_tensor(a.data, device=device).double()[:, None]
             * X[torch.as_tensor(a.indices, device=device).long()])

    def row_sum(v):
        return torch.segment_reduce(v, "sum", offsets=offsets, axis=0, unsafe=True)

    terms = row_sum((prods != 0).double())
    lim = torch.clamp(1.01 * terms * 2.0**-24, min=ACCURACY_TOL) * row_sum(prods.abs())
    shape = (a.shape[0],) + tuple(x.shape[1:])
    return row_sum(prods).reshape(shape), lim.reshape(shape)


def check_accuracy(cand: Candidate, y: torch.Tensor, ref: tuple) -> None:
    """Raise :class:`InaccurateTier` when ``y`` breaks the limit of
    :func:`probe_reference` anywhere (a non-finite entry breaks it)."""
    y64, lim = ref
    err = (y.double() - y64).abs()
    bad = ~(err <= lim)
    if bool(bad.any()):
        i = int(torch.argmax(torch.where(bad, err - lim, -1.0).flatten()))
        raise InaccurateTier(
            f"{cand.key()}: {int(bad.sum())} of {bad.numel()} entries of the probe "
            f"break max(1e-5, k_i 2^-24) (|A||x|)_i; worst entry {i}: err "
            f"{float(err.flatten()[i]):.3e} > {float(lim.flatten()[i]):.3e}",
            kernel=cand.impl == "cuda",
        )


def _dense_probe(a: CSRMatrix, kk: int, seed: int, device) -> torch.Tensor:
    """The search's seeded dense probe: (n,) at k = 1, else (n, k)."""
    shape = (a.shape[1],) if kk == 1 else (a.shape[1], kk)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)


def _plan_params(cand: Candidate) -> dict[str, Any]:
    return {kp: list(v) if isinstance(v, tuple) else v for kp, v in cand.params}


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class SparseOperator:
    """An autotuned sparse linear operator: ``y = op @ x``, on one device or,
    built with ``mesh=``, over a mesh whose first device holds x and y."""

    def __init__(
        self,
        a: CSRMatrix,
        plan: Plan,
        prep: dict[str, Any],
        *,
        device: torch.device,
        from_cache: bool,
        features: MatrixFeatures | None = None,
        measurements: dict[str, float] | None = None,
        search_failures: dict[str, Exception] | None = None,
        mesh=None,
        axis: str | None = None,
    ):
        self.a = a
        self.mesh = mesh
        self.axis = axis
        self.plan = plan
        self.shape = a.shape
        self.device = device
        self.from_cache = from_cache  # True -> the measured search was skipped
        self.features = features
        self.measurements = dict(measurements or {})  # candidate key -> seconds
        # Candidate key -> the exception that disqualified it in the search.
        self.search_failures = dict(search_failures or {})
        # Set by build_predicted: the Prediction behind the served candidate,
        # and the seconds its accuracy checks took, preparation included.
        self.predicted: Prediction | None = None
        self.check_s = 0.0
        self._prep = prep
        if plan.kind == "spmspv":
            # plan.k carries the x-nnz bucket; the runner takes (xi, xv).
            self._run = sparse_rhs_runner(a, plan.candidate, prep, x_nnz=plan.k,
                                          device=device)
        else:
            self._run = runner(a, plan.candidate, prep, k=plan.k, mesh=mesh, axis=axis)
        self._csr_dev: dict | None = prep.get("dev")  # fallback path, lazy
        self._aot: dict[tuple, Callable] = {}  # operand shape -> executable

    # -- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        a: CSRMatrix,
        *,
        k: int | None = None,
        cache: PlanCache | None = None,
        candidates: Iterable[Candidate] | None = None,
        prune_factor: float = DEFAULT_PRUNE_FACTOR,
        warmup: int = 1,
        timed: int = 3,
        force_search: bool = False,
        include_reorder: bool = False,
        seed: int = 0,
        race: bool = True,
        device: str | torch.device | None = None,
        solver_step: bool = False,
        x_nnz: int | None = None,
        mesh=None,
        axis: str | None = None,
        prep_cache: dict | None = None,
    ) -> "SparseOperator":
        """Autotune (or fetch the cached plan for) this matrix.

        k=None tunes SpMV; k=<width> tunes SpMM with an (n, k) operand.
        ``x_nnz=<bucket>`` tunes for a *sparse* x instead (kind="spmspv"):
        the dense SpMV tiers, each timed through its densify wrapper, and
        the bucket SpMSpV tier, all on one random sorted x of ``x_nnz``
        nonzeros.  ``plan.k`` stores the bucket, so the cache keys sparse
        plans per bucket as it keys SpMM plans per k.  Serve with
        ``op.apply_sparse(indices, values)`` or ``op @ (indices, values)``.
        Mutually exclusive with ``k`` and ``solver_step``.
        ``solver_step=True`` tunes the plan one step of an iterative
        solver runs (kind="solver_step", ``runtime.solver``): the same
        kernels, priced by ``estimate_cost(fused=True)`` and timed on
        :func:`solver_step_probe` (the product with the step's axpys and
        dots around it), cached as a kind of their own.  On a card the
        search times the bare product instead: until a step is captured as
        one graph, the probe's time there is host launch overhead.  The
        accuracy check runs on the bare product.
        ``candidates`` overrides enumeration (pruning still applies);
        ``force_search`` ignores a cached plan; ``include_reorder`` adds
        RCM-permuted variants to the space (paper §4.4).  Plans taken on
        another backend or at another (m, n, nnz) are misses.

        ``race`` (default on) times survivors cheapest-estimate-first and
        abandons one whose first steady-state rep exceeds ``RACE_FACTOR`` x
        the current best median (confirmed by one more rep).

        ``device`` defaults to ``"cuda"``.  ``mesh=`` / ``axis=`` (default
        the mesh's first axis) switch the space to the collective schedules
        (:func:`~repro_torch.tune.candidates.enumerate_mesh_candidates`)
        over that mesh; x and y live on its first device (``device`` must
        be that one, or None).  The plan records ``mesh_shape`` and its
        backend the distinct devices the mesh spans
        (:func:`~repro_torch.tune.plan.mesh_backend`), so another shard
        count, or the same shards on more or fewer cards, re-searches.
        ``prep_cache`` (a dict) shares each schedule's placed operand
        across builds; a sparse x over a mesh raises
        ``NotImplementedError``, as in the JAX package.

        A candidate about to become the best is first checked against a
        float64 product of the probe (:func:`probe_reference`): a plain
        tier farther from it than float32 rounding of the row's own terms
        allows loses (:class:`InaccurateTier`).

        A candidate that fails to prepare or run is recorded in
        ``op.search_failures`` and loses; the others still compete.  On a
        card only a k = 1 tier asked for k > 1, or a prepare that ran out
        of memory, loses so (see :func:`search_skips`): the kernels are
        built before the search, and any other failure, a refused launch
        included, raises.
        """
        kind = "spmv" if k is None else "spmm"
        if solver_step:
            kind = "solver_step"
        kk = 1 if k is None else int(k)
        if x_nnz is not None:
            if k is not None or solver_step:
                raise ValueError(
                    "x_nnz= (sparse RHS) is mutually exclusive with "
                    "k=/solver_step="
                )
            if mesh is not None:
                raise NotImplementedError(
                    "a sparse x over a device mesh is not implemented: "
                    "distributed SpMSpV is a feature of neither package yet"
                )
            kind = "spmspv"
            kk = max(int(x_nnz), 1)  # plan.k carries the x-nnz bucket
        device = resolve_on(device, mesh)
        sparse_kind = kind == "spmspv"
        fp = fingerprint(a)
        backend = backend_name(device)
        mesh_shape: list[int] = []
        if mesh is not None:
            axis = dist.sparse_axis(mesh, axis)
            mesh_shape = [int(mesh.shape[axis])]
            backend = mesh_backend(backend, mesh.n_devices)
        on_mesh = dict(mesh=mesh, axis=axis, prep_cache=prep_cache)
        scale = [int(a.shape[0]), int(a.shape[1]), int(a.nnz)]
        cache = default_cache() if cache is None else cache
        if not force_search:
            plan = cache.get(fp, kind, kk, backend=backend, scale=scale,
                             mesh_shape=mesh_shape)
            if plan is not None:
                return cls(
                    a, plan,
                    prepare_cached(a, plan.candidate, fp=fp, device=device, **on_mesh),
                    device=device, from_cache=True, mesh=mesh, axis=axis,
                )
        if device.type == "cuda":
            _build.ensure_built()

        width = 1 if sparse_kind else kk  # the dense operand's width
        feats = extract(a, k=width, x_nnz=kk if sparse_kind else None)
        if candidates is not None:
            cands = list(candidates)
        elif mesh is not None:
            cands = enumerate_mesh_candidates(feats, mesh_shape[0])
        else:
            cands = enumerate_candidates(
                feats, kind, k=width,
                reorders=REORDER_METHODS if include_reorder else (),
            )
        on_cpu = device.type == "cpu"
        costs = {
            c: estimate_cost(a, c, feats, k=width, on_cpu=on_cpu,
                             fused=solver_step, sparse_rhs=sparse_kind)
            for c in cands
        }
        survivors = sorted(prune(costs, factor=prune_factor), key=costs.get)

        rng = np.random.default_rng(seed)
        if sparse_kind:
            # One random sorted sparse x probes every survivor, as host
            # arrays: the spmspv runners read them on the host.
            n = a.shape[1]
            nx = min(kk, n)
            idx = np.sort(rng.choice(n, size=nx, replace=False)).astype(np.int64)
            val = rng.standard_normal(nx).astype(np.float32)
            x = kspmspv.pad_sparse_rhs(idx, val, kk, n)
        else:
            x = _dense_probe(a, kk, seed, device)

        measurements: dict[str, float] = {}
        failures: dict[str, Exception] = {}
        best: tuple[float, Candidate, dict] | None = None
        ref = None  # the probe's float64 product, made when first needed
        n_raced = 0
        # The first candidate (no best yet) gets the same warmup as the
        # raced ones, so its lone first rep never eats lazy setup.
        warmup_eff = max(warmup, 1) if race else warmup
        for c in survivors:
            stage = "prepare"
            try:
                prep = prepare_cached(a, c, fp=fp, device=device, **on_mesh)
                stage = "run"
                if sparse_kind:
                    fn = sparse_rhs_runner(a, c, prep, x_nnz=kk, device=device)
                else:
                    fn = runner(a, c, prep, k=kk, mesh=mesh, axis=axis)
                # On a card the probe's few-microsecond axpys and dots are
                # host-launch bound, so its time ranks launch overhead, not
                # kernels: there the search times the bare product.
                probed = solver_step and device.type != "cuda"
                timed_fn = solver_step_probe(fn, kk) if probed else fn
                abort = RACE_FACTOR * best[0] if (race and best is not None) else None
                t = time_fn(timed_fn, x, warmup=warmup_eff, timed=timed,
                            abort_above=abort, device=device)
                if not math.isinf(t) and (best is None or t < best[0]):
                    if ref is None:
                        ref = probe_reference(a, x, device=device)
                    check_accuracy(c, fn(x), ref)
            except Exception as exc:
                if not search_skips(exc, device, stage=stage):
                    raise RuntimeError(
                        f"candidate {c.key()} failed in the measured search on "
                        f"{device}: {exc!r}"
                    ) from exc
                measurements[c.key()] = math.inf
                failures[c.key()] = exc
                continue
            measurements[c.key()] = t
            if math.isinf(t):
                n_raced += 1
                continue
            if best is None or t < best[0]:
                best = (t, c, prep)
        if best is None:
            raise RuntimeError(
                f"measured search found no usable candidate for kind={kind!r} "
                f"k={kk} ({len(survivors)} survivors, {len(failures)} failed: "
                f"{ {key: repr(e) for key, e in failures.items()} })"
            )
        t_best, c_best, prep_best = best
        plan = Plan(
            fingerprint=fp,
            kind=kind,
            fmt=c_best.fmt,
            impl=c_best.impl,
            params=_plan_params(c_best),
            est_cost=costs[c_best],
            measured_s=t_best,
            n_candidates=len(cands),
            n_measured=len(survivors),
            k=kk,
            backend=backend,
            scale=scale,
            n_raced=n_raced,
            features=feats.to_dict(),
            mesh_shape=mesh_shape,
        )
        cache.put(plan)
        return cls(
            a, plan, prep_best, device=device, from_cache=False, features=feats,
            measurements=measurements, search_failures=failures, mesh=mesh, axis=axis,
        )

    @classmethod
    def from_candidate(
        cls,
        a: CSRMatrix,
        cand: Candidate,
        *,
        k: int | None = None,
        device: str | torch.device = "cuda",
        x_nnz: int | None = None,
    ) -> "SparseOperator":
        """Build with a forced candidate — no search, no cache.

        ``x_nnz=<bucket>`` pins for a sparse RHS (serve with
        ``apply_sparse``); ``spmspv`` candidates need it, and a dense
        candidate pinned so serves through its densify wrapper.
        """
        device = resolve(device)
        if x_nnz is not None and k is not None:
            raise ValueError("x_nnz= is mutually exclusive with k=")
        if cand.fmt == "spmspv" and x_nnz is None:
            raise ValueError("spmspv candidates need x_nnz= (the sparse-RHS nnz bucket)")
        if x_nnz is not None:
            kind, kk = "spmspv", max(int(x_nnz), 1)
        else:
            kk = 1 if k is None else int(k)
            kind = "spmv" if kk == 1 else "spmm"
        plan = Plan(
            fingerprint=fingerprint(a),
            kind=kind,
            fmt=cand.fmt,
            impl=cand.impl,
            params=_plan_params(cand),
            est_cost=0.0,
            measured_s=0.0,
            n_candidates=1,
            n_measured=0,
            k=kk,
            backend=backend_name(device),
            scale=[int(a.shape[0]), int(a.shape[1]), int(a.nnz)],
        )
        return cls(a, plan, prepare_cached(a, cand, device=device),
                   device=device, from_cache=False)

    @classmethod
    def build_multi(
        cls,
        a: CSRMatrix,
        *,
        ks: Iterable[int] = (1, 4, 16, 64),
        cache: PlanCache | None = None,
        **build_kwargs: Any,
    ) -> dict[int, "SparseOperator"]:
        """Tune one plan per k-bucket; returns ``{k: SparseOperator}`` — the
        serving engine's plan table (k=1 tunes SpMV, k>1 SpMM), all buckets
        in one plan cache.  Over a mesh the buckets share one placed
        operand per schedule (they differ only in the width of x)."""
        cache = default_cache() if cache is None else cache
        if build_kwargs.get("mesh") is not None:
            build_kwargs.setdefault("prep_cache", {})
        table: dict[int, SparseOperator] = {}
        for k in sorted({int(k) for k in ks}):
            if k < 1:
                raise ValueError(f"k-bucket must be >= 1, got {k}")
            table[k] = cls.build(a, k=None if k == 1 else k, cache=cache,
                                 **build_kwargs)
        return table

    @classmethod
    def build_predicted(
        cls,
        a: CSRMatrix,
        *,
        k: int | None = None,
        cache: PlanCache | None = None,
        radius: float | None = None,
        exclude: Iterable[str] = (),
        device: str | torch.device = "cuda",
    ) -> "SparseOperator":
        """A serve-now operator: no measured search.

        Resolution order: an exact plan-cache hit for this fingerprint,
        backend and scale; else :func:`~repro_torch.tune.predict.
        predict_candidate` (the nearest cached neighbour within ``radius``,
        else the byte model's argmin).  A predicted plan has
        ``measured_s == 0`` and ``predicted_from`` set (the neighbour's
        fingerprint or ``"byte_model"``), and is never persisted.
        ``exclude`` drops training fingerprints.  Single-device only, as in
        the JAX package: a mesh plan is a point measurement of its topology
        and is not predicted.

        One deviation from the JAX package: a predicted candidate was never
        measured, so before it is returned it runs once on the search's
        seeded probe and is held to :func:`check_accuracy` against the
        float64 product (:func:`probe_reference`).  A plain tier that fails
        is recorded in ``op.search_failures`` and passed over for the next
        candidate in byte-model order (a confident transfer that fails
        falls to that order too, and the plan then says ``byte_model``); a
        kernel that fails on a card ends the build, as in :meth:`build`
        (:func:`search_skips`).  ``op.check_s`` is the seconds the checks
        took, each candidate's preparation included; ``op.predicted`` the
        :class:`Prediction` served.
        """
        device = resolve(device)
        kind = "spmv" if k is None else "spmm"
        kk = 1 if k is None else int(k)
        fp = fingerprint(a)
        backend = backend_name(device)
        scale = [int(a.shape[0]), int(a.shape[1]), int(a.nnz)]
        cache = default_cache() if cache is None else cache
        plan = cache.get(fp, kind, kk, backend=backend, scale=scale)
        if plan is not None:
            return cls(a, plan, prepare_cached(a, plan.candidate, fp=fp, device=device),
                       device=device, from_cache=True)
        if device.type == "cuda":
            _build.ensure_built()
        feats = extract(a, k=kk)
        pred = predict_candidate(
            a, kind, kk, cache, feats=feats, backend=backend,
            exclude=set(exclude) | {fp},
            radius=PREDICT_RADIUS if radius is None else radius, device=device,
        )

        def order():  # the byte-model order is ranked only if needed
            yield pred.candidate
            for c in byte_model_order(a, feats, kind, kk, device=device):
                if c != pred.candidate:
                    yield c

        t0 = time.perf_counter()
        x = _dense_probe(a, kk, 0, device)
        ref = None
        failures: dict[str, Exception] = {}
        for cand in order():
            stage = "prepare"
            try:
                prep = prepare_cached(a, cand, fp=fp, device=device)
                stage = "run"
                fn = runner(a, cand, prep, k=kk)
                if ref is None:
                    ref = probe_reference(a, x, device=device)
                check_accuracy(cand, fn(x), ref)
            except Exception as exc:
                if not search_skips(exc, device, stage=stage):
                    raise RuntimeError(
                        f"predicted candidate {cand.key()} failed on {device}: {exc!r}"
                    ) from exc
                failures[cand.key()] = exc
                continue
            break
        else:
            raise RuntimeError(
                f"no candidate for kind={kind!r} k={kk} passed the accuracy check "
                f"({ {key: repr(e) for key, e in failures.items()} })"
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        check_s = time.perf_counter() - t0
        if cand != pred.candidate:
            pred = dataclasses.replace(pred, candidate=cand, source="byte_model",
                                       confident=False)
        plan = Plan(
            fingerprint=fp,
            kind=kind,
            fmt=cand.fmt,
            impl=cand.impl,
            params=_plan_params(cand),
            est_cost=estimate_cost(a, cand, feats, k=kk, on_cpu=device.type == "cpu"),
            measured_s=0.0,
            n_candidates=pred.n_neighbors,
            n_measured=0,
            k=kk,
            backend=backend,
            scale=scale,
            features=feats.to_dict(),
            predicted_from=pred.source,
        )
        op = cls(a, plan, prep, device=device, from_cache=False, features=feats,
                 search_failures=failures)
        op.predicted = pred
        op.check_s = check_s
        return op

    # -- persistent executables ---------------------------------------------
    def aot(self, *, donate_rhs: bool = False) -> Callable:
        """This operator's dispatch compiled into a persistent executable.

        On a card: a CUDA graph (``runtime.executable.aot_compile``) over
        exactly the plan's operand shape, (n,) for a k = 1 plan and (n, k)
        otherwise, with the prepared tensors captured in; a call copies x
        into the graph's input, replays, and returns a result that later
        calls leave alone.  On the CPU the bound runner runs eagerly.

        A sparse-RHS plan returns its bound runner, as the JAX package
        does: its host staging has sizes that depend on x.  A mesh plan
        returns its bound runner as it is, which places and copies across
        devices itself.

        ``donate_rhs=True`` keeps the JAX package's contract (the caller
        hands the operand over and must not reuse it) but changes nothing
        here: x is copied into the graph's own input either way, so both
        values return the same executable.
        """
        del donate_rhs  # see the docstring
        if self.plan.kind == "spmspv" or self.mesh is not None:
            return self._run
        n = self.shape[1]
        shape = (n,) if self.plan.k == 1 else (n, self.plan.k)
        fn = self._aot.get(shape)
        if fn is None:
            fn = self._aot[shape] = aot_compile(
                self._run, torch.zeros(shape, dtype=torch.float32, device=self.device))
        return fn

    # -- application --------------------------------------------------------
    def apply_sparse(self, indices, values) -> torch.Tensor:
        """y = A x for a sparse x given as sorted ``(indices, values)``.

        Only operators built with ``x_nnz=`` take sparse operands; the
        coordinates are validated (bounds, strictly increasing) and padded
        to the plan's bucket.  More nonzeros than the bucket is an error:
        build a wider bucket, or let the engine's ``submit_sparse`` pick it.
        """
        if self.plan.kind != "spmspv":
            raise ValueError(
                "apply_sparse needs an operator built for sparse RHS "
                "(SparseOperator.build(a, x_nnz=...)); this plan is kind="
                f"{self.plan.kind!r}.  For a dense x use op @ x."
            )
        n = self.shape[1]
        idx, val = kspmspv.validate_sparse_rhs(indices, values, n)
        return self._run(kspmspv.pad_sparse_rhs(idx, val, self.plan.k, n))

    def __matmul__(self, x) -> torch.Tensor:
        if isinstance(x, tuple):  # sparse RHS as (indices, values)
            return self.apply_sparse(*x)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)
        elif x.device != self.device:
            raise ValueError(f"x is on {x.device}, this operator on {self.device}")
        if self.plan.kind == "spmspv":
            # A dense x on a sparse-RHS plan (plan.k is an nnz bucket, not a
            # width): the CSR fallback.
            fn = spmv_csr if x.dim() == 1 else spmm_csr
            return fn(self._csr_fallback(), x, n_rows=self.shape[0])
        if x.dim() == 1:
            if self.plan.k == 1:
                return self._run(x)
            return spmv_csr(self._csr_fallback(), x, n_rows=self.shape[0])
        if self.plan.k > 1:
            return self._run(x)
        # An SpMV-tuned operator applied to a matrix: CSR fallback.
        return spmm_csr(self._csr_fallback(), x, n_rows=self.shape[0])

    def matvec(self, x) -> torch.Tensor:
        """``self @ x``, the JAX package's name for it."""
        return self @ x

    def _csr_fallback(self) -> dict:
        if self._csr_dev is None:
            self._csr_dev = csr_prepare(self.a, self.device)
        return self._csr_dev

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        src = "cache" if self.from_cache else "search"
        where = f"device={self.device}" if self.mesh is None else repr(self.mesh)
        return (
            f"SparseOperator({self.shape[0]}x{self.shape[1]}, nnz={self.a.nnz}, "
            f"plan={self.plan.candidate.key()}, {where}, from {src})"
        )

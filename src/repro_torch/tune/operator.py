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
"""
from __future__ import annotations

import collections
import hashlib
import math
import os
import threading
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.core.device import backend_name, resolve
from repro_torch.core.formats import CSRMatrix, bcsr_from_csr, sell_from_csr
from repro_torch.core.spmv import (
    csr_bind,
    csr_prepare,
    spmm_bcsr_dense,
    spmm_csr,
    spmm_sell,
    spmv_csr,
    spmv_sell,
)
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import spmspv as kspmspv

from .candidates import (
    DEFAULT_PRUNE_FACTOR,
    Candidate,
    enumerate_candidates,
    estimate_cost,
    prune,
)
from .features import MatrixFeatures, extract
from .plan import Plan, PlanCache, default_cache, fingerprint
from .timing import RACE_FACTOR, time_fn

__all__ = [
    "NoSpMMTier",
    "SparseOperator",
    "PrepCache",
    "prep_nbytes",
    "prepare",
    "prepare_cached",
    "runner",
    "search_skips",
    "sparse_rhs_runner",
]


class NoSpMMTier(ValueError):
    """Raised at bind time by a tier that serves k = 1 only, asked for k > 1.

    The one failure the measured search on a card may record and pass over:
    the SpMM space enumerates column-slab candidates that cannot serve it.
    """


# ---------------------------------------------------------------------------
# Prepare + dispatch per candidate
# ---------------------------------------------------------------------------
def prepare(a: CSRMatrix, cand: Candidate, *, device) -> dict[str, Any]:
    """Host-side format construction for one candidate, placed on ``device``."""
    p = cand.param_dict
    if cand.fmt == "csr":
        return {"dev": csr_prepare(a, device)}
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
    """Bytes pinned by a prepared format dict (recursive over dicts/lists)."""
    if isinstance(obj, dict):
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
                self._entries.move_to_end(key)
                return prep
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


_PREP_MEMO = PrepCache()


def _value_digest(a: CSRMatrix) -> str:
    return hashlib.sha256(np.ascontiguousarray(a.data).tobytes()).hexdigest()[:16]


def prepare_cached(
    a: CSRMatrix, cand: Candidate, *, device, fp: str | None = None
) -> dict[str, Any]:
    """:func:`prepare`, memoized on (fingerprint, value digest, candidate,
    device) in the process-wide byte-budgeted :class:`PrepCache`."""
    device = torch.device(device)
    key = (fp or fingerprint(a), _value_digest(a), cand.key(), str(device))
    return _PREP_MEMO.get_or_build(key, lambda: prepare(a, cand, device=device))


def runner(
    a: CSRMatrix, cand: Candidate, prep: dict[str, Any], *, k: int = 1
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a candidate + prepared tensors into ``fn(x) -> y``.

    k == 1 binds SpMV (x is (n,)); k > 1 binds SpMM (x is (n, k)).  The
    SELL kernel and both column-slab tiers serve k = 1 only and raise
    :class:`NoSpMMTier` at bind time for k > 1.
    """
    m, n = a.shape
    if cand.fmt == "spmspv":
        raise ValueError(
            "spmspv candidates take a sparse operand — bind them through "
            "sparse_rhs_runner(a, cand, prep, x_nnz=...) instead of runner()"
        )
    if cand.fmt == "csr":
        return csr_bind(prep["dev"], n_rows=m, k=k)

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


def search_skips(exc: Exception, device: torch.device) -> bool:
    """Whether the measured search records ``exc`` and passes over the
    candidate that raised it.  On the CPU any failure only disqualifies its
    candidate.  On a card only :class:`NoSpMMTier` does: a kernel that fails
    to launch (or a sticky CUDA fault, which would poison every candidate
    timed after it) must end the build, not hand the work to a plain tier."""
    return device.type != "cuda" or isinstance(exc, NoSpMMTier)


def _plan_params(cand: Candidate) -> dict[str, Any]:
    return {kp: list(v) if isinstance(v, tuple) else v for kp, v in cand.params}


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class SparseOperator:
    """An autotuned sparse linear operator on one device: ``y = op @ x``."""

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
    ):
        self.a = a
        self.plan = plan
        self.shape = a.shape
        self.device = device
        self.from_cache = from_cache  # True -> the measured search was skipped
        self.features = features
        self.measurements = dict(measurements or {})  # candidate key -> seconds
        # Candidate key -> the exception that disqualified it in the search.
        self.search_failures = dict(search_failures or {})
        self._prep = prep
        if plan.kind == "spmspv":
            # plan.k carries the x-nnz bucket; the runner takes (xi, xv).
            self._run = sparse_rhs_runner(a, plan.candidate, prep, x_nnz=plan.k,
                                          device=device)
        else:
            self._run = runner(a, plan.candidate, prep, k=plan.k)
        self._csr_dev: dict | None = prep.get("dev")  # fallback path, lazy

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
        seed: int = 0,
        race: bool = True,
        device: str | torch.device = "cuda",
        x_nnz: int | None = None,
    ) -> "SparseOperator":
        """Autotune (or fetch the cached plan for) this matrix.

        k=None tunes SpMV; k=<width> tunes SpMM with an (n, k) operand.
        ``x_nnz=<bucket>`` tunes for a *sparse* x instead (kind="spmspv"):
        the dense SpMV tiers, each timed through its densify wrapper, and
        the bucket SpMSpV tier, all on one random sorted x of ``x_nnz``
        nonzeros.  ``plan.k`` stores the bucket, so the cache keys sparse
        plans per bucket as it keys SpMM plans per k.  Serve with
        ``op.apply_sparse(indices, values)`` or ``op @ (indices, values)``.
        Mutually exclusive with ``k``.
        ``candidates`` overrides enumeration (pruning still applies);
        ``force_search`` ignores a cached plan.  Plans taken on another
        backend or at another (m, n, nnz) are misses.

        ``race`` (default on) times survivors cheapest-estimate-first and
        abandons one whose first steady-state rep exceeds ``RACE_FACTOR`` x
        the current best median (confirmed by one more rep).

        A candidate that fails to prepare or run is recorded in
        ``op.search_failures`` and loses; the others still compete.  On a
        card only a k = 1 tier asked for k > 1 loses so (see
        :func:`search_skips`): the kernels are built before the search, and
        any other failure, a refused launch included, raises.
        """
        device = resolve(device)
        kind = "spmv" if k is None else "spmm"
        kk = 1 if k is None else int(k)
        if x_nnz is not None:
            if k is not None:
                raise ValueError("x_nnz= (sparse RHS) is mutually exclusive with k=")
            kind = "spmspv"
            kk = max(int(x_nnz), 1)  # plan.k carries the x-nnz bucket
        sparse_kind = kind == "spmspv"
        fp = fingerprint(a)
        backend = backend_name(device)
        scale = [int(a.shape[0]), int(a.shape[1]), int(a.nnz)]
        cache = default_cache() if cache is None else cache
        if not force_search:
            plan = cache.get(fp, kind, kk, backend=backend, scale=scale)
            if plan is not None:
                return cls(
                    a, plan, prepare_cached(a, plan.candidate, fp=fp, device=device),
                    device=device, from_cache=True,
                )
        if device.type == "cuda":
            _build.ensure_built()

        width = 1 if sparse_kind else kk  # the dense operand's width
        feats = extract(a, k=width, x_nnz=kk if sparse_kind else None)
        cands = (
            list(candidates)
            if candidates is not None
            else enumerate_candidates(feats, kind, k=width)
        )
        on_cpu = device.type == "cpu"
        costs = {
            c: estimate_cost(a, c, feats, k=width, on_cpu=on_cpu,
                             sparse_rhs=sparse_kind)
            for c in cands
        }
        survivors = sorted(prune(costs, factor=prune_factor), key=costs.get)

        rng = np.random.default_rng(seed)
        if sparse_kind:
            # One random sorted sparse x probes every survivor, as host
            # arrays: the spmspv runners pick the work bucket on the host.
            n = a.shape[1]
            nx = min(kk, n)
            idx = np.sort(rng.choice(n, size=nx, replace=False)).astype(np.int64)
            val = rng.standard_normal(nx).astype(np.float32)
            x = kspmspv.pad_sparse_rhs(idx, val, kk, n)
        else:
            shape = (a.shape[1],) if kk == 1 else (a.shape[1], kk)
            x = torch.as_tensor(
                rng.standard_normal(shape).astype(np.float32), device=device
            )

        measurements: dict[str, float] = {}
        failures: dict[str, Exception] = {}
        best: tuple[float, Candidate, dict] | None = None
        n_raced = 0
        # The first candidate (no best yet) gets the same warmup as the
        # raced ones, so its lone first rep never eats lazy setup.
        warmup_eff = max(warmup, 1) if race else warmup
        for c in survivors:
            try:
                prep = prepare_cached(a, c, fp=fp, device=device)
                if sparse_kind:
                    fn = sparse_rhs_runner(a, c, prep, x_nnz=kk, device=device)
                else:
                    fn = runner(a, c, prep, k=kk)
                abort = RACE_FACTOR * best[0] if (race and best is not None) else None
                t = time_fn(fn, x, warmup=warmup_eff, timed=timed, abort_above=abort,
                            device=device)
            except Exception as exc:
                if not search_skips(exc, device):
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
        )
        cache.put(plan)
        return cls(
            a, plan, prep_best, device=device, from_cache=False, features=feats,
            measurements=measurements, search_failures=failures,
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
        in one plan cache."""
        cache = default_cache() if cache is None else cache
        table: dict[int, SparseOperator] = {}
        for k in sorted({int(k) for k in ks}):
            if k < 1:
                raise ValueError(f"k-bucket must be >= 1, got {k}")
            table[k] = cls.build(a, k=None if k == 1 else k, cache=cache,
                                 **build_kwargs)
        return table

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

    def _csr_fallback(self) -> dict:
        if self._csr_dev is None:
            self._csr_dev = csr_prepare(self.a, self.device)
        return self._csr_dev

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        src = "cache" if self.from_cache else "search"
        return (
            f"SparseOperator({self.shape[0]}x{self.shape[1]}, nnz={self.a.nnz}, "
            f"plan={self.plan.candidate.key()}, device={self.device}, from {src})"
        )

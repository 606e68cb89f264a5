"""SparseFleet: multi-tenant sparse serving with next to no cold start.

One process, one device, many matrices.  ``SparseEngine`` serves one
fingerprint; the fleet adds what surrounds it:

**Transfer-tuned admission.**  ``add_tenant`` builds each k-bucket's plan
with :meth:`repro_torch.tune.SparseOperator.build_predicted`: an exact
plan-cache hit, else the nearest cached neighbour's plan, else the byte
model's argmin, each predicted plan held to the float64 accuracy check
first.  The first request is served after format preparation, never after
a measured search.  A tenant with a predicted bucket is queued for a
**background retune**: a worker thread runs the measured search
(``build_multi``, which persists the winners, so the training set grows),
prewarms the new per-bucket closures and stages them with
:meth:`SparseEngine.hot_swap`.  The serving thread adopts the table at its
next dispatch; batches in flight retire on the old plan, bit for bit.

On a card the worker builds, captures (each new closure's CUDA graph,
``runtime.executable``) and prewarms on a CUDA stream of its own, ordered
after the serving stream's work so far, and waits for that stream before
it stages the table, so no prepared tensor, slab or graph buffer is still
being written when the serving stream first reads it.  The new tensors
(prepared dicts, each closure's slab and its graph's static outputs) are
then marked as used by the serving stream (``record_stream``): the
allocator keeps their memory from the worker's stream until serving
batches that may read them are done.  The search's CUDA-event timings run while serving
batches share the card, and its host work shares the interpreter with the
serving thread.

**Residency.**  Prepared tensors are the fleet's device-memory spend.
``budget_bytes`` (default ``$REPRO_TORCH_FLEET_BUDGET_BYTES`` or 512 MiB)
bounds them: to admit a tenant that does not fit, idle tenants are evicted,
lowest decayed traffic first, their engines dropped and their prepared
dicts purged from the process-wide memo.  An evicted tenant is re-admitted
on its next ``submit``, an exact cache hit once its retune has landed.  The
budget counts prepared bytes only: each resident engine also holds one
``(n, k)`` float32 slab per bucket wider than 1 and, on a card, the graph
pool its buckets share (each bucket's static output, and intermediates as
large as the largest bucket's), which it does not see.

**Scheduling.**  ``step()`` serves every tenant with work, deadline-first
(the oldest pending request's ``t_submit + max_wait_s``), with a rotating
round-robin start for ties; each engine keeps its own ``max_wait_s`` gate.

**Overload.**  Per-tenant queue caps (``max_queue``, ``overload_policy``),
per-tenant token buckets (``tenant_rate``/``tenant_burst``: a greedy
tenant's burst fails fast with :class:`OverloadError`), a bounded retune
queue that coalesces requests per tenant, a per-tenant circuit breaker
(:class:`CircuitOpenError`), and an optional shared
:class:`BrownoutController` that only the fleet updates (from the largest
pressure of its engines): engines read it, the retune worker defers
searches while it is not HEALTHY, and eviction tightens to
``brownout_budget_frac`` of the budget.

    fleet = SparseFleet(budget_bytes=1 << 29)        # device="cuda"
    fleet.add_tenant("fem", a_fem, max_wait_s=5e-3)
    req = fleet.submit("fem", x)                     # the predicted plan
    fleet.step(); req.result()
    fleet.wait_retunes()                             # measured plans swap in
    fleet.stats().summary()

``Tenant`` and the breaker read the clock as ``time.perf_counter()``
through this module's ``time``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.core.formats import CSRMatrix
from repro_torch.runtime.engine import K_BUCKETS, EngineRequest, SparseEngine
from repro_torch.runtime.executable import GraphPool
from repro_torch.runtime.faults import FaultPlan, active_plan
from repro_torch.runtime.overload import (
    HEALTHY,
    BrownoutController,
    BrownoutTransition,
    OverloadError,
    TokenBucket,
)
from repro_torch.runtime.supervisor import CircuitOpenError, Supervisor
from repro_torch.tune import (
    PlanCache,
    SparseOperator,
    default_cache,
    evict_prepared,
    fingerprint,
    prep_memo_stats,
    prep_nbytes,
)

__all__ = [
    "SparseFleet",
    "FleetStats",
    "Tenant",
    "TRAFFIC_HALFLIFE_S",
    "CircuitOpenError",
    "OverloadError",
    "TokenBucket",
    "BrownoutController",
]

_ENV_BUDGET = "REPRO_TORCH_FLEET_BUDGET_BYTES"
_DEFAULT_BUDGET = 512 * 1024 * 1024

# A tenant's eviction weight is a request counter decayed by
# 2^(-dt / half_life): recent traffic dominates, and a zero-traffic tenant
# is always the first evicted.
TRAFFIC_HALFLIFE_S = 30.0


def _table_bytes(ops: dict[int, SparseOperator]) -> int:
    """Prepared bytes of a plan table; buckets whose plans picked the same
    candidate share one prepared dict through the memo and count once."""
    seen: set[int] = set()
    total = 0
    for op in ops.values():
        if id(op._prep) not in seen:
            seen.add(id(op._prep))
            total += prep_nbytes(op._prep)
    return total


def _device_tensors(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a prepared dict (host CSR arrays are not tensors)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _device_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _device_tensors(v)


@dataclasses.dataclass
class Tenant:
    """One fingerprint's residency record in the fleet.

    ``engine is None`` means evicted: the host CSR and the plan-cache
    entries survive, the prepared tensors and closures do not.  ``weight``
    is the decayed traffic counter; ``nbytes`` the prepared bytes the
    tenant holds while resident.
    """

    name: str
    a: CSRMatrix
    fp: str
    max_wait_s: float | None = None
    engine: SparseEngine | None = None
    nbytes: int = 0
    weight: float = 0.0
    t_weight: float = 0.0  # perf_counter of the last decay
    admitted_from: dict[int, str] = dataclasses.field(default_factory=dict)
    n_admissions: int = 0
    n_evictions: int = 0
    retuned: bool = False
    # Circuit breaker: the perf_counter time the quarantine lifts (0 =
    # closed).  A quarantined tenant's submits raise CircuitOpenError and
    # step() skips it.
    quarantined_until: float = 0.0
    n_quarantines: int = 0
    # Fair share: a token bucket (None = unlimited) consulted at submit.
    # It survives eviction: a rate limit belongs to the tenant.
    bucket: TokenBucket | None = None

    @property
    def quarantined(self) -> bool:
        return time.perf_counter() < self.quarantined_until

    def touch(self, now: float, add: float = 1.0) -> None:
        self.decay(now)
        self.weight += add

    def decay(self, now: float) -> float:
        dt = max(0.0, now - self.t_weight)
        if dt > 0.0 and self.weight > 0.0:
            self.weight *= 2.0 ** (-dt / TRAFFIC_HALFLIFE_S)
        self.t_weight = now
        return self.weight

    @property
    def resident(self) -> bool:
        return self.engine is not None

    @property
    def busy(self) -> bool:
        """Work the fleet must not discard: queued or in-flight requests."""
        return self.engine is not None and (
            self.engine.pending > 0 or self.engine.in_flight > 0
        )


@dataclasses.dataclass
class FleetStats:
    """Fleet-wide counters; per-tenant engine stats join in ``summary``."""

    admissions: int = 0
    cache_admissions: int = 0  # every bucket an exact plan-cache hit
    predicted_admissions: int = 0  # >= 1 bucket transferred or byte model
    transferred_buckets: int = 0  # confident nearest-neighbour buckets
    byte_model_buckets: int = 0  # fallback-prior buckets
    evictions: int = 0
    bytes_evicted: int = 0
    reactivations: int = 0
    over_budget_admissions: int = 0  # admitted with nothing left to evict
    retunes_queued: int = 0
    retunes_done: int = 0
    retunes_failed: int = 0  # every retry spent; the predicted plan serves on
    retune_errors: int = 0  # every retune attempt that raised
    last_retune_error: str | None = None
    quarantines: int = 0  # circuit-breaker openings across all tenants
    rate_limited: int = 0  # token-bucket refusals at submit
    retunes_coalesced: int = 0  # duplicate requests folded into a queued one
    retunes_dropped: int = 0  # the bounded retune queue was full
    retunes_deferred: int = 0  # browned out: parked, re-queued on recovery
    _fleet: Any = dataclasses.field(default=None, repr=False, compare=False)

    def summary(self) -> dict[str, Any]:
        out = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if not f.name.startswith("_")
        }
        fleet = self._fleet
        if fleet is not None:
            out["resident_bytes"] = fleet.resident_bytes
            out["budget_bytes"] = fleet.budget_bytes
            engines = [t.engine for t in fleet._tenants.values() if t.engine is not None]
            out["rejected"] = sum(e.stats.rejected for e in engines)
            out["shed_oldest"] = sum(e.stats.shed_oldest for e in engines)
            out["shed_deadline"] = sum(e.stats.shed_deadline for e in engines)
            if fleet._brownout is not None:
                out["brownout"] = fleet._brownout.summary()
            out["swaps_applied"] = sum(e.swaps_applied for e in engines)
            out["tenants"] = {
                t.name: {
                    "resident": t.resident,
                    "weight": round(t.decay(time.perf_counter()), 4),
                    "nbytes": t.nbytes if t.resident else 0,
                    "quarantined": t.quarantined,
                    "quarantines": t.n_quarantines,
                    "admitted_from": dict(sorted(t.admitted_from.items())),
                    "retuned": t.retuned,
                    "evictions": t.n_evictions,
                    **({"engine": t.engine.stats.summary()} if t.engine is not None
                       else {}),
                }
                for t in fleet._tenants.values()
            }
        out["prep_memo"] = prep_memo_stats()
        return out


class SparseFleet:
    """Multi-tenant serving: many fingerprints on one device.

    ``ks`` is the shared k-bucket ladder; ``cache`` the shared plan cache
    (the transfer predictor's training set and the warm-restart store);
    ``budget_bytes`` bounds resident prepared bytes across tenants;
    ``retune=False`` turns the background measured search off (predicted
    plans then serve for good); ``max_wait_s`` is the default per-tenant
    SLO.  ``device`` is where every tenant serves: ``"cuda"`` unless the
    caller passes ``"cpu"``; with no card visible a CUDA fleet raises.
    """

    def __init__(
        self,
        *,
        ks: Sequence[int] = K_BUCKETS,
        cache: PlanCache | None = None,
        budget_bytes: int | None = None,
        max_wait_s: float | None = None,
        async_depth: int = 2,
        retune: bool = True,
        retune_kwargs: dict[str, Any] | None = None,
        retune_max_retries: int = 2,
        retune_backoff_s: float = 0.05,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 5.0,
        supervisor_kwargs: dict[str, Any] | None = None,
        nan_guard: bool = False,
        faults: FaultPlan | None = None,
        max_queue: int | None = None,
        overload_policy: str = "reject",
        block_timeout_s: float = 1.0,
        shed_after_s: float | None = None,
        tenant_rate: float | None = None,
        tenant_burst: float | None = None,
        brownout: BrownoutController | None = None,
        brownout_budget_frac: float = 0.5,
        retune_queue_max: int = 32,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve(device)
        self.ks = tuple(sorted({int(k) for k in ks}))
        self.cache = default_cache() if cache is None else cache
        if budget_bytes is None:
            budget_bytes = int(os.environ.get(_ENV_BUDGET, _DEFAULT_BUDGET))
        self.budget_bytes = int(budget_bytes)
        self.default_max_wait_s = max_wait_s
        self.async_depth = int(async_depth)
        self.retune_default = bool(retune)
        self.retune_kwargs = dict(retune_kwargs or {})
        self.retune_max_retries = max(0, int(retune_max_retries))
        self.retune_backoff_s = float(retune_backoff_s)
        # After breaker_threshold consecutive abandoned batches a tenant is
        # quarantined for breaker_reset_s.
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_reset_s = float(breaker_reset_s)
        self.supervisor_kwargs = dict(supervisor_kwargs or {})
        self.nan_guard = bool(nan_guard)
        self.faults = faults if faults is not None else active_plan()
        self.max_queue = max_queue
        self.overload_policy = overload_policy
        self.block_timeout_s = float(block_timeout_s)
        self.shed_after_s = shed_after_s
        self.tenant_rate = tenant_rate
        self.tenant_burst = tenant_burst
        self._brownout = brownout
        self.brownout_budget_frac = float(brownout_budget_frac)
        self.supervisor = Supervisor(**self.supervisor_kwargs)
        if self._brownout is not None:
            self._brownout.add_listener(self._on_brownout)
        self._tenants: dict[str, Tenant] = {}
        self._rr = 0  # rotating round-robin start for equal-deadline ties
        self.stats_fleet = FleetStats(_fleet=self)
        # Bounded retune queue: a tenant already queued coalesces; overflow
        # drops the request (counted: a lost retune pins the predicted
        # plan, never correctness).
        self._retune_q: queue.Queue = queue.Queue(maxsize=max(1, int(retune_queue_max)))
        self._retune_pending: set[str] = set()
        self._deferred_retunes: list[str] = []
        self._retune_thread: threading.Thread | None = None
        self._retune_lock = threading.Lock()  # guards thread start + counters
        self._side_stream: torch.cuda.Stream | None = None  # the worker's own
        self._closed = False

    # -- residency ----------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        return sum(t.nbytes for t in self._tenants.values() if t.resident)

    @property
    def tenants(self) -> dict[str, Tenant]:
        return dict(self._tenants)

    def _make_room(self, incoming: int) -> None:
        """Evict idle tenants (lowest decayed traffic first) until
        ``incoming`` bytes fit the budget.  A tenant with queued or
        in-flight work is never evicted; with nothing evictable left the
        admission goes over budget (counted): serving beats refusing."""
        now = time.perf_counter()
        budget = self.budget_bytes
        if self._brownout is not None and self._brownout.state != HEALTHY:
            budget = int(budget * self.brownout_budget_frac)
        while self.resident_bytes + incoming > budget:
            victims = [t for t in self._tenants.values() if t.resident and not t.busy]
            if not victims:
                self.stats_fleet.over_budget_admissions += 1
                return
            self._evict(min(victims, key=lambda t: t.decay(now)))

    def _evict(self, tenant: Tenant) -> int:
        """Drop a tenant's engine, closures and prepared dicts.  The host
        CSR and the plan cache survive, so reactivation costs a re-prepare,
        never a re-search."""
        if tenant.engine is None or tenant.busy:
            raise RuntimeError(f"tenant {tenant.name!r} is not resident and idle")
        freed = tenant.nbytes
        tenant.engine.close(drain=False)  # idle: stops its repair thread only
        tenant.engine = None
        tenant.n_evictions += 1
        evict_prepared(tenant.fp)  # release the memo's share
        self.stats_fleet.evictions += 1
        self.stats_fleet.bytes_evicted += freed
        return freed

    # -- admission ----------------------------------------------------------
    def add_tenant(
        self,
        name: str,
        a: CSRMatrix,
        *,
        max_wait_s: float | None = None,
        retune: bool | None = None,
        rate: float | None = None,
        burst: float | None = None,
    ) -> Tenant:
        """Admit a matrix under ``name``; ready to serve on return.

        The plan table comes from ``build_predicted``, so no measured
        search runs here; a tenant with a predicted bucket is queued for
        the background retune (unless ``retune=False`` here or fleet-wide).
        ``rate``/``burst`` (requests/s, token cap; default the fleet's
        ``tenant_rate``/``tenant_burst``, burst 2 x rate) arm the tenant's
        token bucket.
        """
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        rate = self.tenant_rate if rate is None else rate
        bucket = None
        if rate is not None:
            if burst is None:
                burst = self.tenant_burst if self.tenant_burst is not None else 2.0 * rate
            bucket = TokenBucket(rate, burst)
        tenant = Tenant(
            name=name,
            a=a,
            fp=fingerprint(a),
            max_wait_s=self.default_max_wait_s if max_wait_s is None else max_wait_s,
            bucket=bucket,
        )
        self._tenants[name] = tenant
        self._admit(tenant, retune=retune)
        return tenant

    def _admit(self, tenant: Tenant, *, retune: bool | None = None) -> None:
        ops: dict[int, SparseOperator] = {}
        for k in self.ks:
            op = ops[k] = SparseOperator.build_predicted(
                tenant.a, k=None if k == 1 else k, cache=self.cache, device=self.device
            )
            if op.from_cache:
                tenant.admitted_from[k] = "cache"
            else:
                pred = op.predicted
                tenant.admitted_from[k] = pred.source
                if pred.confident:
                    self.stats_fleet.transferred_buckets += 1
                else:
                    self.stats_fleet.byte_model_buckets += 1
        nbytes = _table_bytes(ops)
        self._make_room(nbytes)
        tenant.engine = SparseEngine(
            tenant.a,
            ks=self.ks,
            ops=ops,
            device=self.device,
            max_wait_s=tenant.max_wait_s,
            async_depth=self.async_depth,
            name=tenant.name,
            # One supervisor per tenant: failures and demotions stay
            # attributed per tenant.
            supervisor=Supervisor(**self.supervisor_kwargs),
            faults=self.faults,
            nan_guard=self.nan_guard,
            max_queue=self.max_queue,
            overload_policy=self.overload_policy,
            block_timeout_s=self.block_timeout_s,
            shed_after_s=self.shed_after_s,
            # The engine reads the fleet's controller but never updates
            # it: only fleet-wide pressure (step()) may move the state.
            brownout=self._brownout,
            brownout_update=False,
        )
        tenant.nbytes = nbytes
        tenant.n_admissions += 1
        self.stats_fleet.admissions += 1
        if all(op.from_cache for op in ops.values()):
            self.stats_fleet.cache_admissions += 1
        else:
            self.stats_fleet.predicted_admissions += 1
            if self.retune_default if retune is None else retune:
                self._queue_retune(tenant.name)

    # -- background retune --------------------------------------------------
    def _queue_retune(self, name: str) -> None:
        """Enqueue a measured search for ``name``, bounded and coalesced.
        While browned out the request is parked instead, and recovery
        re-queues it."""
        if self._brownout is not None and self._brownout.state != HEALTHY:
            with self._retune_lock:
                if name not in self._deferred_retunes and name not in self._retune_pending:
                    self._deferred_retunes.append(name)
                    self.stats_fleet.retunes_deferred += 1
            return
        with self._retune_lock:
            if name in self._retune_pending:
                self.stats_fleet.retunes_coalesced += 1
                return
            try:
                self._retune_q.put_nowait(name)
            except queue.Full:
                self.stats_fleet.retunes_dropped += 1
                return
            self._retune_pending.add(name)
            self.stats_fleet.retunes_queued += 1
            if self._retune_thread is None:
                self._retune_thread = threading.Thread(
                    target=self._retune_worker, name="fleet-retune", daemon=True
                )
                self._retune_thread.start()

    def _on_brownout(self, tr: BrownoutTransition) -> None:
        """Record the transition on the fleet's supervisor; on recovery to
        HEALTHY re-queue every deferred retune."""
        self.supervisor.record("brownout", frm=tr.frm, to=tr.to,
                               pressure=round(tr.pressure, 4))
        if tr.to == HEALTHY:
            with self._retune_lock:
                deferred, self._deferred_retunes = self._deferred_retunes, []
            for name in deferred:
                self._queue_retune(name)

    def _retune_worker(self) -> None:
        while True:
            name = self._retune_q.get()
            if name is None:  # close() sentinel
                self._retune_q.task_done()
                return
            with self._retune_lock:
                # Unpend before running: a retune requested mid-search is new
                # information (the cache just grew) and re-queues.
                self._retune_pending.discard(name)
            if self._brownout is not None and self._brownout.state != HEALTHY:
                with self._retune_lock:
                    if name not in self._deferred_retunes:
                        self._deferred_retunes.append(name)
                        self.stats_fleet.retunes_deferred += 1
                self._retune_q.task_done()
                continue
            try:
                # Capped-backoff retry: a transient failure must not pin the
                # predicted plan for good; only exhaustion marks it failed.
                for attempt in range(self.retune_max_retries + 1):
                    try:
                        self._retune_one(name)
                        self.stats_fleet.retunes_done += 1
                        break
                    except Exception as exc:
                        self.stats_fleet.retune_errors += 1
                        self.stats_fleet.last_retune_error = f"{name}: {exc!r}"
                        if attempt >= self.retune_max_retries:
                            self.stats_fleet.retunes_failed += 1
                        else:
                            time.sleep(min(1.0, self.retune_backoff_s * 2.0 ** attempt))
            finally:
                self._retune_q.task_done()

    @contextlib.contextmanager
    def _worker_stream(self, serving: torch.cuda.Stream | None):
        """On a card: the worker's own stream, made current and ordered
        after the serving stream's work so far.  On the CPU: nothing."""
        if self.device.type != "cuda":
            yield None
            return
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        if serving is not None:
            side.wait_stream(serving)
        with torch.cuda.device(self.device), torch.cuda.stream(side):
            yield side

    def _retune_one(self, name: str) -> None:
        """The measured search for one tenant, off the serving thread.

        ``build_multi`` per bucket (each winning plan persisted), each new
        closure captured and prewarmed once on a zero batch, then the table
        staged with ``hot_swap``.  On a card all of it runs on the worker's
        stream, which is waited for before the swap; the new tensors are
        marked as used by the engine's stream.  A tenant evicted meanwhile is
        skipped: its cached plans make its reactivation an exact hit.
        """
        tenant = self._tenants.get(name)
        if tenant is None:
            return
        if self.faults is not None:
            self.faults.fire("fleet.retune", tenant=name)
        eng = tenant.engine
        with self._worker_stream(eng._stream if eng is not None else None) as side:
            ops = SparseOperator.build_multi(tenant.a, ks=self.ks, cache=self.cache,
                                             device=self.device, **self.retune_kwargs)
            eng = tenant.engine
            if eng is None:
                return
            zero = torch.zeros((tenant.a.shape[1],), dtype=torch.float32,
                               device=self.device)
            execs: dict[int, Any] = {}
            # the new closures' graphs share a pool of their own: they are
            # prewarmed here while the engine replays its graphs
            pool = GraphPool(self.device) if self.device.type == "cuda" else None
            for k in self.ks:
                fn = execs[k] = eng._make_exec(k, ops[k], pool=pool)
                fn(*([zero] * k))
            if side is not None:
                done = torch.cuda.Event()
                done.record(side)
                done.synchronize()
                for t in _device_tensors([op._prep for op in ops.values()]
                                         + [getattr(fn, "buffers", None)
                                            or getattr(fn, "slab", None)
                                            for fn in execs.values()]):
                    t.record_stream(eng._stream)
        eng.hot_swap(ops, execs=execs)
        tenant.nbytes = _table_bytes(ops)
        tenant.retuned = True

    def retune(self, name: str) -> None:
        """Queue a background measured search + hot swap for ``name``."""
        if name not in self._tenants:
            raise KeyError(name)
        self._queue_retune(name)

    def wait_retunes(self, timeout: float | None = None) -> bool:
        """Block until every queued retune finished; False on timeout."""
        deadline = None if timeout is None else time.perf_counter() + float(timeout)
        while self._retune_q.unfinished_tasks:
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self) -> None:
        """Stop the retune worker (after its queued work) and every resident
        tenant's repair thread.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._retune_thread is not None:
            self._retune_q.put(None)
            self._retune_thread.join()
            self._retune_thread = None
        for t in self._tenants.values():
            if t.engine is not None:
                t.engine._repair_stop.set()

    # -- serving ------------------------------------------------------------
    def submit(self, name: str, x: torch.Tensor | np.ndarray) -> EngineRequest:
        """Enqueue y = A_name @ x; an evicted tenant is re-admitted first.

        A quarantined tenant raises :class:`CircuitOpenError` until its
        cooldown lapses; a tenant whose token bucket is dry raises
        :class:`OverloadError`.
        """
        tenant = self._tenants[name]
        if tenant.quarantined:
            remaining = tenant.quarantined_until - time.perf_counter()
            raise CircuitOpenError(
                f"tenant {name!r} is quarantined for another {remaining:.3f}s "
                f"({tenant.n_quarantines} quarantines so far); resubmit after "
                "the cooldown"
            )
        bucket = tenant.bucket
        if bucket is not None and not bucket.try_take():
            self.stats_fleet.rate_limited += 1
            raise OverloadError(
                f"tenant {name!r} rate-limited: token bucket dry (rate="
                f"{bucket.rate:g}/s, burst={bucket.burst:g}); the burst fails "
                "fast instead of consuming the shared queue budget"
            )
        tenant.touch(time.perf_counter())
        if tenant.engine is None:
            self._admit(tenant)
            self.stats_fleet.reactivations += 1
        return tenant.engine.submit(x)

    def step(self) -> int:
        """One scheduling pass; returns #requests dispatched.

        Tenants with work are served deadline-first (oldest request's
        ``t_submit + max_wait_s``; no SLO sorts last); the scan start
        rotates so equal deadlines share the device.  Each engine keeps its
        own ``max_wait_s`` gate.
        """
        if self._brownout is not None:
            # The fleet is the one writer of the shared controller; update
            # before the ready check so an idle fleet still recovers.
            self._brownout.update(self._overload_pressure())
        ready = [
            t for t in self._tenants.values()
            if t.engine is not None and not t.quarantined
            and (t.engine.pending > 0 or t.engine.in_flight > 0)
        ]
        if not ready:
            return 0
        self._rr = (self._rr + 1) % len(ready)
        ready = ready[self._rr:] + ready[: self._rr]

        def deadline(t: Tenant) -> float:
            if t.engine.pending == 0:
                return float("inf")  # retire-only visit: after dispatches
            slo = t.max_wait_s if t.max_wait_s is not None else float("inf")
            return t.engine._queue[0].t_submit + slo

        served = 0
        for tenant in sorted(ready, key=deadline):  # stable: keeps RR ties
            served += tenant.engine.step()
            self._check_breaker(tenant)
        return served

    def _overload_pressure(self) -> float:
        """Fleet-wide pressure: the largest of the resident engines'
        (queue fill, oldest age), since they share the device."""
        return max(
            (t.engine._overload_pressure() for t in self._tenants.values()
             if t.engine is not None),
            default=0.0,
        )

    def _check_breaker(self, tenant: Tenant) -> None:
        """Open the tenant's circuit after ``breaker_threshold`` consecutive
        abandoned batches: quarantine it for ``breaker_reset_s``, retire its
        in-flight work and fail its queued requests with
        :class:`CircuitOpenError`.  The engine's demote/repair keeps healing
        underneath; the breaker protects the other tenants' latency."""
        eng = tenant.engine
        if eng is None or eng.consecutive_failures < self.breaker_threshold:
            return
        tenant.quarantined_until = time.perf_counter() + self.breaker_reset_s
        tenant.n_quarantines += 1
        self.stats_fleet.quarantines += 1
        eng.flush()
        while eng._queue:
            req = eng._queue.popleft()
            req.set_exception(CircuitOpenError(
                f"tenant {tenant.name!r} quarantined after "
                f"{eng.consecutive_failures} consecutive batch failures"
            ))
            eng.stats.failed_requests += 1
        eng.consecutive_failures = 0
        eng.supervisor.record("quarantine", tenant=tenant.name,
                              until=tenant.quarantined_until,
                              reset_s=self.breaker_reset_s)

    def drain(self) -> int:
        """Serve every pending request of every tenant; returns #served."""
        served = 0
        while True:
            pass_served = sum(t.engine.drain() for t in list(self._tenants.values())
                              if t.engine is not None)
            served += pass_served
            if pass_served == 0:
                return served

    def flush(self) -> int:
        """Retire every in-flight batch fleet-wide (no new dispatches)."""
        return sum(t.engine.flush() for t in self._tenants.values() if t.engine)

    def stats(self) -> FleetStats:
        return self.stats_fleet

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        res = sum(1 for t in self._tenants.values() if t.resident)
        return (
            f"SparseFleet({len(self._tenants)} tenants, {res} resident, "
            f"{self.resident_bytes}/{self.budget_bytes} bytes, ks={self.ks}, "
            f"device={self.device})"
        )

"""SparseEngine: a batch-aggregating, k-aware SpMV serving runtime.

The paper's decisive throughput lever on a memory-bound machine is turning
SpMV (k=1) into SpMM (k>1): Fig 9 shows matrix traffic amortized over many
right-hand sides beats any single-kernel tweak.  The engine owns a request
queue, aggregates pending SpMV requests into stacked right-hand-side
batches (columns of X), and dispatches each batch through the
``repro_torch.tune`` plan tuned for that width.

Plans are held per *k-bucket* (default k in {1, 4, 16, 64}); a batch of b
pending requests is rounded up to the smallest bucket >= b, the tail padded
with a shared zero column.  Each bucket binds one closure
(``runtime.executable``) that stacks the batch into a preallocated device
slab and runs the plan.  On a card (``captured=True``, the default) the
plan's run is a CUDA graph over the slab, captured when the bucket first
dispatches, in a memory pool that the engine's buckets share
(``graph_pool``); ``captured=False`` keeps it eager (the measured baseline).
A bucket whose output is larger than ``CAPTURE_MAX_OUTPUT_BYTES`` stays
eager too: copying a graph's output out costs more device time there than
the graph saves on the host.
The stacked-shard and mesh buckets, the sparse lane and the fallback
closures of a demoted bucket stay eager: the mesh runner places and
copies across devices itself, the sparse lane's host staging has sizes
that depend on the request, and capturing a fallback would add capture
time to the serving thread at the moment it is already degraded.

The loop is asynchronous: ``step()`` enqueues a batch on the device and
keeps up to ``async_depth`` (<= 2) batches in flight, each marked by a CUDA
event recorded after its launch; a batch retires (futures filled, latency
stamped, stats recorded) once its event has completed, strictly in FIFO
order.  Each batch has an id; ``step()`` stamps the requests it takes with
it and with the dispatch time (``EngineRequest.batch``, ``.t_dispatch``),
so a request's queue wait (``t_dispatch - t_submit``) and its time in the
engine (``t_done - t_dispatch``) are apart.  ``runtime.tracing``, when
enabled, records the engine's spans and each batch's device times.
``submit()`` returns a future — ``req.result(timeout=)`` blocks for
exactly that request.  Async and synchronous (``async_depth=0``) engines
run the same closures and kernels, so their dense results are bitwise equal.

``max_wait_s`` adds admission control: a partial bucket is held back until
its oldest request has waited that long, so a lone request under SLO never
waits for a wide bucket to fill.

``submit_sparse(indices, values)`` serves a *sparse* x: the request rounds
up to the smallest of ``x_nnz_buckets`` (default n/256, n/64, n/16, n/4)
and runs the ``kind="spmspv"`` plan tuned for that bucket, built on first
use.  Sparse requests dispatch at once, one per launch, and share the
in-flight window.  Every sparse tier sums each row in a fixed order (the
SpMSpV kernel and its plain version in stream order), so async and
synchronous engines agree bit for bit here too; a request thicker than
the largest bucket is densified onto the dense k = 1 lane.

**Supervision** (``runtime.supervisor``).  A batch that fails — its launch
raises, its device work faults, or (``nan_guard=True``) the on-device
finite flag is false — is retried up to ``supervisor.max_retries`` times
with capped backoff, then its bucket is *demoted* down the fallback chain
(tuned plan -> ``csr/vector`` -> ``sell/ref``); when the chain is spent the
batch's futures fail.  On a card the chain is walked only for failures a
fault plan injected (``supervisor.injected``): a kernel that really fails
there fails its batch's futures at once, as an unsupervised engine would,
and its bucket keeps its tuned plan.  Every demotion is recorded
(``stats.demotions``, ``supervisor.events_of("demote")``).  A background
thread probes each demoted bucket's saved tuned closure (dense or sparse)
every ``repair_interval_s``, on the engine's CUDA stream, and stages that
bucket back once a probe is clean (the plan-swap machinery of
``hot_swap``); the serving thread adopts it, and clears the demotion, at
its next dispatch.  ``faults=`` arms a
:class:`~repro_torch.runtime.faults.FaultPlan` (default: the
``$REPRO_TORCH_FAULTS`` plan).

**Overload** (``runtime.overload``).  ``max_queue`` bounds the queue and
``overload_policy`` picks what a full queue does to ``submit()``:
``"reject"`` raises :class:`OverloadError`, ``"shed-oldest"`` fails the
oldest queued future to admit the new request, ``"block"`` waits up to
``block_timeout_s`` (driving the loop itself when no other thread does),
then rejects.  ``shed_after_s`` fails a request still queued after that
long (:class:`DeadlineExceededError`) at dispatch time.  ``brownout=`` takes
a :class:`BrownoutController` fed, each ``step()``, the queue fill and the
oldest request's age: BROWNOUT pins dispatch to the widest bucket and
pauses repair probes; SHED also refuses new submissions.  With
``brownout_update=False`` the engine only reads the controller: the fleet
(``runtime.fleet``) drives one controller from the pressure of all its
tenants.

**Shards** (``core.distributed``).  ``n_shards=P`` row-partitions A
(nnz-balanced) on the engine's device and serves every bucket through
``stacked_spmm`` (one pass over all shards, no search); ``mesh=``
(``launch.mesh.make_spmm_mesh``) tunes a collective schedule (allgather
or ring) per bucket over the mesh, whose first device holds the batches
and results: the engine waits for a batch there, after the cross-device
copies.  Neither takes ``ops=`` or serves ``submit_sparse``.  A mesh
bucket demotes to a single-device fallback on that first device, and the
repair thread re-promotes it to its schedule.

    eng = SparseEngine(a)            # tunes (or cache-loads) all buckets, on cuda
    reqs = [eng.submit(x) for x in xs]
    eng.drain()                      # dispatches k-bucketed batches
    reqs[0].y, reqs[0].latency_s     # per-request result + latency
    eng.stats.summary()              # occupancy / padding / failure counters
    eng.submit_sparse(idx, val)      # y = A @ x for a sparse x
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_on
from repro_torch.core.distributed import (
    assemble_rows,
    place_stacked,
    sparse_axis,
    stacked_spmm,
)
from repro_torch.core.formats import CSRMatrix
from repro_torch.core.partition import rows_balanced, stack_csr_shards
from repro_torch.kernels.spmspv import pad_sparse_rhs, validate_sparse_rhs
from repro_torch.runtime import tracing
from repro_torch.runtime.executable import GraphPool, finite_guard, fused_batch_executable
from repro_torch.runtime.faults import FaultPlan, InjectedFault, active_plan
from repro_torch.runtime.overload import (
    HEALTHY,
    SHED,
    BrownoutController,
    DeadlineExceededError,
    EngineClosedError,
    OverloadError,
)
from repro_torch.runtime.supervisor import (
    FALLBACK_TIERS,
    NonFiniteOutput,
    Supervisor,
    fallback_op,
    injected,
)
from repro_torch.tune import PlanCache, SparseOperator

__all__ = [
    "SparseEngine",
    "EngineRequest",
    "EngineStats",
    "K_BUCKETS",
    "OVERLOAD_POLICIES",
    "OverloadError",
    "DeadlineExceededError",
    "EngineClosedError",
]

K_BUCKETS = (1, 4, 16, 64)

# A captured bucket returns a copy of its graph's static output, one more
# write and read of Y on the device per batch.  A bucket whose Y (float32,
# rows x bucket) is larger stays eager: at 32 MiB the copy takes about
# 20 us at 3.35 TB/s, half the host time a graph saves per dispatch at
# buckets 4 and 16 (25-46 us on an H100, chip_smoke.py phase 4), and a
# bucket that writes more is device-bound, where saved host time buys
# nothing (ldoor at k = 64, 244 MB: 0.5 % more device time graphed).
CAPTURE_MAX_OUTPUT_BYTES = 32 * 2**20

OVERLOAD_POLICIES = ("reject", "shed-oldest", "block")

# Condition-wait granularity for blocked callers: bounded so a deadline is
# honored even when nothing notifies, but callers wake early on every
# retirement.
_WAIT_QUANTUM_S = 0.005


@dataclasses.dataclass(slots=True)
class EngineRequest:
    """One queued y = A @ x request — a future filled in at retirement."""

    rid: int
    x: Any  # (n,) float32 tensor on the engine's device, or host (idx, val)
    t_submit: float
    t_done: float | None = None
    # When step() took the request into a batch, and that batch's id.
    t_dispatch: float | None = None
    batch: int | None = None
    # k-bucket the request was dispatched in; a sparse request carries
    # ("spmspv", <x-nnz bucket>), so the two bucket spaces never collide.
    bucket: Any = None
    _ys: torch.Tensor | None = None  # the whole batch result
    _col: int = 0  # this request's column of _ys
    _exc: BaseException | None = None
    _engine: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        """Resolved — with a result OR an exception."""
        return self._ys is not None or self._exc is not None

    @property
    def failed(self) -> bool:
        return self._exc is not None

    @property
    def y(self) -> torch.Tensor | None:
        """(m,) result, sliced lazily from the batch result."""
        if self._ys is None:
            return None
        return self._ys[:, self._col] if self._ys.dim() == 2 else self._ys

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self.t_done = time.perf_counter()
        if self._engine is not None:
            self._engine._notify()

    def result(self, timeout: float | None = None) -> torch.Tensor:
        """Block until this request resolves (driving the engine as needed)
        and return y; raises the batch's failure, or ``TimeoutError`` after
        ``timeout`` seconds."""
        if not self.done:
            if self._engine is None:
                raise RuntimeError("request is not attached to an engine")
            deadline = None if timeout is None else time.perf_counter() + float(timeout)
            self._engine._fulfill(self, deadline=deadline)
        if self._exc is not None:
            raise self._exc
        return self.y

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise RuntimeError("request not served yet")
        return self.t_done - self.t_submit


@dataclasses.dataclass
class EngineStats:
    n_requests: int = 0
    n_dispatches: int = 0
    dispatched: dict = dataclasses.field(default_factory=dict)  # bucket -> #
    occupied_cols: int = 0  # real request columns dispatched (served work)
    padded_cols: int = 0  # zero columns added by bucket round-up (NOT work)
    # Sparse dispatches per x-nnz bucket ("spmspv<B>" keys).  They stay out
    # of the k-bucket occupancy figures: each serves exactly one request.
    sparse_dispatched: dict = dataclasses.field(default_factory=dict)
    # Supervision: a retried batch counts one retry per re-launch; a batch
    # the fallback chain could not serve counts its requests as failed
    # (resolved, not served: they enter no occupancy figure).
    failed_requests: int = 0
    failed_batches: int = 0
    retries: int = 0
    demotions: int = 0
    promotions: int = 0
    # Overload: rejected never entered the queue (the exception surfaced at
    # submit); shed_oldest were queued and evicted for newer work;
    # shed_deadline lapsed past shed_after_s before dispatch.
    rejected: int = 0
    shed_oldest: int = 0
    shed_deadline: int = 0

    def record(self, bucket, n_real: int) -> None:
        self.n_dispatches += 1
        if isinstance(bucket, tuple):  # ("spmspv", B)
            key = f"spmspv{bucket[1]}"
            self.sparse_dispatched[key] = self.sparse_dispatched.get(key, 0) + 1
            return
        self.dispatched[bucket] = self.dispatched.get(bucket, 0) + 1
        self.occupied_cols += n_real
        self.padded_cols += bucket - n_real

    @property
    def occupancy(self) -> float:
        """TRUE occupancy: real requests / dispatched bucket capacity."""
        total = self.occupied_cols + self.padded_cols
        return self.occupied_cols / total if total else 0.0

    @property
    def padded_occupancy(self) -> float:
        """Share of dispatched capacity that was zero padding."""
        total = self.occupied_cols + self.padded_cols
        return self.padded_cols / total if total else 0.0

    def summary(self) -> dict[str, Any]:
        """The counters; latencies are the requests' own (``latency_s``,
        ``t_dispatch``), which their holder reads."""
        return {
            "requests": self.n_requests,
            "dispatches": self.n_dispatches,
            "by_bucket": dict(sorted(self.dispatched.items())),
            "sparse_by_bucket": dict(sorted(self.sparse_dispatched.items())),
            "occupancy": round(self.occupancy, 4),
            "padded_occupancy": round(self.padded_occupancy, 4),
            "served_cols": self.occupied_cols,
            "padded_cols": self.padded_cols,
            "failed_requests": self.failed_requests,
            "failed_batches": self.failed_batches,
            "retries": self.retries,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "rejected": self.rejected,
            "shed_oldest": self.shed_oldest,
            "shed_deadline": self.shed_deadline,
        }


class SparseEngine:
    """Batch-aggregating serving runtime over a k-indexed plan table.

    ``ks`` are the tuned batch widths; ``cache`` is the shared plan cache
    (defaults to the on-disk one, so restarts skip the measured search);
    ``ops=`` injects a prebuilt ``{k: SparseOperator}`` table instead of
    tuning one.  ``device`` is where the engine serves (``"cuda"`` unless
    the caller passes ``"cpu"``; with ``mesh=`` the mesh's first device).
    ``captured`` runs the dense buckets' plans as CUDA graphs on a card.
    ``n_shards`` and ``mesh``/``axis`` serve A row-partitioned (see the
    module docstring); they exclude each other and ``ops=``.
    ``max_wait_s`` caps how long a request
    may wait for its bucket to fill.  ``async_depth`` (0..2) is the
    in-flight window.  ``x_nnz_buckets`` are the sparse lane's nnz(x)
    buckets.  ``name`` labels the engine in fault contexts and messages;
    ``supervisor``, ``faults`` and ``nan_guard`` set the failure policy,
    ``max_queue``, ``overload_policy``, ``block_timeout_s``,
    ``shed_after_s``, ``brownout`` and ``brownout_update`` the overload
    policy (see the module docstring).  Remaining keyword arguments pass
    through to :meth:`SparseOperator.build`.

    **Dtype policy.** The engine serves float32.  A non-f32 ``submit()``
    input (or ``submit_sparse()`` values) is cast — warning once per
    engine — or, under ``strict_dtype=True``, refused with ``TypeError``.

    A submitted request always resolves, with a result or an exception;
    recovery runs after older in-flight batches retire, so FIFO order and
    the results of unaffected batches hold.
    """

    @tracing.traced("engine.build")
    def __init__(
        self,
        a: CSRMatrix,
        *,
        ks: Sequence[int] = K_BUCKETS,
        cache: PlanCache | None = None,
        n_shards: int = 1,
        mesh: Any = None,
        axis: str | None = None,
        max_wait_s: float | None = None,
        max_queue: int | None = None,
        overload_policy: str = "reject",
        block_timeout_s: float = 1.0,
        shed_after_s: float | None = None,
        brownout: BrownoutController | None = None,
        brownout_update: bool = True,
        async_depth: int = 2,
        strict_dtype: bool = False,
        ops: dict[int, SparseOperator] | None = None,
        device: str | torch.device | None = None,
        x_nnz_buckets: Sequence[int] | None = None,
        name: str | None = None,
        supervisor: Supervisor | None = None,
        faults: FaultPlan | None = None,
        nan_guard: bool = False,
        captured: bool = True,
        **build_kwargs: Any,
    ):
        if not ks:
            raise ValueError("need at least one k-bucket")
        if overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy {overload_policy!r} is not one of "
                f"{OVERLOAD_POLICIES}"
            )
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (None = unbounded)")
        if ops is not None and (mesh is not None or int(n_shards) > 1):
            raise ValueError(
                "ops= injects a prebuilt single-device plan table; it cannot "
                "be combined with mesh= or n_shards>1"
            )
        if mesh is not None and int(n_shards) > 1:
            raise ValueError("mesh= and n_shards= are mutually exclusive")
        self.device = resolve_on(device, mesh)
        self.mesh = mesh
        self.axis = sparse_axis(mesh, axis) if mesh is not None else axis
        self.n_shards = int(mesh.shape[self.axis]) if mesh is not None else int(n_shards)
        self.a = a
        self.shape = a.shape
        self.name = name
        self.supervisor = supervisor if supervisor is not None else Supervisor()
        self.faults = faults if faults is not None else active_plan()
        self.nan_guard = bool(nan_guard)
        self.captured = bool(captured)
        self.graph_pool: GraphPool | None = None  # the buckets' graphs, on a card
        self.ks = tuple(sorted({int(k) for k in ks}))
        self.max_wait_s = max_wait_s
        self.max_queue = None if max_queue is None else int(max_queue)
        self.overload_policy = overload_policy
        self.block_timeout_s = float(block_timeout_s)
        self.shed_after_s = None if shed_after_s is None else float(shed_after_s)
        self._brownout = brownout
        self._brownout_update = bool(brownout_update)
        self.async_depth = max(0, min(int(async_depth), 2))
        self.strict_dtype = bool(strict_dtype)
        self._dtype_warned = False
        self._stacked: dict | None = None
        if mesh is not None:
            self.ops = SparseOperator.build_multi(
                a, ks=self.ks, cache=cache, device=self.device, mesh=mesh,
                axis=self.axis, **build_kwargs)
        elif self.n_shards > 1:
            # Every bucket dispatches through stacked_spmm: there is no plan
            # to search.
            self.ops = {}
            part = rows_balanced(a, self.n_shards)
            self._stacked = place_stacked(stack_csr_shards(part.shards), self.device)
            self._shard_rows = np.diff(part.bounds)
        elif ops is not None:
            missing = [k for k in self.ks if int(k) not in ops]
            if missing:
                raise ValueError(f"ops= is missing buckets {missing}")
            self.ops = {int(k): ops[int(k)] for k in self.ks}
            wrong = [k for k, op in self.ops.items() if op.device != self.device]
            if wrong:
                raise ValueError(f"ops= buckets {wrong} are not on {self.device}")
        else:
            self.ops = SparseOperator.build_multi(
                a, ks=self.ks, cache=cache, device=self.device, **build_kwargs
            )
        # The sparse lane: plans per nnz(x) bucket, built on first use.
        self._cache = cache
        self._build_kwargs = dict(build_kwargs)
        if x_nnz_buckets is None:
            n = a.shape[1]
            x_nnz_buckets = (n // 256, n // 64, n // 16, n // 4)
        self.x_nnz_buckets = tuple(sorted({max(1, int(b)) for b in x_nnz_buckets}))
        self._sparse_ops: dict[int, SparseOperator] = {}
        self._sparse_execs: dict[int, Any] = {}
        self._queue: deque[EngineRequest] = deque()
        # (ys, ok, event, poisoned, reqs, bucket, take, batch, marks): ok is
        # the on-device finite flag (None without nan_guard), event marks the
        # launch (None on CPU), poisoned is True when the engine.nan site
        # fired, marks the batch's start and stacked timing events (None
        # unless the tracer was on, on a card).
        self._inflight: deque[tuple] = deque()
        self._rid = 0
        self._next_batch = 0
        self._marks: tuple | None = None  # the last _launch's timing events
        self._cond = threading.Condition()
        self._serve_lock = threading.Lock()
        if self._brownout is not None:
            sup, nm = self.supervisor, name
            self._brownout.add_listener(
                lambda tr: sup.record(
                    "brownout", engine=nm, frm=tr.frm, to=tr.to,
                    pressure=round(tr.pressure, 4),
                )
            )
        self._execs: dict[int, Any] = {}
        # Plan swaps: staged under the lock (by the repair thread or a
        # caller), adopted by the serving thread at its next dispatch.  The
        # lock also guards the demotion state below, which only the serving
        # thread changes.
        self._swap_lock = threading.Lock()
        self._pending_swap: tuple[dict, dict] | None = None
        # Shared zero column: burst tails pad their batch with it.
        self._zero = torch.zeros((self.shape[1],), dtype=torch.float32,
                                 device=self.device)
        self._nan_col: torch.Tensor | None = None  # the engine.nan site's column
        # The stream every batch is enqueued on; the repair thread probes
        # on it too (the slab-reuse rule of runtime.executable).
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.stats = EngineStats()
        self.swaps_applied = 0  # staged tables adopted (repair promotions aside)
        self.consecutive_failures = 0  # abandoned batches since one resolved
        self._closed = False
        # Degraded mode: bucket -> fallback level (1-based), and the saved
        # tuned (op, closure) the repair thread probes and re-promotes;
        # _promoting holds the buckets staged back but not yet adopted.
        self._demoted: dict[Any, int] = {}
        self._demote_saved: dict[Any, tuple] = {}
        self._promoting: set = set()
        self._repair_lock = threading.Lock()
        self._repair_thread: threading.Thread | None = None
        self._repair_stop = threading.Event()

    # -- queueing -----------------------------------------------------------
    @property
    def from_cache(self) -> bool:
        """True when every bucket's plan came from the cache (no search)."""
        return all(op.from_cache for op in self.ops.values())

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def brownout(self) -> BrownoutController | None:
        """The engine's brownout controller (None when not armed)."""
        return self._brownout

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def submit(self, x) -> EngineRequest:
        """Enqueue y = A @ x; returns a future filled in by a later step().
        A full queue or a shedding brownout answers by ``overload_policy``
        (see the module docstring)."""
        self._check_open()
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if tuple(x.shape) != (self.shape[1],):
            raise ValueError(
                f"expected x of shape ({self.shape[1]},), got {tuple(x.shape)}"
            )
        if x.dtype not in (torch.float32, np.float32):
            self._dtype_policy("submit", x.dtype)
        if isinstance(x, np.ndarray):
            x = torch.tensor(x, dtype=torch.float32, device=self.device)
        else:
            x = x.to(device=self.device, dtype=torch.float32)
        self._admit_one()
        req = EngineRequest(rid=self._rid, x=x, t_submit=time.perf_counter(),
                            _engine=self)
        self._rid += 1
        self._queue.append(req)
        self.stats.n_requests += 1
        return req

    def _refuse_if_shedding(self) -> None:
        b = self._brownout
        if b is not None and b.state == SHED:
            self.stats.rejected += 1
            raise OverloadError(
                f"engine {self.name or 'unnamed'} is shedding load "
                f"(brownout state={b.state}, pressure="
                f"{b.pressure_last:.2f}); resubmit after recovery"
            )

    def _admit_one(self) -> None:
        """Gate one submission against the brownout state and the queue
        bound: SHED rejects outright; a full queue applies
        ``overload_policy`` (``reject`` raises, ``shed-oldest`` fails the
        head request — the one closest to lapsing — so FIFO among the
        survivors holds, ``block`` waits up to ``block_timeout_s`` for
        space, driving the loop when no other thread does, then rejects)."""
        self._refuse_if_shedding()
        if self.max_queue is None or len(self._queue) < self.max_queue:
            return
        if self.overload_policy == "reject":
            self.stats.rejected += 1
            raise OverloadError(
                f"engine {self.name or 'unnamed'} queue is full "
                f"({len(self._queue)}/{self.max_queue} pending, "
                f"policy=reject); back off and resubmit"
            )
        if self.overload_policy == "shed-oldest":
            victim = self._queue.popleft()
            victim.set_exception(
                OverloadError(
                    f"request {victim.rid} shed: engine "
                    f"{self.name or 'unnamed'} queue hit max_queue="
                    f"{self.max_queue} (policy=shed-oldest) and a newer "
                    "request displaced it"
                )
            )
            self.stats.shed_oldest += 1
            return
        deadline = time.perf_counter() + self.block_timeout_s
        while len(self._queue) >= self.max_queue:
            now = time.perf_counter()
            if now >= deadline:
                self.stats.rejected += 1
                raise OverloadError(
                    f"engine {self.name or 'unnamed'} queue still full "
                    f"({len(self._queue)}/{self.max_queue}) after blocking "
                    f"{self.block_timeout_s:.3f}s (policy=block)"
                )
            if self._serve_lock.acquire(blocking=False):
                try:
                    if self.step() > 0:
                        continue
                    self._retire_ready()
                    if len(self._queue) < self.max_queue:
                        return
                finally:
                    self._serve_lock.release()
            with self._cond:
                if len(self._queue) >= self.max_queue:
                    self._cond.wait(timeout=min(_WAIT_QUANTUM_S, deadline - now))

    def submit_sparse(self, indices, values) -> EngineRequest:
        """Serve y = A @ x for a sparse x given as sorted (indices, values).

        The request goes to the smallest ``x_nnz_buckets`` entry >= nnz(x)
        and is launched at once through that bucket's ``kind="spmspv"``
        plan; it shares the in-flight window and retires like a dense
        batch.  Bad coordinates raise ``ValueError``; values follow the
        engine's float32 policy.  A request thicker than the largest bucket
        is densified onto the dense k = 1 lane.  A shedding brownout
        refuses it like a dense one.  Mesh and shard engines raise
        ``NotImplementedError``, as in the JAX package.
        """
        self._check_open()
        self._refuse_if_shedding()
        if self.mesh is not None or self.n_shards > 1:
            raise NotImplementedError(
                "submit_sparse is single-device: distributed SpMSpV under the "
                "mesh schedules is a feature of neither package yet"
            )
        n = self.shape[1]
        idx, val = validate_sparse_rhs(indices, values, n)
        if val.dtype != np.float32:
            self._dtype_policy("submit_sparse", val.dtype)
            val = val.astype(np.float32)
        bucket = next((b for b in self.x_nnz_buckets if b >= idx.size), None)
        if bucket is None:
            x = np.zeros((n,), np.float32)
            x[idx] = val
            return self.submit(x)
        req = EngineRequest(rid=self._rid, x=(idx, val), t_submit=time.perf_counter(),
                            _engine=self)
        self._rid += 1
        self.stats.n_requests += 1
        self._apply_pending_swap()
        self._dispatch(("spmspv", bucket), [req], self._stamp([req]))
        return req

    def _dtype_policy(self, what: str, dtype) -> None:
        """A non-float32 input: raise under ``strict_dtype``, else warn
        (once per engine) and let the caller cast."""
        if self.strict_dtype:
            raise TypeError(
                f"{what}() got dtype {dtype}; this engine serves float32 and "
                "strict_dtype=True forbids the implicit cast"
            )
        if not self._dtype_warned:
            self._dtype_warned = True
            warnings.warn(
                f"SparseEngine.{what}: casting {dtype} input to float32 (the "
                "engine's serving dtype) — submit float32 to avoid the cast, "
                "or build the engine with strict_dtype=True to make this an "
                "error; warning once per engine",
                stacklevel=3,
            )

    def _sparse_op(self, bucket: int) -> SparseOperator:
        op = self._sparse_ops.get(bucket)
        if op is None:
            op = self._sparse_ops[bucket] = SparseOperator.build(
                self.a, x_nnz=bucket, cache=self._cache, device=self.device,
                **self._build_kwargs,
            )
        return op

    def _sparse_exec(self, bucket: int):
        fn = self._sparse_execs.get(bucket)
        if fn is None:
            fn = self._sparse_execs[bucket] = self._sparse_exec_for(
                self._sparse_op(bucket))
        return fn

    # -- plan swaps ---------------------------------------------------------
    def hot_swap(self, ops: dict[int, SparseOperator],
                 execs: dict[int, Any] | None = None) -> None:
        """Stage a replacement plan table; applied at a dispatch boundary.

        Thread-safe.  Batches already in flight keep their old plan's
        results; every batch dispatched after the swap runs the new table.
        ``execs`` may carry prebuilt per-bucket closures (the others are
        bound on first use)."""
        missing = [k for k in self.ks if int(k) not in ops]
        if missing:
            raise ValueError(f"hot_swap ops is missing buckets {missing}")
        staged_ops = {int(k): ops[int(k)] for k in self.ks}
        with self._swap_lock:
            self._stage(staged_ops, {int(k): v for k, v in (execs or {}).items()
                                     if int(k) in staged_ops})

    def _stage(self, ops: dict, execs: dict) -> None:
        """Merge per-bucket replacements into the pending swap (caller
        holds ``_swap_lock``): two promotions staged before one adoption
        both land."""
        if self._pending_swap is None:
            self._pending_swap = ({}, {})
        p_ops, p_execs = self._pending_swap
        for k, op in ops.items():
            p_ops[k] = op
            p_execs.pop(k, None)
        p_execs.update(execs)

    def _apply_pending_swap(self) -> None:
        """Adopt the staged buckets (serving thread only, between
        dispatches); a bucket staged without a closure is bound on first
        use.  A promoted bucket leaves the demotion state here, so a
        fallback batch that fails before adoption demotes it one tier
        further, not afresh."""
        with self._swap_lock:
            staged = self._pending_swap
            self._pending_swap = None
            if staged is None:
                return
            promoted = [k for k in staged[0] if k in self._promoting]
            for k in promoted:
                self._promoting.discard(k)
                self._demoted.pop(k, None)
                self._demote_saved.pop(k, None)
        if len(promoted) < len(staged[0]):
            self.swaps_applied += 1
        ops, execs = staged
        for k, op in ops.items():
            if isinstance(k, tuple):  # ("spmspv", B): the sparse lane
                self._sparse_ops[k[1]] = op
                self._sparse_execs[k[1]] = execs[k]
                continue
            self.ops[k] = op
            if k in execs:
                self._execs[k] = execs[k]
            else:
                self._execs.pop(k, None)
        pool = self.graph_pool
        if pool is not None and not any(
                getattr(getattr(fn, "executable", None), "pool", None) is pool
                for fn in self._execs.values()):
            # no bucket serves from the engine's pool now (a retune brought
            # its own): let it go with its last graph, and start a new one
            # for a bucket bound later
            self.graph_pool = None

    # -- dispatch -----------------------------------------------------------
    def _bucket_for(self, n_pending: int) -> tuple[int, int]:
        take = min(n_pending, self.ks[-1])
        if self._brownout is not None and self._brownout.state != HEALTHY:
            # Browned out: the widest bucket amortizes the matrix over the
            # most requests, the highest-goodput way through a backlog.
            return self.ks[-1], take
        return next(k for k in self.ks if k >= take), take

    def _overload_pressure(self) -> float:
        """The brownout controller's input: the max of queue fill (against
        ``max_queue``) and the oldest request's age (against
        ``shed_after_s``, or 4x ``max_wait_s``).  The prep memo's fill is
        not an input: an LRU sits near its budget once filled, and its
        entries can always be evicted, so it would hold an idle engine
        browned out."""
        q = (len(self._queue) / self.max_queue) if self.max_queue else None
        ref = self.shed_after_s
        if ref is None and self.max_wait_s:
            ref = 4.0 * self.max_wait_s
        age = None
        if ref and self._queue:
            age = (time.perf_counter() - self._queue[0].t_submit) / ref
        return BrownoutController.pressure(queue=q, age=age)

    def _shed_lapsed(self) -> None:
        """Fail queued requests that have waited past ``shed_after_s``
        (FIFO: the head is the oldest, so the scan stops at a survivor)."""
        if self.shed_after_s is None or not self._queue:
            return
        now = time.perf_counter()
        while self._queue and now - self._queue[0].t_submit > self.shed_after_s:
            req = self._queue.popleft()
            req.set_exception(
                DeadlineExceededError(
                    f"request {req.rid} lapsed: waited {now - req.t_submit:.4f}s "
                    f"> shed_after_s={self.shed_after_s:.4f}s before dispatch "
                    f"on engine {self.name or 'unnamed'}"
                )
            )
            self.stats.shed_deadline += 1

    def step(self, *, force: bool = False) -> int:
        """Dispatch one aggregated batch; returns #requests dispatched.

        Adopts a staged plan swap, updates the brownout controller (unless
        ``brownout_update=False``) and sheds
        lapsed requests first.  Then takes up to max(ks) pending requests,
        rounds the count up to the smallest k-bucket (the widest under
        brownout) and launches the bucket's closure without waiting for
        the device; the batch joins the in-flight window and retires when
        the window is full, on ``flush()``/``drain()``, or through a
        request's ``result()``.  With ``async_depth=0`` it retires before
        step() returns.  With ``max_wait_s`` set, a partial bucket is held
        (step() returns 0) until the oldest request has waited that long;
        ``force=True`` bypasses the wait.
        """
        self._apply_pending_swap()
        if self._brownout is not None and self._brownout_update:
            self._brownout.update(self._overload_pressure())
        self._shed_lapsed()
        if not self._queue:
            self._retire_ready()
            return 0
        if (
            not force
            and self.max_wait_s is not None
            and len(self._queue) < self.ks[-1]
            and time.perf_counter() - self._queue[0].t_submit < self.max_wait_s
        ):
            self._retire_ready()  # use the hold to resolve finished batches
            return 0
        with tracing.span("engine.step") as sp:
            bucket, take = self._bucket_for(len(self._queue))
            reqs = [self._queue.popleft() for _ in range(take)]
            self._notify()  # queue space freed: wake blocked submitters
            batch = self._stamp(reqs)
            if sp.on:
                sp.attrs.update(batch=batch, bucket=bucket, take=take,
                                first=reqs[0].rid, last=reqs[-1].rid)
            self._dispatch(bucket, reqs, batch)
        return take

    def _stamp(self, reqs: list) -> int:
        """Give a batch its id and stamp its requests with the id and the
        dispatch time; returns the id."""
        batch = self._next_batch
        self._next_batch += 1
        t = time.perf_counter()
        for req in reqs:
            req.t_dispatch = t
            req.batch = batch
        return batch

    def _dispatch(self, bucket, reqs: list, batch: int) -> None:
        """Launch one batch once the in-flight window has room; a launch
        that raises is recovered after older batches retire (FIFO)."""
        window = max(1, self.async_depth)
        while len(self._inflight) >= window:
            self._retire_one()
        try:
            launched = self._launch(bucket, reqs)
        except Exception as exc:
            self.flush()
            self._recover(reqs, bucket, len(reqs), exc)
            return
        self._inflight.append((*launched, reqs, bucket, len(reqs), batch, self._marks))
        if self.async_depth == 0:
            self._retire_one()

    def _nan_column(self) -> torch.Tensor:
        if self._nan_col is None:
            self._nan_col = torch.full((self.shape[1],), float("nan"),
                                       dtype=torch.float32, device=self.device)
        return self._nan_col

    def _assemble(self, reqs: list, bucket) -> tuple:
        """A batch's operands, rebuilt from its requests (a retry never
        reuses an operand a fault may have poisoned)."""
        if isinstance(bucket, tuple):  # one sparse request, host (xi, xv)
            idx, val = reqs[0].x
            return (pad_sparse_rhs(idx, val, bucket[1], self.shape[1]),)
        xs = [r.x for r in reqs]
        xs.extend([self._zero] * (bucket - len(xs)))  # burst tail padding
        return tuple(xs)

    def _launch(self, bucket, reqs: list) -> tuple:
        """Assemble and enqueue one batch, firing any armed fault sites on
        the way; returns ``(ys, ok, event, poisoned)``.  The closure is
        bound first, so a dispatch fault leaves a tuned plan to repair."""
        sparse = isinstance(bucket, tuple)
        fn = self._sparse_exec(bucket[1]) if sparse else self._exec(bucket)
        faults = self.faults
        if faults is not None:
            stall = faults.delay("engine.overload", engine=self.name, bucket=bucket)
            if stall > 0.0:
                time.sleep(stall)  # a slow dispatch with a known cost
            faults.fire("engine.dispatch", engine=self.name, bucket=bucket)
        with tracing.span("engine.assemble"):
            xs = self._assemble(reqs, bucket)
        poisoned = (
            faults is not None
            and not sparse
            and faults.should_fire("engine.nan", engine=self.name, bucket=bucket)
        )
        if poisoned:
            xs = (self._nan_column(),) + xs[1:]  # poison one column
        # The batch's device times (the tracer on, on a card): an event
        # before the closure, the closure's between its stack and its plan,
        # and the end event below, timed too.
        start = tracing.device_event(self.device)
        with tracing.span("engine.launch"):
            out = fn(*xs)
            ys, ok = out if isinstance(out, tuple) else (out, None)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event(enable_timing=start is not None)
                event.record(torch.cuda.current_stream(self.device))
        self._marks = None if start is None else (start, tracing.take_stacked())
        return ys, ok, event, poisoned

    def _exec(self, bucket: int):
        fn = self._execs.get(bucket)
        if fn is None:
            if self._stacked is not None:
                stacked, counts = self._stacked, self._shard_rows

                def run(x):
                    x2 = x[:, None] if x.dim() == 1 else x
                    y = assemble_rows(stacked_spmm(stacked, x2), counts)
                    return y[:, 0] if x.dim() == 1 else y

                fn = fused_batch_executable(run, bucket=bucket, n=self.shape[1],
                                            device=self.device, guard=self.nan_guard,
                                            captured=False)
            else:
                fn = self._make_exec(bucket, self.ops[bucket])
            self._execs[bucket] = fn
        return fn

    def _make_exec(self, bucket: int, op: SparseOperator, *, fallback: bool = False,
                   pool: GraphPool | None = None):
        """A bucket's closure; captured unless it is a fallback's or a mesh
        plan's (see the module docstring) or its output is larger than
        ``CAPTURE_MAX_OUTPUT_BYTES``, into ``pool`` (default: the engine's
        own, which its buckets share)."""
        captured = (self.captured and not fallback and op.mesh is None
                    and self.shape[0] * bucket * 4 <= CAPTURE_MAX_OUTPUT_BYTES)
        if captured and self.device.type == "cuda" and pool is None:
            if self.graph_pool is None:
                self.graph_pool = GraphPool(self.device)
            pool = self.graph_pool
        return fused_batch_executable(
            op._run, bucket=bucket, n=self.shape[1], device=self.device,
            guard=self.nan_guard, captured=captured, pool=pool)

    # -- retirement ---------------------------------------------------------
    def _settle(self, bucket, ys, ok, event, poisoned) -> None:
        """Wait for a launched batch and check its finite flag; raises what
        the device or the guard reports."""
        if event is not None:
            event.synchronize()
        if ok is not None and not bool(ok):
            raise NonFiniteOutput(
                f"bucket {bucket} batch produced non-finite outputs (engine "
                f"{self.name or 'unnamed'}; nan_guard flagged it on the device"
                + ("; the engine.nan fault site poisoned it)" if poisoned else ")"),
                injected=poisoned,
            )

    def _resolve(self, reqs: list, bucket, take: int, ys) -> int:
        t_done = time.perf_counter()
        for i, req in enumerate(reqs):
            req._ys = ys
            req._col = i
            req.t_done = t_done
            req.bucket = bucket
        self.stats.record(bucket, take)
        self.consecutive_failures = 0
        self._notify()
        return take

    def _retire_one(self) -> int:
        """Wait for the oldest in-flight batch and fill its futures; a batch
        that failed on the device goes through :meth:`_recover`.  A batch
        launched with timing events leaves its device times with the
        tracer once its end event has completed."""
        ys, ok, event, poisoned, reqs, bucket, take, batch, marks = self._inflight.popleft()
        with tracing.span("engine.retire") as sp:
            if sp.on:
                sp.attrs["batch"] = batch
            try:
                self._settle(bucket, ys, ok, event, poisoned)
            except Exception as exc:
                return self._recover(reqs, bucket, take, exc)
            if marks is not None and marks[1] is not None:
                tracing.add_batch(batch, bucket, take, *marks, event)
            with tracing.span("engine.resolve"):
                return self._resolve(reqs, bucket, take, ys)

    # -- supervision: retry -> demote -> fail the futures -------------------
    def _supervised(self, exc: BaseException) -> bool:
        """Whether a failure may be retried and demoted: any failure on the
        CPU (every tier there is plain), only an injected one on a card."""
        return self.device.type != "cuda" or injected(exc)

    def _recover(self, reqs: list, bucket, take: int, exc: Exception) -> int:
        """Serve a failed batch through the supervision policy: retry the
        current tier up to ``max_retries`` times with backoff (operands
        re-assembled each time), then demote the bucket and retry there;
        when the chain is spent, or on a card when a failure was not
        injected, fail every future of the batch.  Runs on the serving
        thread after older batches retired."""
        sup = self.supervisor
        sup.record("batch_failed", engine=self.name, bucket=bucket, error=repr(exc))
        last: Exception = exc
        attempt = 0
        budget = sup.max_retries  # retries left on the current tier
        while self._supervised(last):
            if budget <= 0:
                if not self._demote(bucket, last):
                    break  # chain exhausted
                budget = 1 + sup.max_retries
            budget -= 1
            sup.sleep(sup.backoff(attempt))
            attempt += 1
            self.stats.retries += 1
            sup.retries += 1
            try:
                launched = self._launch(bucket, reqs)
                self._settle(bucket, *launched)
            except Exception as e:
                last = e
                continue
            return self._resolve(reqs, bucket, take, launched[0])
        for req in reqs:
            req.bucket = bucket
            req.set_exception(last)
        self.stats.failed_batches += 1
        self.stats.failed_requests += take
        self.consecutive_failures += 1
        sup.failures += 1
        sup.record("batch_abandoned", engine=self.name, bucket=bucket,
                   n_requests=take, error=repr(last))
        return take

    def _demote(self, bucket, exc: Exception) -> bool:
        """Install the next fallback tier for one bucket; False when the
        chain is exhausted.  The tuned (op, closure) is saved the first time
        so the repair thread can probe and re-promote it."""
        level = self._demoted.get(bucket, 0)
        while level < len(FALLBACK_TIERS):
            level += 1
            try:
                tier, op = fallback_op(self.a, bucket, level, device=self.device)
            except Exception:
                continue  # this tier cannot build here; try the next one
            sparse = isinstance(bucket, tuple)
            fn = (self._sparse_exec_for(op) if sparse
                  else self._make_exec(bucket, op, fallback=True))
            with self._swap_lock:
                if bucket not in self._demote_saved:
                    self._demote_saved[bucket] = (
                        (self._sparse_ops.get(bucket[1]),
                         self._sparse_execs.get(bucket[1]))
                        if sparse else (self.ops.get(bucket), self._execs.get(bucket))
                    )
                self._demoted[bucket] = level
            if sparse:
                self._sparse_ops[bucket[1]] = op
                self._sparse_execs[bucket[1]] = fn
            else:
                self.ops[bucket] = op
                self._execs[bucket] = fn
            self.stats.demotions += 1
            self.supervisor.demotions += 1
            # where the fallback serves: on a mesh engine this is the
            # single-device placement, recorded once and never rewritten
            n_dev = 1 if op.mesh is None else op.mesh.n_devices
            self.supervisor.record("demote", engine=self.name, bucket=bucket,
                                   tier=tier, level=level, error=repr(exc),
                                   n_devices=n_dev, device=str(op.device))
            self._start_repair()
            return True
        return False

    # -- background repair: probe the tuned closure, re-promote -------------
    def _start_repair(self) -> None:
        with self._repair_lock:
            t = self._repair_thread
            if t is not None and t.is_alive():
                return
            self._repair_stop.clear()
            t = threading.Thread(target=self._repair_worker, name="engine-repair",
                                 daemon=True)
            self._repair_thread = t
            t.start()

    def _probe(self, bucket, fn) -> None:
        """One zero batch through a saved closure, on the engine's stream,
        waited for on an event of its own; raises if it fails.  A sparse
        bucket gets a one-entry x at a column that holds entries, so the
        probe runs a product (an empty x returns its zero fill without a
        launch)."""
        faults = self.faults
        if faults is not None:
            faults.fire("engine.dispatch", engine=self.name, bucket=bucket, probe=True)
            if faults.should_fire("engine.nan", engine=self.name, bucket=bucket,
                                  probe=True):
                raise InjectedFault("injected nan at repair probe")
        with contextlib.ExitStack() as on_stream:
            if self._stream is not None:
                on_stream.enter_context(torch.cuda.device(self.device))
                on_stream.enter_context(torch.cuda.stream(self._stream))
            if isinstance(bucket, tuple):
                col = int(self.a.indices[0]) if self.a.nnz else 0
                one = np.array([col], np.int64), np.ones(1, np.float32)
                out = fn(pad_sparse_rhs(*one, bucket[1], self.shape[1]))
            else:
                out = fn(*([self._zero] * bucket))
            ys = out[0] if isinstance(out, tuple) else out
            finite = torch.isfinite(ys).all()
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
                done.synchronize()
        if not bool(finite):
            raise NonFiniteOutput(f"repair probe of bucket {bucket} was not finite")

    def _repair_worker(self) -> None:
        """Probe each demoted bucket's saved tuned closure off the hot
        path; on a clean probe, stage that bucket back.  Exits when no
        demotion remains (a later one starts a fresh thread)."""
        interval = self.supervisor.repair_interval_s
        while not self._repair_stop.wait(interval):
            with self._swap_lock:
                if not self._demoted:
                    return
                todo = [(b, self._demote_saved.get(b)) for b in self._demoted
                        if b not in self._promoting]
            if self._brownout is not None and self._brownout.state != HEALTHY:
                continue  # probes are device work taken from serving
            for bucket, saved in todo:
                if saved is None or saved[0] is None:
                    continue
                op, fn = saved
                try:
                    if fn is None:  # the tuned closure was never bound
                        fn = (self._sparse_exec_for(op) if isinstance(bucket, tuple)
                              else self._make_exec(bucket, op))
                    self._probe(bucket, fn)
                except Exception:
                    continue  # still sick; probe again next interval
                self._promote(bucket, op, fn)

    def _sparse_exec_for(self, op: SparseOperator):
        return finite_guard(op._run) if self.nan_guard else op._run

    def _promote(self, bucket, op: SparseOperator, fn) -> None:
        """Stage the healed tuned plan and closure of one bucket; the
        serving thread adopts it, and clears the demotion, at its next
        dispatch.  Only this bucket is staged, so another bucket's demotion
        or promotion in between is kept."""
        with self._swap_lock:
            if bucket not in self._demoted or bucket in self._promoting:
                return
            self._stage({bucket: op}, {bucket: fn})
            self._promoting.add(bucket)
        self.stats.promotions += 1
        self.supervisor.promotions += 1
        self.supervisor.record("promote", engine=self.name, bucket=bucket)

    def _head_ready(self) -> bool:
        event = self._inflight[0][2]
        return event is None or event.query()

    def _retire_ready(self) -> None:
        """Retire in-flight batches already finished on the device (never
        blocks; FIFO stops at the first batch still computing)."""
        while self._inflight and self._head_ready():
            self._retire_one()

    def flush(self) -> int:
        """Retire every in-flight batch; returns #requests completed."""
        served = 0
        while self._inflight:
            served += self._retire_one()
        return served

    def drain(self) -> int:
        """Dispatch until the queue is empty (bypassing ``max_wait_s``),
        then retire everything in flight; returns #requests retired."""
        before = self.stats.occupied_cols
        while self.step(force=True):
            pass
        self.flush()
        return self.stats.occupied_cols - before

    def run(self, xs: Iterable) -> list[torch.Tensor]:
        """Submit all, drain, return results in submit order.  A refused
        admission (bounded queue, shedding brownout) is absorbed here: run()
        owns the loop, so it serves a batch (or waits out the shedding) and
        resubmits.  A request still refused ``block_timeout_s`` after its
        first refusal while nothing was left to serve re-raises the
        refusal."""
        reqs = []
        for x in xs:
            deadline = None
            while True:
                try:
                    reqs.append(self.submit(x))
                    break
                except OverloadError:
                    if self.step(force=True) > 0:
                        deadline = None  # progress: the wait starts again
                        continue
                    self.flush()
                    now = time.perf_counter()
                    if deadline is None:
                        deadline = now + self.block_timeout_s
                    elif now >= deadline:
                        raise
                    time.sleep(1e-3)
        self.drain()
        return [r.y for r in reqs]

    def _notify(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def _fulfill(self, req: EngineRequest, deadline: float | None = None) -> None:
        """Serve until ``req`` is done — the blocking half of its future.

        One caller at a time drives the engine (non-blocking
        ``_serve_lock``); others sleep on the condition until a retirement
        wakes them.  The driver retires in-flight batches first and forces
        a dispatch only while ``req`` is still queued.  Past ``deadline``
        an unresolved request raises ``TimeoutError``.
        """
        while not req.done:
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                raise TimeoutError(
                    f"request {req.rid} (bucket={req.bucket}, engine="
                    f"{self.name or 'unnamed'}) unresolved at timeout: "
                    f"{self.pending} queued, {self.in_flight} in flight"
                )
            if not self._serve_lock.acquire(blocking=False):
                with self._cond:
                    if not req.done:
                        t = _WAIT_QUANTUM_S
                        if deadline is not None:
                            t = min(t, max(0.0, deadline - now))
                        self._cond.wait(timeout=t)
                continue
            try:
                if req.done:
                    break
                if deadline is not None and self._inflight and not self._head_ready():
                    with self._cond:
                        self._cond.wait(
                            timeout=min(_WAIT_QUANTUM_S, max(0.0, deadline - now))
                        )
                    continue
                if self._inflight:
                    self._retire_one()
                    continue
                if self.step(force=True) == 0:
                    if req.done:
                        break
                    raise RuntimeError("request is not pending on this engine")
            finally:
                self._serve_lock.release()

    # -- lifecycle ----------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise EngineClosedError(
                f"SparseEngine {self.name or 'unnamed'} is closed: build a new "
                "engine (plans are cached, so it is cheap)"
            )

    def close(self, drain: bool = True) -> None:
        """Refuse new submissions and stop the repair thread.  ``drain=True``
        serves everything outstanding first; ``drain=False`` fails every
        queued or in-flight future with :class:`EngineClosedError` (an
        ``engine_aborted`` event).  Idempotent."""
        if self._closed:
            return
        if drain:
            self.drain()
        self._closed = True
        if not drain:
            exc = EngineClosedError(
                f"SparseEngine {self.name or 'unnamed'} closed with "
                "drain=False: this request was abandoned, not served"
            )
            abandoned = list(self._queue)
            self._queue.clear()
            while self._inflight:
                abandoned.extend(self._inflight.popleft()[4])
            for req in abandoned:
                req.set_exception(exc)
            self.stats.failed_requests += len(abandoned)
            if abandoned:
                self.supervisor.record("engine_aborted", engine=self.name,
                                       n_requests=len(abandoned))
        self._repair_stop.set()
        self._notify()
        t = self._repair_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        plans = {k: op.plan.candidate.key() for k, op in self.ops.items()}
        devices = self.mesh.n_devices if self.mesh is not None else 1
        return (
            f"SparseEngine({self.shape[0]}x{self.shape[1]}, nnz={self.a.nnz}, "
            f"buckets={plans}, shards={self.n_shards} on {devices} device(s), "
            f"device={self.device}, async_depth={self.async_depth})"
        )

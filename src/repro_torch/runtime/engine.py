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
slab and runs the plan.

The loop is asynchronous: ``step()`` enqueues a batch on the device and
keeps up to ``async_depth`` (<= 2) batches in flight, each marked by a CUDA
event recorded after its launch; a batch retires (futures filled, latency
stamped, stats recorded) once its event has completed, strictly in FIFO
order.  ``submit()`` returns a future — ``req.result(timeout=)`` blocks for
exactly that request.  Async and synchronous (``async_depth=0``) engines
run the same closures and kernels, so their dense results are bitwise equal.

``max_wait_s`` adds admission control: a partial bucket is held back until
its oldest request has waited that long, so a lone request under SLO never
waits for a wide bucket to fill.

``submit_sparse(indices, values)`` serves a *sparse* x: the request rounds
up to the smallest of ``x_nnz_buckets`` (default n/256, n/64, n/16, n/4)
and runs the ``kind="spmspv"`` plan tuned for that bucket, built on first
use.  Sparse requests dispatch at once, one per launch, and share the
in-flight window.  Their sums go through atomics on the card, so an async
and a synchronous engine agree within float32 rounding there, not bit for
bit; a request thicker than the largest bucket is densified onto the dense
k = 1 lane.

    eng = SparseEngine(a)            # tunes (or cache-loads) all buckets, on cuda
    reqs = [eng.submit(x) for x in xs]
    eng.drain()                      # dispatches k-bucketed batches
    reqs[0].y, reqs[0].latency_s     # per-request result + latency
    eng.stats.summary()              # occupancy / padding / bucket counts
    eng.submit_sparse(idx, val)      # y = A @ x for a sparse x
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.core.formats import CSRMatrix
from repro_torch.kernels.spmspv import pad_sparse_rhs, validate_sparse_rhs
from repro_torch.runtime.executable import fused_batch_executable
from repro_torch.tune import PlanCache, SparseOperator

__all__ = [
    "SparseEngine",
    "EngineRequest",
    "EngineStats",
    "EngineClosedError",
    "K_BUCKETS",
]

K_BUCKETS = (1, 4, 16, 64)

# Condition-wait granularity for blocked callers: bounded so a deadline is
# honored even when nothing notifies, but callers wake early on every
# retirement.
_WAIT_QUANTUM_S = 0.005


class EngineClosedError(RuntimeError):
    """Raised by ``submit`` after ``close()``, and carried by futures that
    ``close(drain=False)`` abandoned."""


@dataclasses.dataclass(slots=True)
class EngineRequest:
    """One queued y = A @ x request — a future filled in at retirement."""

    rid: int
    x: Any  # (n,) float32 tensor on the engine's device, or host (idx, val)
    t_submit: float
    t_done: float | None = None
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
    latencies_s: list = dataclasses.field(default_factory=list)
    failed_requests: int = 0  # resolved with an exception, not served
    failed_batches: int = 0
    # Sparse dispatches per x-nnz bucket ("spmspv<B>" keys).  They stay out
    # of the k-bucket occupancy figures: each serves exactly one request.
    sparse_dispatched: dict = dataclasses.field(default_factory=dict)

    def record(self, bucket, n_real: int, lats: Iterable[float]) -> None:
        self.n_dispatches += 1
        if isinstance(bucket, tuple):  # ("spmspv", B)
            key = f"spmspv{bucket[1]}"
            self.sparse_dispatched[key] = self.sparse_dispatched.get(key, 0) + 1
            self.latencies_s.extend(lats)
            return
        self.dispatched[bucket] = self.dispatched.get(bucket, 0) + 1
        self.occupied_cols += n_real
        self.padded_cols += bucket - n_real
        self.latencies_s.extend(lats)

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
        lats = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        return {
            "requests": self.n_requests,
            "dispatches": self.n_dispatches,
            "by_bucket": dict(sorted(self.dispatched.items())),
            "sparse_by_bucket": dict(sorted(self.sparse_dispatched.items())),
            "occupancy": round(self.occupancy, 4),
            "padded_occupancy": round(self.padded_occupancy, 4),
            "served_cols": self.occupied_cols,
            "padded_cols": self.padded_cols,
            "latency_mean_ms": round(float(lats.mean()) * 1e3, 3),
            "latency_p99_ms": round(float(np.quantile(lats, 0.99)) * 1e3, 3),
            "failed_requests": self.failed_requests,
            "failed_batches": self.failed_batches,
        }


class SparseEngine:
    """Batch-aggregating serving runtime over a k-indexed plan table.

    ``ks`` are the tuned batch widths; ``cache`` is the shared plan cache
    (defaults to the on-disk one, so restarts skip the measured search);
    ``ops=`` injects a prebuilt ``{k: SparseOperator}`` table instead of
    tuning one.  ``device`` is where the engine serves (``"cuda"`` unless
    the caller passes ``"cpu"``).  ``max_wait_s`` caps how long a request
    may wait for its bucket to fill.  ``async_depth`` (0..2) is the
    in-flight window.  ``x_nnz_buckets`` are the sparse lane's nnz(x)
    buckets.  Remaining keyword arguments pass through to
    :meth:`SparseOperator.build`.

    **Dtype policy.** The engine serves float32.  A non-f32 ``submit()``
    input (or ``submit_sparse()`` values) is cast — warning once per
    engine — or, under ``strict_dtype=True``, refused with ``TypeError``.

    A batch whose launch or device execution fails resolves every future
    in it with that exception (``result()`` raises it); older batches
    retire first, so FIFO order holds.
    """

    def __init__(
        self,
        a: CSRMatrix,
        *,
        ks: Sequence[int] = K_BUCKETS,
        cache: PlanCache | None = None,
        max_wait_s: float | None = None,
        async_depth: int = 2,
        strict_dtype: bool = False,
        ops: dict[int, SparseOperator] | None = None,
        device: str | torch.device = "cuda",
        x_nnz_buckets: Sequence[int] | None = None,
        **build_kwargs: Any,
    ):
        if not ks:
            raise ValueError("need at least one k-bucket")
        self.device = resolve(device)
        self.a = a
        self.shape = a.shape
        self.ks = tuple(sorted({int(k) for k in ks}))
        self.max_wait_s = max_wait_s
        self.async_depth = max(0, min(int(async_depth), 2))
        self.strict_dtype = bool(strict_dtype)
        self._dtype_warned = False
        if ops is not None:
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
        self._queue: deque[EngineRequest] = deque()
        self._inflight: deque[tuple] = deque()  # (ys, event, reqs, bucket, take)
        self._rid = 0
        self._cond = threading.Condition()
        self._serve_lock = threading.Lock()
        self._execs: dict[int, Any] = {}
        # Shared zero column: burst tails pad their batch with it.
        self._zero = torch.zeros((self.shape[1],), dtype=torch.float32,
                                 device=self.device)
        self._closed = False
        self.stats = EngineStats()

    # -- queueing -----------------------------------------------------------
    @property
    def from_cache(self) -> bool:
        """True when every bucket's plan came from the cache (no search)."""
        return all(op.from_cache for op in self.ops.values())

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def submit(self, x) -> EngineRequest:
        """Enqueue y = A @ x; returns a future filled in by a later step()."""
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
        req = EngineRequest(rid=self._rid, x=x, t_submit=time.perf_counter(),
                            _engine=self)
        self._rid += 1
        self._queue.append(req)
        self.stats.n_requests += 1
        return req

    def submit_sparse(self, indices, values) -> EngineRequest:
        """Serve y = A @ x for a sparse x given as sorted (indices, values).

        The request goes to the smallest ``x_nnz_buckets`` entry >= nnz(x)
        and is launched at once through that bucket's ``kind="spmspv"``
        plan; it shares the in-flight window and retires like a dense
        batch.  Bad coordinates raise ``ValueError``; values follow the
        engine's float32 policy.  A request thicker than the largest bucket
        is densified onto the dense k = 1 lane.
        """
        self._check_open()
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
        self._dispatch(("spmspv", bucket), [req])
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

    # -- dispatch -----------------------------------------------------------
    def _bucket_for(self, n_pending: int) -> tuple[int, int]:
        take = min(n_pending, self.ks[-1])
        return next(k for k in self.ks if k >= take), take

    def step(self, *, force: bool = False) -> int:
        """Dispatch one aggregated batch; returns #requests dispatched.

        Takes up to max(ks) pending requests, rounds the count up to the
        smallest k-bucket and launches the bucket's closure without waiting
        for the device; the batch joins the in-flight window and retires
        when the window is full, on ``flush()``/``drain()``, or through a
        request's ``result()``.  With ``async_depth=0`` it retires before
        step() returns.  With ``max_wait_s`` set, a partial bucket is held
        (step() returns 0) until the oldest request has waited that long;
        ``force=True`` bypasses the wait.
        """
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
        bucket, take = self._bucket_for(len(self._queue))
        self._dispatch(bucket, [self._queue.popleft() for _ in range(take)])
        return take

    def _dispatch(self, bucket, reqs: list) -> None:
        """Launch one batch once the in-flight window has room; a launch
        that raises fails its futures after older batches retire."""
        window = max(1, self.async_depth)
        while len(self._inflight) >= window:
            self._retire_one()
        try:
            ys, event = self._launch(bucket, reqs)
        except Exception as exc:
            self.flush()  # older batches retire first: FIFO holds
            self._fail(reqs, exc)
            return
        self._inflight.append((ys, event, reqs, bucket, len(reqs)))
        if self.async_depth == 0:
            self._retire_one()

    def _launch(self, bucket, reqs: list) -> tuple:
        if isinstance(bucket, tuple):  # ("spmspv", B): one sparse request
            idx, val = reqs[0].x
            # Host (xi, xv): the runner picks its work bucket on the host.
            ys = self._sparse_op(bucket[1])._run(
                pad_sparse_rhs(idx, val, bucket[1], self.shape[1]))
        else:
            xs = [r.x for r in reqs]
            xs.extend([self._zero] * (bucket - len(xs)))  # burst tail padding
            ys = self._exec(bucket)(*xs)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return ys, event

    def _exec(self, bucket: int):
        fn = self._execs.get(bucket)
        if fn is None:
            fn = self._execs[bucket] = fused_batch_executable(
                self.ops[bucket]._run, bucket=bucket, n=self.shape[1],
                device=self.device,
            )
        return fn

    # -- retirement ---------------------------------------------------------
    def _retire_one(self) -> int:
        """Wait for the oldest in-flight batch; fill its futures + stats."""
        ys, event, reqs, bucket, take = self._inflight.popleft()
        try:
            if event is not None:
                event.synchronize()
        except Exception as exc:  # a device fault surfaces here
            self._fail(reqs, exc)
            return take
        t_done = time.perf_counter()
        lats = []
        for i, req in enumerate(reqs):
            req._ys = ys
            req._col = i
            req.t_done = t_done
            req.bucket = bucket
            lats.append(t_done - req.t_submit)
        self.stats.record(bucket, take, lats)
        self._notify()
        return take

    def _fail(self, reqs: list, exc: BaseException) -> None:
        for req in reqs:
            req.set_exception(exc)
        self.stats.failed_batches += 1
        self.stats.failed_requests += len(reqs)

    def _head_ready(self) -> bool:
        event = self._inflight[0][1]
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
        """Submit all, drain, return results in submit order."""
        reqs = [self.submit(x) for x in xs]
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
                    f"request {req.rid} unresolved at timeout: {self.pending} "
                    f"queued, {self.in_flight} in flight"
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
                "SparseEngine is closed: build a new engine (plans are "
                "cached, so it is cheap)"
            )

    def close(self, drain: bool = True) -> None:
        """Refuse new submissions.  ``drain=True`` serves everything
        outstanding first; ``drain=False`` fails every queued or in-flight
        future with :class:`EngineClosedError`.  Idempotent."""
        if self._closed:
            return
        if drain:
            self.drain()
        self._closed = True
        if not drain:
            exc = EngineClosedError(
                "SparseEngine closed with drain=False: this request was "
                "abandoned, not served"
            )
            abandoned = list(self._queue)
            self._queue.clear()
            while self._inflight:
                abandoned.extend(self._inflight.popleft()[2])
            for req in abandoned:
                req.set_exception(exc)
            self.stats.failed_requests += len(abandoned)
        self._notify()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        plans = {k: op.plan.candidate.key() for k, op in self.ops.items()}
        return (
            f"SparseEngine({self.shape[0]}x{self.shape[1]}, nnz={self.a.nnz}, "
            f"buckets={plans}, device={self.device}, "
            f"async_depth={self.async_depth})"
        )

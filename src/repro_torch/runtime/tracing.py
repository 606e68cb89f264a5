"""The port's tracer: spans at the serving engine's layer boundaries, each
batch's device times from the engine's own CUDA events, and their summary.

It is off unless :func:`enable` is called, and :func:`disable` turns it off
again.  Off, :func:`span` returns one shared no-op object after a single
check of a module flag, and :func:`device_event` and :func:`mark_stacked`
return at once: nothing is allocated, no event is timed.

On, a span records ``(name, start_ns, end_ns, span_id, parent_id, thread,
attrs)`` on ``time.perf_counter_ns``'s clock into an in-memory list of at
most ``MAX_SPANS`` records; :func:`dropped` counts what the cap turned
away.  The parent is the innermost span open on the same thread, so the
engine's repair thread, which probes plans while the serving thread
serves, keeps a tree of its own.  While a ``torch.profiler`` is recording,
each span is also entered as ``torch.profiler.record_function("repro." +
name)``, which puts it in the profiler's trace on the device's clock
beside the kernels and copies it launched.

The spans the program records (``tracing.summary()`` sums them by name):

    set-up   engine.build        SparseEngine(...)
             tune.build          one plan (a bucket of the engine): k, from_cache
               tune.fingerprint  the sha256 of the structure
               tune.lookup       the plan cache's get
               tune.search       the measured search, on a miss
               prepare           a format for a plan: fmt, memo (hit or miss)
                 prepare.digest  the sha256 of the values (the memo's key)
                 prepare.format  the format built on the host, on a miss
             executable.capture  a bucket's CUDA graph: bucket
    serving  engine.step         a step() that dispatched: batch, bucket,
                                 take, first and last request ids
               engine.retire     a batch retired to make room: batch
               engine.assemble   the batch's operands
               engine.launch     the bucket's closure
                 executable.stack            the stack into the slab
                 executable.replay / .run    the graph, or the eager plan
             engine.retire       a batch retired by result(), flush() or
                                 the poll: batch
               engine.resolve    its futures filled

On a card each dense batch launched while the tracer is on carries three
timing events: before its closure, between the stack and the plan
(:func:`mark_stacked`) and after its launch.  The engine reads them once
the batch has retired, so the read never waits on the stream, and
:func:`batches` returns a :class:`BatchRecord` for each: the stack's and
the plan's device milliseconds.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "BatchRecord",
    "MAX_SPANS",
    "SpanRecord",
    "add_batch",
    "annotate",
    "batches",
    "device_event",
    "disable",
    "dropped",
    "enable",
    "enabled",
    "mark_stacked",
    "span",
    "spans",
    "summary",
    "take_stacked",
    "traced",
]

MAX_SPANS = 1_000_000


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    thread: int
    attrs: dict


class BatchRecord(NamedTuple):
    batch: int
    bucket: int
    take: int
    stack_ms: float  # device time from the closure's start to its stack's end
    plan_ms: float  # device time from the stack's end to the launch's end


_on = False
_spans: list[SpanRecord] = []
_batches: list[BatchRecord] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Start a fresh recording: earlier spans, batches and drops are cleared."""
    global _on, _dropped
    with _lock:
        _spans.clear()
        _batches.clear()
        _dropped = 0
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> list[SpanRecord]:
    with _lock:
        return list(_spans)


def batches() -> list[BatchRecord]:
    with _lock:
        return list(_batches)


def dropped() -> int:
    """Spans the cap turned away since :func:`enable`."""
    return _dropped


class _Noop:
    """The span returned while the tracer is off."""

    __slots__ = ()
    on = False

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


def _stack() -> list["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns", "_range")
    on = True

    def __init__(self, name: str, attrs: dict | None):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.span_id = next(_ids)
        stack.append(self)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function("repro." + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        rec = SpanRecord(self.name, self.start_ns, end_ns, self.span_id, self.parent_id,
                         threading.get_ident(), self.attrs)
        global _dropped
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, attrs: dict | None = None):
    """A context manager that records ``name`` while the tracer is on.
    The object it yields has ``on`` (False for the shared no-op) and, when
    on, ``attrs``: a site whose attributes cost something to build sets
    them under ``if sp.on``."""
    if not _on:
        return _NOOP
    return _Span(name, attrs)


def traced(name: str) -> Callable:
    """Decorate a function so that each call is one span ``name``; the
    body may add attributes through :func:`annotate`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def annotate(**attrs: Any) -> None:
    """Add attributes to the innermost span open on this thread (a
    :func:`traced` function's own); nothing while the tracer is off."""
    if not _on:
        return
    stack = _stack()
    if stack:
        stack[-1].attrs.update(attrs)


def device_event(device: torch.device):
    """While the tracer is on and ``device`` is a card: a timing-enabled
    CUDA event recorded on its current stream.  Otherwise None."""
    if not _on or device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def mark_stacked(device: torch.device) -> None:
    """Called by a bucket's closure between its stack and its plan: keeps
    a :func:`device_event` for the launch that called the closure, on this
    thread, until :func:`take_stacked`."""
    if _on and device.type == "cuda":
        _local.stacked = device_event(device)


def take_stacked():
    """The event :func:`mark_stacked` left on this thread, or None."""
    event = getattr(_local, "stacked", None)
    _local.stacked = None
    return event


def add_batch(batch: int, bucket: int, take: int, start, stacked, end) -> None:
    """Record a retired batch's device times from its three events, which
    have completed (the caller waited for ``end``)."""
    rec = BatchRecord(batch, bucket, take, start.elapsed_time(stacked),
                      stacked.elapsed_time(end))
    with _lock:
        _batches.append(rec)


def summary() -> dict[str, dict]:
    """Each recorded span name's ``count``, ``total_s`` and ``self_s`` (its
    spans' durations less the part their children cover)."""
    recs = spans()
    child_ns: dict[int, int] = defaultdict(int)
    for r in recs:
        if r.parent_id is not None:
            child_ns[r.parent_id] += r.end_ns - r.start_ns
    acc: dict[str, list[int]] = {}
    for r in recs:
        a = acc.setdefault(r.name, [0, 0, 0])
        d = r.end_ns - r.start_ns
        a[0] += 1
        a[1] += d
        a[2] += d - child_ns.get(r.span_id, 0)
    return {name: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
            for name, (c, t, s) in sorted(acc.items())}

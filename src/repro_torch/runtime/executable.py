"""Compiled execution: captured CUDA graphs, and the engine's per-bucket
batch executables.

The JAX package compiles once and replays: ``aot_compile`` lowers a
function over fixed shapes, each k-bucket of the serving engine is one
jitted program, the LM's decode step and prefill are jitted.  On a card
the port's counterpart is a CUDA graph.  :func:`capture` runs a function
once eagerly (the warm-up: lazy library set-up such as a cuBLAS workspace
happens outside the graph, and an error surfaces as the eager call's own),
then captures it over static tensors; :class:`Graph` replays it on the
current stream.  On the CPU the same entry points run eagerly, and so do
the engine's, the server's and the solvers' with ``captured=False`` (the
measured baseline).

:func:`aot_compile` returns a :class:`Captured` executable over static
inputs.  A call copies its arguments into them, replays, and returns
*copies* of the static outputs.  A result therefore stays valid after any
number of later calls, as a JAX array does.  A ring of output buffers as
deep as a caller's in-flight window would save that copy, but a caller
keeps results longer than its window: ``EngineRequest.y`` is a view of its
batch's result for as long as the caller holds it, and ``op.aot()`` callers
keep whatever they like.  The copy costs one read and one write of the
output on the device.

:func:`fused_batch_executable` binds one k-bucket's plan into one closure:
it stacks the bucket's request vectors into a preallocated ``(n, bucket)``
device slab (a burst tail arrives padded with the engine's shared zero
column) and runs the plan on it.  One closure serves every occupancy of
its bucket.  On a card the plan's run and the finite flag are one graph
over the slab (bucket 1: over a static ``(n,)`` vector); the stack, which
reads request tensors that change from batch to batch, is the copy into
the graph's input and stays outside it.

Reusing the slab across batches is safe because every batch of an engine
is enqueued on one CUDA stream: the stack for batch t+1 runs after the
graph (or kernel) of batch t has read the slab, and batch t's outputs were
copied out before batch t+1's replay rewrites them.  The plan's runner
must not return a view of its operand; none of the tuner's runners does.
The engine's repair worker probes a demoted bucket's saved closure from its
own thread, on the engine's stream, while no serving batch uses that
closure's slab.  The fleet's retune worker (``runtime.fleet``) builds,
captures and prewarms new closures on a stream of its own: each new closure
owns a new slab and new graph buffers that no serving batch has touched,
the worker waits for that stream before it stages the closures, and it
marks those buffers (``fn.buffers``) and the prepared tensors as used by
the serving stream, so the allocator does not hand their memory to the
worker's stream while a serving batch may still read it.

Captures take one process-wide lock and run on a dedicated stream per
device, in ``thread_local`` capture mode: a thread that captures (the
serving thread, the engine's repair thread, the fleet's retune worker)
does not stop the others from launching, synchronising or allocating.

The graphs of one owner share one memory pool (:class:`GraphPool`): an
engine's buckets, the closures of one fleet retune, a server's decode and
prefill graphs, a solver's blocks.  Their intermediates then take the
memory of the largest, not the sum.  Sharing is safe because an owner
replays its graphs on one stream, one at a time, and consumes each
replay's outputs (copies them out, or reads them) before its next replay:
a graph captured later may place its static outputs where an earlier one
keeps intermediates, so only an interleaved replay could overwrite them.
:class:`Captured` holds the pool's lock from its replay until its output
copies are enqueued, so the engine's serving and repair threads, which
both replay onto the engine's stream, cannot interleave there.  A fleet
retune captures into a pool of its own, since it prewarms its closures on
its own stream while the engine serves.  A standalone :func:`aot_compile`
executable has a pool of its own.

A launch captured into a graph is counted at each replay
(``kernels._build``: the capture tally).  A capture that fails raises the
error of the call that failed; it never falls back to the eager function.
Closing a failed capture uses two private calls of torch (checked against
torch 2.11): :func:`capture` refuses to start without them.

``guard=True`` (and :func:`finite_guard`) make a call return ``(ys,
all_finite)``: the flag is a 0-d boolean tensor left on the device, which
the engine reads at retirement, after the batch's event; reading it at
launch would synchronise and close the in-flight window.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import tracing

__all__ = [
    "Captured",
    "Graph",
    "GraphPool",
    "aot_compile",
    "capture",
    "finite_guard",
    "fused_batch_executable",
    "pool_bytes",
]

_capture_lock = threading.Lock()
_capture_streams: dict[int, torch.cuda.Stream] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` runs on.  High priority keeps
    it out of the pool that ``torch.cuda.Stream()`` hands to other code, so
    no other thread can enqueue onto a stream while it captures."""
    idx = _index(device)
    stream = _capture_streams.get(idx)
    if stream is None:
        stream = _capture_streams[idx] = torch.cuda.Stream(idx, priority=-1)
    return stream


def _leaves(out: Any) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _leaves(v)]
    return []


def _copy(out: Any) -> Any:
    """Fresh copies of a graph's static outputs (tensors, tuples of them)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_copy(v) for v in out)
    return out


class GraphPool:
    """The memory pool of one owner's graphs on ``device`` and the lock of
    its replays (see the module docstring).

    torch frees a pool once no graph holds it, and then refuses its handle
    to a new capture, so a graph that allocates nothing (``anchor``) holds
    the pool for as long as this object lives: a swap that drops every
    graph leaves the pool usable.  A failed capture leaves its pool's
    handle unusable for another capture (torch 2.11), so it drops the
    anchor, and the next capture takes a fresh pool.  Once the object and
    its graphs are gone, the pool's memory goes back to the card at the
    allocator's next ``empty_cache``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        with _capture_lock:
            self._renew()

    def _renew(self) -> None:
        """Take a fresh pool and capture its anchor (the caller holds the
        capture lock)."""
        self.handle = torch.cuda.graph_pool_handle()
        with torch.cuda.device(self.device):
            side = _capture_stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._flag = torch.zeros((), device=self.device)
                anchor = torch.cuda.CUDAGraph()
                anchor.capture_begin(pool=self.handle, capture_error_mode="thread_local")
                self._flag.zero_()
                anchor.capture_end()
        self.anchor = anchor


class Graph:
    """One captured CUDA graph and the kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, pool: GraphPool, tally):
        self.graph = graph
        self.pool = pool
        self.tally = tally  # kernel name -> launches per replay

    def replay(self) -> None:
        """Enqueue the graph on the current stream; its launches count."""
        self.graph.replay()
        if self.tally:
            _build.add_replay(self.tally)


def pool_bytes(pools) -> int:
    """Bytes the allocator holds in ``pools`` (anything with a pool
    ``handle``, as :class:`GraphPool`): the static outputs and the
    intermediates of their graphs."""
    handles = {tuple(p.handle) for p in pools}
    if not handles:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in handles)


def _pool_calls():
    """torch's private calls that end a capture's allocation to its pool
    and drop the capture's hold on the pool.  ``capture_end`` makes both
    calls itself, but skips them when the capture was invalidated, so a
    failed capture needs them (checked against torch 2.11)."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    release = getattr(torch._C, "_cuda_releasePool", None)
    if end is None or release is None:
        raise RuntimeError(
            f"torch {torch.__version__} has no torch._C._cuda_endAllocateToPool "
            "or torch._C._cuda_releasePool, which close the memory pool of a "
            "failed CUDA graph capture (checked against torch 2.11)")
    return end, release


def _close_failed_capture(graph: torch.cuda.CUDAGraph, pool: GraphPool,
                          device) -> None:
    """End a capture whose captured call raised, so that the call's own
    error is what the caller sees, and the process can launch, draw random
    numbers and capture again.  A capture that a forbidden call (a
    synchronisation) invalidated cannot end cleanly: torch then skips its
    own clean-up, so the pool's allocation is ended and the capture's hold
    on it dropped here, the pool's anchor is dropped (the next capture
    into ``pool`` takes a fresh one), and an empty capture that does end
    takes the random generators out of capture mode."""
    try:
        graph.capture_end()
        return
    except Exception:
        pass
    end_pool, release_pool = _pool_calls()
    idx = _index(device)
    try:
        end_pool(idx, pool.handle)
    except RuntimeError:
        pass  # capture_end ended the allocation before it raised
    release_pool(idx, pool.handle)
    pool.anchor = None
    reset = torch.cuda.CUDAGraph()
    reset.capture_begin(capture_error_mode="thread_local")
    torch.zeros(1, device=device)
    reset.capture_end()


def capture(fn: Callable, *args: torch.Tensor, warmup_args: tuple | None = None,
            device: torch.device | None = None,
            pool: GraphPool | None = None) -> tuple[Graph, Any]:
    """Capture ``fn(*args)`` as a CUDA graph; returns ``(graph, outputs)``.

    The outputs are static: each replay rewrites them in place, as it
    rewrites whatever ``fn`` updates in place in ``args``.  First ``fn``
    runs once eagerly on the capture stream, on ``warmup_args`` (default
    ``args``): its launches count as launches.  The current stream waits
    for the capture stream afterwards.  The graph allocates in ``pool``
    (default: a pool of its own).  An exception raised during capture
    propagates after the capture is closed.
    """
    device = torch.device(device) if device is not None else args[0].device
    _pool_calls()  # a failed capture could not be closed without them
    pool = pool if pool is not None else GraphPool(device)
    with _capture_lock, torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        side = _capture_stream(device)
        side.wait_stream(current)
        if pool.anchor is None:  # an earlier capture into it failed
            pool._renew()
        with torch.cuda.stream(side):
            fn(*(args if warmup_args is None else warmup_args))
            graph = torch.cuda.CUDAGraph()
            _build.take_tally()
            graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
            try:
                out = fn(*args)
            except BaseException:
                _close_failed_capture(graph, pool, device)
                _build.take_tally()
                raise
            try:
                graph.capture_end()
            except BaseException:
                _close_failed_capture(graph, pool, device)
                raise
            finally:
                tally = _build.take_tally()
        current.wait_stream(side)
    return Graph(graph, pool, +tally), out


class Captured:
    """``fn`` captured once over static inputs shaped as ``inputs``.

    A call copies its arguments into the static inputs, replays, and
    returns copies of the outputs (see the module docstring).  ``buffers``
    are the static tensors the graph reads and writes; ``pool`` is where
    its outputs and intermediates live (default: a pool of its own)."""

    def __init__(self, fn: Callable, *inputs: torch.Tensor, pool: GraphPool | None = None):
        self.inputs = tuple(x.detach().clone(memory_format=torch.contiguous_format)
                            for x in inputs)
        self.pool = pool if pool is not None else GraphPool(self.inputs[0].device)
        self.graph, self.outputs = capture(fn, *self.inputs, pool=self.pool)
        self.buffers = [*self.inputs, *_leaves(self.outputs)]

    def replay(self) -> Any:
        """Run the graph on the inputs as they stand; copies of the outputs."""
        with self.pool.lock:
            self.graph.replay()
            return _copy(self.outputs)

    def __call__(self, *xs: torch.Tensor) -> Any:
        if len(xs) != len(self.inputs):
            raise TypeError(f"the executable takes {len(self.inputs)} operands, "
                            f"got {len(xs)}")
        for s, x in zip(self.inputs, xs):
            if x.shape != s.shape or x.dtype != s.dtype:
                raise ValueError(
                    f"the executable was compiled for {tuple(s.shape)} {s.dtype}, "
                    f"got {tuple(x.shape)} {x.dtype}")
            s.copy_(x)
        return self.replay()


def aot_compile(fn: Callable, *example_inputs: torch.Tensor) -> Callable:
    """Compile ``fn`` once over the shapes and dtypes of ``example_inputs``.

    On a card: a :class:`Captured` executable (the example values are its
    warm-up operands).  On the CPU: ``fn`` itself, the eager path."""
    if example_inputs[0].device.type != "cuda":
        return fn
    return Captured(fn, *example_inputs)


def finite_guard(fn: Callable) -> Callable:
    """Wrap ``fn`` so every call returns ``(ys, torch.isfinite(ys).all())``."""

    def guarded(*xs):
        ys = fn(*xs)
        return ys, torch.isfinite(ys).all()

    return guarded


def fused_batch_executable(
    run: Callable[[torch.Tensor], torch.Tensor],
    *,
    bucket: int,
    n: int,
    device: torch.device,
    guard: bool = False,
    captured: bool = True,
    pool: GraphPool | None = None,
) -> Callable[..., torch.Tensor]:
    """``(x_0..x_{bucket-1}) -> ys`` for one bucket: (m,) for bucket 1,
    else (m, bucket); with ``guard`` a pair ``(ys, all_finite)``.

    On a card with ``captured`` the run is a CUDA graph over the slab, in
    ``pool`` (default: a pool of its own), and the closure exposes
    ``fn.slab``, ``fn.executable`` and ``fn.buffers``; otherwise a bucket
    wider than 1 exposes its slab as ``fn.slab``.  Between the stack and
    the plan the closure leaves the tracer its mark
    (``tracing.mark_stacked``: nothing while the tracer is off)."""
    body = finite_guard(run) if guard else run
    if captured and device.type == "cuda":
        shape = (n,) if bucket == 1 else (n, bucket)
        with tracing.span("executable.capture", {"bucket": bucket}):
            exe = Captured(body, torch.zeros(shape, dtype=torch.float32, device=device),
                           pool=pool)
        slab = exe.inputs[0]

        def replayed(*xs: torch.Tensor):
            with tracing.span("executable.stack"):
                if bucket == 1:
                    slab.copy_(xs[0])
                else:
                    torch.stack(xs, dim=1, out=slab)
            tracing.mark_stacked(device)
            with tracing.span("executable.replay"):
                return exe.replay()

        replayed.slab, replayed.executable, replayed.buffers = slab, exe, exe.buffers
        return replayed
    if bucket == 1:  # nothing to stack: the plan itself, which leaves no mark
        return body
    slab = torch.empty((n, bucket), dtype=torch.float32, device=device)

    def fn(*xs: torch.Tensor) -> torch.Tensor:
        with tracing.span("executable.stack"):
            torch.stack(xs, dim=1, out=slab)
        tracing.mark_stacked(device)
        with tracing.span("executable.run"):
            return run(slab)

    out = finite_guard(fn) if guard else fn
    out.slab = slab
    return out

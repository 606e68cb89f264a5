"""Per-bucket batch executables for the serving engine.

:func:`fused_batch_executable` binds one k-bucket's plan into one closure:
it stacks the bucket's request vectors into a preallocated ``(n, bucket)``
device slab — a burst tail arrives padded with the engine's shared zero
column — and runs the plan on it.  One closure serves every occupancy of
its bucket.  (A CUDA graph per bucket is a later step.)

Reusing the slab across batches is safe because every batch of an engine
is enqueued on one CUDA stream: the stack for batch t+1 runs after the
kernel of batch t has read the slab.  The plan's runner must not return a
view of its operand; none of the tuner's runners does.  The engine's
repair worker probes a demoted bucket's saved closure from its own thread,
on the engine's stream, while no serving batch uses that closure's slab.
The fleet's retune worker (``runtime.fleet``) builds and prewarms new
closures on a stream of its own: each new closure owns a new slab that no
serving batch has touched, the worker waits for that stream before it
stages the closures, and it marks the slab (``fn.slab``) and the prepared
tensors as used by the serving stream, so the allocator does not hand
their memory to the worker's stream while a serving batch may still read
it.

``guard=True`` (and :func:`finite_guard`) make a call return ``(ys,
all_finite)``: the flag is a 0-d boolean tensor left on the device, which
the engine reads at retirement, after the batch's event — reading it at
launch would synchronise and close the in-flight window.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["fused_batch_executable", "finite_guard"]


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
) -> Callable[..., torch.Tensor]:
    """``(x_0..x_{bucket-1}) -> ys`` for one bucket: (m,) for bucket 1,
    else (m, bucket); with ``guard`` a pair ``(ys, all_finite)``.  A
    bucket wider than 1 exposes its slab as ``fn.slab``."""
    if bucket == 1:
        return finite_guard(run) if guard else run
    slab = torch.empty((n, bucket), dtype=torch.float32, device=device)

    def fn(*xs: torch.Tensor) -> torch.Tensor:
        torch.stack(xs, dim=1, out=slab)
        return run(slab)

    out = finite_guard(fn) if guard else fn
    out.slab = slab
    return out

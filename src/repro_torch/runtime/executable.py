"""Per-bucket batch executables for the serving engine.

:func:`fused_batch_executable` binds one k-bucket's plan into one closure:
it stacks the bucket's request vectors into a preallocated ``(n, bucket)``
device slab — a burst tail arrives padded with the engine's shared zero
column — and runs the plan on it.  One closure serves every occupancy of
its bucket.  (A CUDA graph per bucket is a later step.)

Reusing the slab across batches is safe because every batch of an engine
is enqueued on one CUDA stream: the stack for batch t+1 runs after the
kernel of batch t has read the slab.  The plan's runner must not return a
view of its operand; none of the tuner's runners does.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["fused_batch_executable"]


def fused_batch_executable(
    run: Callable[[torch.Tensor], torch.Tensor],
    *,
    bucket: int,
    n: int,
    device: torch.device,
) -> Callable[..., torch.Tensor]:
    """``(x_0..x_{bucket-1}) -> ys`` for one bucket: (m,) for bucket 1,
    else (m, bucket)."""
    if bucket == 1:
        return run
    slab = torch.empty((n, bucket), dtype=torch.float32, device=device)

    def fn(*xs: torch.Tensor) -> torch.Tensor:
        torch.stack(xs, dim=1, out=slab)
        return run(slab)

    return fn

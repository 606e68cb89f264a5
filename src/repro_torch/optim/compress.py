"""int8 error-feedback gradient compression for a data-parallel reduce:
the JAX package's ``optim.compress``.

Each shard quantizes its gradient (plus the error it carried from the
last step) to int8 at the largest scale over the axis, keeps what the
quantization lost as its next error, and the int8 payloads are summed in
int32: about 4x less reduce traffic than float32.  The arithmetic is the
JAX package's, in float32, so both give the same bits.  The new error is
g - q·scale rounded once to float32, as the fused multiply-add that XLA's
CPU backend makes of the JAX package's expression rounds it; the port
forms it in float64, where q·scale (8 by 24 bits) and the difference are
exact, so the CPU and a card round the same value.  Since |g - q·scale|
<= scale/2 the difference fits float32, and g = q·scale + error holds
exactly.

The JAX package calls ``ef_compressed_psum`` inside ``shard_map``, where
``pmax`` and ``psum`` are collectives over a mesh axis.  The port drives a
mesh from one controller, so the function takes the per-shard lists along
``axis`` and its collectives are copies: every shard's scale and int32
payload move to the axis's first device and are reduced there in shard
order, and the result is copied back to every shard.  Neither package's
trainer calls it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.distributed import Mesh

__all__ = ["quantize_int8", "dequantize_int8", "ef_compressed_psum", "axis_devices"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q int8, scale float32
    scalar), scale = max(max|x| / 127, 1e-12)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices of the cells along ``axis``, every other axis at 0:
    where shard i of a per-shard list along ``axis`` lives."""
    k = mesh.axis_names.index(axis)
    coord = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.shape[axis]):
        coord[k] = i
        out.append(mesh.device_at(coord))
    return out


@torch.no_grad()
def ef_compressed_psum(grads: Sequence[torch.Tensor], errors: Sequence[torch.Tensor],
                       mesh: Mesh, axis: str):
    """Error-feedback compressed all-reduce over mesh axis ``axis``.

    ``grads[i]`` is shard i's local gradient (float32 or bf16) and
    ``errors[i]`` its carried float32 error, each on shard i's device
    (:func:`axis_devices`).  Returns (the reduced float32 gradient on every
    shard, the new errors), two lists in shard order."""
    n = mesh.shape[axis]
    if len(grads) != n or len(errors) != n:
        raise ValueError(f"axis {axis!r} has {n} shards; got {len(grads)} gradients "
                         f"and {len(errors)} errors")
    devices = axis_devices(mesh, axis)
    first = devices[0]
    g = [grad.to(torch.float32) + err for grad, err in zip(grads, errors)]
    scales = [quantize_int8(gi)[1] for gi in g]
    # pmax: the scales meet on the first device, the max goes back to each
    scale_max = scales[0].to(first)
    for s in scales[1:]:
        scale_max = torch.maximum(scale_max, s.to(first, non_blocking=True))
    sm = [scale_max.to(dev, non_blocking=True) for dev in devices]
    q = [torch.clamp(torch.round(gi / si), -127, 127).to(torch.int8)
         for gi, si in zip(g, sm)]
    new_errors = [(gi.double() - qi.double() * si.double()).float()
                  for gi, qi, si in zip(g, q, sm)]
    # psum: the int32 payloads summed on the first device in shard order
    total = q[0].to(first).to(torch.int32)
    for qi in q[1:]:
        total = total + qi.to(first, non_blocking=True).to(torch.int32)
    reduced = total.to(torch.float32) * scale_max
    return [reduced.to(dev, non_blocking=True) for dev in devices], new_errors

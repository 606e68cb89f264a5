"""The sparse engine's device mesh.

:func:`make_spmm_mesh` is the counterpart of the JAX package's function of
the same name.  It is a function, not a module constant, so importing this
module touches no device.  The LM meshes come with the models.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve
from repro_torch.core.distributed import Mesh

__all__ = ["make_spmm_mesh"]


def make_spmm_mesh(n_shards: int, *, axis: str = "shard",
                   device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh of ``n_shards`` shards for the sparse engine.

    On ``cuda`` shard p lives on visible card p mod
    ``torch.cuda.device_count()``: more shards than cards share the cards
    round-robin (on one card, all P shards share it), where the JAX package
    refuses more shards than devices.  ``mesh.n_devices`` says how many
    distinct cards it spans.  On ``cpu`` every shard is on the CPU.  With
    no card, a ``cuda`` mesh raises."""
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", p % count) for p in range(int(n_shards))]
    elif dev.type == "cpu":
        devices = [dev] * int(n_shards)
    else:
        raise ValueError(f"no mesh on device type {dev.type!r}")
    return Mesh(devices, (axis,))

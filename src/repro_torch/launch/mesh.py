"""Device meshes: the sparse engine's and the LM trainer's.

:func:`make_spmm_mesh`, :func:`make_mesh` and :func:`batch_axes` are the
counterparts of the JAX package's functions of the same names.  They are
functions, not module constants, so importing this module touches no
device.  Both factories place mesh cells round-robin on the visible cards
where the JAX package refuses a mesh larger than its device list
(ROADMAP C.15, C.32); ``mesh.n_devices`` says how many distinct cards a
mesh spans.  ``make_production_mesh`` (512 devices) comes with the dry-run
tools.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve
from repro_torch.core.distributed import LogicalCard, Mesh

__all__ = ["make_production_mesh", "make_spmm_mesh", "make_mesh", "batch_axes"]


def _cells(shape: tuple[int, ...], device) -> np.ndarray:
    """A device array of ``shape``: on ``cuda`` the cell of row-major index
    i on card i mod ``torch.cuda.device_count()``, on ``cpu`` every cell on
    the CPU, on ``meta`` cell i on ``LogicalCard(i)``.  With no
    card, a ``cuda`` device raises."""
    dev = resolve(device)
    n = int(np.prod(shape))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        flat = [torch.device("cuda", i % count) for i in range(n)]
    elif dev.type == "cpu":
        flat = [dev] * n
    elif dev.type == "meta":
        flat = [LogicalCard(i) for i in range(n)]
    else:
        raise ValueError(f"no mesh on device type {dev.type!r}")
    cells = np.empty(n, dtype=object)
    cells[:] = flat
    return cells.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "meta") -> Mesh:
    """16x16 single pod (256 cells, axes ``("data", "model")``) or 2x16x16
    (two pods, 512 cells, ``("pod", "data", "model")``).  On ``meta`` (the
    default) each cell is a logical card and ``mesh.n_devices`` is 256 or
    512; no card is needed."""
    return make_mesh(2, 16, 16, device=device) if multi_pod else make_mesh(
        1, 16, 16, device=device)


def make_spmm_mesh(n_shards: int, *, axis: str = "shard",
                   device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh of ``n_shards`` shards for the sparse engine.

    On ``cuda`` shard p lives on visible card p mod
    ``torch.cuda.device_count()``: more shards than cards share the cards
    round-robin (on one card, all P share it), where the JAX package
    refuses more shards than devices.  On ``cpu`` every shard is on the
    CPU.  With no card, a ``cuda`` mesh raises."""
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh(_cells((int(n_shards),), device), (axis,))


def make_mesh(pods: int = 1, data: int = 16, model: int = 16, *,
              device: str | torch.device = "cuda") -> Mesh:
    """The LM mesh of any (pods, data, model) factorization (the train
    launcher's): axes ``("data", "model")``, or ``("pod", "data",
    "model")`` when ``pods > 1``.  Cells are placed as
    :func:`make_spmm_mesh` places shards: round-robin over the visible
    cards in row-major order, where ``jax.make_mesh`` refuses more cells
    than devices (ROADMAP C.32); on one card every cell shares it."""
    sizes = (int(pods), int(data), int(model))
    if min(sizes) < 1:
        raise ValueError(f"pods, data and model must be >= 1, got {sizes}")
    if sizes[0] > 1:
        return Mesh(_cells(sizes, device), ("pod", "data", "model"))
    return Mesh(_cells(sizes[1:], device), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes a batch shards over: ``("pod", "data")`` or ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)

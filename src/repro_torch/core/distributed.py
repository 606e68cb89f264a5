"""Row-partitioned SpMV/SpMM over a mesh of devices: the paper's 61 private
caches at mesh scale.

The paper found the same x entries re-fetched into many private L2s.  Across
devices the same phenomenon is the traffic that makes x visible to every
shard.  Two collective schedules over a 1-D mesh axis:

* ``allgather`` — every shard gathers all of x, then multiplies its row
  shard; (P-1)/P |x| copied per shard, all before the product.
* ``ring`` — A is split into row slabs x column slabs; each shard starts
  with its own x slab and the slabs rotate one shard per step while each
  shard multiplies the matching column slab of its row slab.

One controller drives the mesh, as ``shard_map`` does in the JAX package:
:class:`Mesh` holds a device array (on a 1-D mesh, shard p's arrays live
on ``mesh.devices[p]``) and the collectives are explicit copies between them:
allgather concatenates every x slab on each shard's device, the ring moves
each slab to the next shard's device (``.to(..., non_blocking=True)``),
psum moves the partial sums to the first device and adds them in shard
order.  Several shards may share one device (``launch.mesh.make_spmm_mesh``
places them round-robin); a copy to the same device is no copy, and shards
on one device run one after another on its current stream.  There is no
multi-process (NCCL) path.

Each shard's product is :func:`local_spmm`: a gather on x and the
``csr/vector`` row sum (``torch.segment_reduce`` over the shard's row
offsets, a fixed order per row, so two runs give the same bits; float
atomics would not).  It reads a shard's stored entries only, not the
padding that makes the stacked arrays rectangular: the ring pads every
cell to the largest cell (ROADMAP C.16), and on the card
``segment_reduce`` sums a segment serially, so padding summed as one more
segment would cost more than the product.  :func:`stacked_spmm` runs
every shard of a stacked operand on one device in one pass over their
stored entries.  The operands come from :mod:`repro_torch.core.partition`,
whose arrays equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "LogicalCard", "sparse_axis", "SCHEDULES", "local_spmm", "stacked_spmm",
           "place_stacked", "assemble_rows", "allgather_spmm", "ring_spmm", "build_mesh_operand",
           "place_mesh_operand", "mesh_operand_nbytes", "mesh_spmm_runner",
           "psum_dot_runner"]

SCHEDULES = ("allgather", "ring")


@dataclasses.dataclass(frozen=True)
class LogicalCard:
    """A placeholder card of a mesh on ``meta`` (``launch.mesh``): cell
    ``index`` in row-major order.  It holds no storage; tensors reckoned on
    it are meta tensors.  ``torch.device`` keeps an 8-bit index, too few
    for a 512-cell mesh, so the cell carries its own."""

    index: int
    type = "meta"

    def __str__(self) -> str:
        return f"meta:{self.index}"


class Mesh:
    """A mesh of torch devices driven by one controller.

    ``devices`` is a device array of any shape (a flat sequence for a 1-D
    mesh, nested lists or a numpy object array for more axes), one device
    per mesh cell; ``axis_names`` names its axes.  ``shape`` is the dict
    ``{axis: size}`` and ``devices`` the cells flattened in row-major order
    (for a 1-D mesh, ``devices[p]`` holds shard p's arrays), which the
    tuner, the engine and the trainer read as they read a
    ``jax.sharding.Mesh`` in the JAX package.  :meth:`device_at` gives the
    device of a cell.  A device may appear in more than one cell (cells
    sharing one card); ``n_devices`` counts the distinct ones.  CPU and
    CUDA devices never mix.  A cell may also be a :class:`LogicalCard`
    (the dry run's placeholder meshes).
    """

    def __init__(self, devices, axis_names=("shard",)):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for index, d in np.ndenumerate(given):
            grid[index] = d if isinstance(d, LogicalCard) else torch.device(d)
        self.axis_names = tuple(axis_names)
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != grid.ndim or len(set(self.axis_names)) != grid.ndim:
            raise ValueError(f"a device array of shape {grid.shape} needs {grid.ndim} "
                             f"distinct axis names; got {self.axis_names}")
        self.devices = tuple(grid.ravel())
        types = {d.type for d in self.devices}
        if len(types) != 1:
            raise ValueError(f"a mesh never mixes device types; got {sorted(types)}")
        if types == {"cuda"} and any(d.index is None for d in self.devices):
            raise ValueError("a CUDA mesh names each card's index (cuda:<i>)")
        self._grid = grid
        self.shape = dict(zip(self.axis_names, grid.shape))

    def device_at(self, coord) -> torch.device:
        """The device of the cell at ``coord`` (one index per axis)."""
        return self._grid[tuple(int(i) for i in coord)]

    @property
    def n_devices(self) -> int:
        """Distinct devices the mesh spans."""
        return len(set(self.devices))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes} on {self.n_devices} device(s): {[str(d) for d in self.devices]})"


def sparse_axis(mesh: Mesh, axis: str | None) -> str:
    """The axis a sparse entry point (engine, solver, operator) shards
    over: ``axis``, or the mesh's only one.  The sparse lane's schedules
    are 1-D: a mesh with more axes raises."""
    if len(mesh.axis_names) != 1:
        raise ValueError(f"the sparse engine takes a 1-D mesh; this one has axes "
                         f"{mesh.axis_names}")
    return axis if axis is not None else mesh.axis_names[0]


def _row_sum(prod: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(prod, "sum", offsets=offsets, axis=0, unsafe=True)


def local_spmm(shard: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """One shard's CSR arrays times X (n_local, k) -> (rows, k).

    ``shard`` (from :func:`place_mesh_operand`) holds ``indices`` and
    ``data`` (padded), int64 row ``offsets`` (the padded ``indptr``: the
    padding rows are empty) and ``nnz``, the stored entries; only those
    are gathered and summed."""
    nnz = shard["nnz"]
    prod = shard["data"][:nnz, None] * x[shard["indices"][:nnz], :]
    return _row_sum(prod, shard["offsets"])


def place_stacked(stacked: dict[str, np.ndarray], device) -> dict[str, Any]:
    """A :func:`~repro_torch.core.partition.stack_csr_shards` result as one
    flat operand on ``device`` for :func:`stacked_spmm`: the shards' stored
    entries end to end (no padding), and int64 row offsets, each shard's
    shifted by the entries before it; a shard's padding rows are empty."""
    indptr = np.asarray(stacked["indptr"], np.int64)
    P, R = indptr.shape[0], indptr.shape[1] - 1
    nnz = indptr[:, -1]
    base = np.concatenate([[0], np.cumsum(nnz)])
    offsets = np.append((indptr[:, :-1] + base[:-1, None]).ravel(), base[-1])
    keep = np.arange(stacked["indices"].shape[1]) < nnz[:, None]
    return {
        "indices": torch.as_tensor(stacked["indices"][keep], device=device),
        "data": torch.as_tensor(stacked["data"][keep], device=device),
        "offsets": torch.as_tensor(offsets, device=device),
        "n_shards": int(P),
        "max_rows": int(R),
    }


def stacked_spmm(stacked: dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Y_p = A_p @ X for every row shard, in one pass on one device.

    ``stacked`` comes from :func:`place_stacked`, ``x`` is the full RHS
    (n, k).  One gather and one ``segment_reduce`` cover all shards (the
    JAX package runs one ``vmap``); returns (P, max_rows, k) padded row
    slabs, stitched back with :func:`assemble_rows`."""
    P, R = stacked["n_shards"], stacked["max_rows"]
    prod = stacked["data"][:, None] * x[stacked["indices"], :]
    return _row_sum(prod, stacked["offsets"]).view(P, R, x.shape[1])


def assemble_rows(ys, n_rows: Any, device=None) -> torch.Tensor:
    """Concatenate padded shard outputs, (P, max_rows, k) or a list of
    per-shard (max_rows, k) tensors, to (sum rows, k) on ``device``
    (default: the first shard's).  ``n_rows`` is the valid rows per shard
    (host ints)."""
    counts = [int(r) for r in np.asarray(n_rows)]
    dev = ys[0].device if device is None else torch.device(device)
    return torch.cat([ys[p][:r].to(dev, non_blocking=True)
                      for p, r in enumerate(counts)], dim=0)


def allgather_spmm(mesh: Mesh, axis: str, shards: Sequence[dict],
                   x_slabs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Y = A @ X with A row-partitioned and X all-gathered per shard.

    ``shards[p]`` (on ``mesh.devices[p]``) holds row shard p with global
    column indices; ``x_slabs[p]`` is X's p-th row slab on the same device.
    Every shard concatenates all slabs on its own device and multiplies.
    Returns the per-shard (rows, k) outputs, each on its shard's device."""
    out = []
    for p, dev in enumerate(mesh.devices[: mesh.shape[axis]]):
        x_full = torch.cat([s.to(dev, non_blocking=True) for s in x_slabs], dim=0)
        out.append(local_spmm(shards[p], x_full))
    return out


def ring_spmm(mesh: Mesh, axis: str, grid: Sequence[list],
              x_slabs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Ring-rotated SpMM over a (row shard x column slab) grid.

    ``grid[p][j]`` (on ``mesh.devices[p]``) is column slab j of row slab
    p, with slab-local indices.  At step s shard p multiplies column slab
    (p + s) mod P against the x slab it holds, then every slab moves one
    shard back around the ring, so shard p next holds slab p + s + 1.
    Returns the per-shard (rows, k) sums, each on its shard's device."""
    P = mesh.shape[axis]
    devs = mesh.devices[:P]
    held = list(x_slabs)
    acc: list = [None] * P
    for s in range(P):
        for p in range(P):
            part = local_spmm(grid[p][(p + s) % P], held[p])
            acc[p] = part if acc[p] is None else acc[p] + part
        if s + 1 < P:
            held = [held[(p + 1) % P].to(devs[p], non_blocking=True) for p in range(P)]
    return acc


# ---------------------------------------------------------------------------
# Mesh operands: host partition + stack for one schedule, then placement
# ---------------------------------------------------------------------------
def build_mesh_operand(a, n_shards: int, schedule: str) -> dict[str, Any]:
    """Partition ``a`` for one collective schedule; host arrays only.

    * ``allgather`` — nnz-balanced row shards (``partition.rows_balanced``)
      with global column indices.
    * ``ring`` — a (P x P) row slab x column slab grid (``grid_2d`` +
      ``stack_grid_shards``), columns zero-padded to a multiple of P so the
      x slabs divide evenly (no stored entry references the padded tail).

    Returns the stacked arrays (equal to the JAX package's) plus assembly
    metadata (``shard_rows``, ``n_pad``); :func:`place_mesh_operand` moves
    them onto a mesh."""
    from .formats import CSRMatrix
    from .partition import grid_2d, rows_balanced, stack_csr_shards, stack_grid_shards

    P_ = int(n_shards)
    m, n = a.shape
    n_pad = -(-n // P_) * P_
    if schedule == "allgather":
        part = rows_balanced(a, P_)
        stacked = stack_csr_shards(part.shards)
        shard_rows = np.diff(part.bounds)
    elif schedule == "ring":
        a_pad = a if n_pad == n else CSRMatrix((m, n_pad), a.indptr, a.indices, a.data)
        stacked = stack_grid_shards(grid_2d(a_pad, (P_, P_)))
        shard_rows = stacked["n_rows"].astype(np.int64)
    else:
        raise ValueError(f"unknown schedule {schedule!r}; use one of {SCHEDULES}")
    arrays = {key: stacked[key] for key in ("indptr", "indices", "data", "rows")}
    return {"schedule": schedule, "n_shards": P_, "arrays": arrays,
            "shard_rows": shard_rows, "n_pad": n_pad, "shape": (m, n)}


def place_mesh_operand(prep: dict[str, Any], mesh: Mesh, axis: str) -> dict[str, Any]:
    """Move a :func:`build_mesh_operand` result onto the mesh: shard p's
    ``indices``, ``data`` and int64 row ``offsets`` go to
    ``mesh.devices[p]`` (for the ring, one dict per column slab, views of
    one tensor per array), with ``nnz``, its stored entries.  The per-nnz
    ``rows`` map stays on the host: the row sum reads offsets."""
    P_ = prep["n_shards"]
    if mesh.shape[axis] != P_:
        raise ValueError(f"operand has {P_} shards, mesh axis {axis!r} "
                         f"{mesh.shape[axis]}")
    arrs = prep["arrays"]
    nnz = arrs["indptr"][..., -1]

    def shard(p: int, dev) -> Any:
        t = {key: torch.as_tensor(arrs[key][p], device=dev)
             for key in ("indices", "data")}
        t["offsets"] = torch.as_tensor(arrs["indptr"][p].astype(np.int64), device=dev)
        if prep["schedule"] == "allgather":
            return {**t, "nnz": int(nnz[p])}
        return [{key: v[j] for key, v in t.items()} | {"nnz": int(nnz[p, j])}
                for j in range(P_)]

    placed = [shard(p, dev) for p, dev in enumerate(mesh.devices[:P_])]
    return {**prep, "placed": placed, "devices": mesh.devices[:P_]}


def mesh_operand_nbytes(prep: dict[str, Any]) -> int:
    """Bytes a placed mesh operand holds on its devices (each tensor once,
    however many views of it the ring's cells hold)."""
    seen: dict[int, int] = {}
    shards = [s if isinstance(s, list) else [s] for s in prep["placed"]]
    for cells in shards:
        for cell in cells:
            for t in cell.values():
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _split_rows(x: torch.Tensor, n_pad: int, devices) -> list[torch.Tensor]:
    """X (n, k) zero-padded to n_pad rows and cut into len(devices) row
    slabs, slab p moved to devices[p]."""
    P_ = len(devices)
    xp = torch.zeros((n_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[: x.shape[0]] = x
    step = n_pad // P_
    return [xp[p * step:(p + 1) * step].to(dev, non_blocking=True)
            for p, dev in enumerate(devices)]


def mesh_spmm_runner(mesh: Mesh, axis: str, prep: dict[str, Any]):
    """Bind a placed mesh operand into ``fn(x) -> y`` for serving.

    ``x`` is (n,) or (n, k) on the mesh's first device.  It is zero-padded
    to the schedule's padded column count and cut into row slabs, one on
    each shard's device; the schedule runs, and the padded per-shard row
    slabs are stitched back in row order on the first device, where the
    caller waits for the result.  The JAX package can donate x to its
    program; here there is no buffer donation (the padded copy is new each
    call)."""
    n_pad, shard_rows = prep["n_pad"], prep["shard_rows"]
    placed, devices = prep["placed"], prep["devices"]
    sched = allgather_spmm if prep["schedule"] == "allgather" else ring_spmm
    first = devices[0]

    def fn(x: torch.Tensor) -> torch.Tensor:
        x2 = x[:, None] if x.dim() == 1 else x
        ys = sched(mesh, axis, placed, _split_rows(x2, n_pad, devices))
        y = assemble_rows(ys, shard_rows, device=first)
        return y[:, 0] if x.dim() == 1 else y

    return fn


def psum_dot_runner(mesh: Mesh, axis: str, n: int):
    """``dot(u, v)`` as a mesh reduction: the solver's dots (r^T r, p^T A p,
    Rayleigh quotients) reduce over the same shards as its product.

    u and v, (n,) or (n, k) on the first device, are cut into the
    schedules' row slabs (n zero-padded to a multiple of P; the padding
    adds nothing, so the slabs are views and the last one may be short);
    shard p sums its slab's products on its own device, and the partial
    sums are moved to the first device and added in shard order.  (n, k)
    reduces per column -> (k,)."""
    P_ = int(mesh.shape[axis])
    devices = mesh.devices[:P_]
    step = -(-int(n) // P_)
    first = devices[0]

    def dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        total = None
        for p, dev in enumerate(devices):
            part = (u[p * step:(p + 1) * step].to(dev, non_blocking=True)
                    * v[p * step:(p + 1) * step].to(dev, non_blocking=True)).sum(0)
            part = part.to(first, non_blocking=True)
            total = part if total is None else total + part
        return total

    return dot

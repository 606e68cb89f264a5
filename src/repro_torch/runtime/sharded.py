"""A model's training state held as blocks on an LM mesh: the storage of
the sharded train step (``runtime.trainer.make_sharded_train_step``).

The JAX package places each parameter and optimizer leaf with a
``NamedSharding`` and lets GSPMD move the data.  The port drives the mesh
from one controller (as the SpMM mesh does, ``core.distributed``), so the
placement and the collectives are explicit:

* **Blocks.**  A leaf's fitted spec (``launch.shardspecs.fit_spec``) cuts
  it into a grid of equal blocks, ``n_i`` along dimension i (the product of
  the sizes of the mesh axes that split it).  Block b is what the mesh
  cells whose coordinates map to b hold; it lives once, on the card of the
  first such cell in row-major order, its *owner*.  Cells that differ only
  along an axis that does not split the leaf would hold replicas under
  GSPMD; here they read the owner's block when they gather.  So on one
  card a sharded state takes what the unsharded state takes, and on
  several cards each block is held once.
* **Stacks.**  The blocks a card owns are one tensor, (n_owned, *block
  shape), in row-major block order.  A block's update is elementwise, so
  updating a card's stack in one call gives every block the bits its own
  update would: a leaf costs the launches of the unsharded update per
  owning card.
* **Gather** (:meth:`ShardedModel.compute`): a card that runs a batch
  replica assembles every leaf from its blocks into the full parameter of
  a compute model it keeps (an all-gather by copies: one permuted copy
  per leaf from a stack on the same card, an index copy per other owning
  card).  Replicas that share a card share its compute model.
* **Reduce** (:func:`reduce_into`): a replica's full gradient is cut into
  blocks and added onto each block's owner, replicas in shard order, so two
  runs give the same bits (a reduce-scatter by copies).

Nothing here reads a device value on the host.  A checkpoint gathers the
blocks to the host in the logical layout (:meth:`ShardedModel.state_dict`,
:meth:`ShardedModel.host`) and :meth:`ShardedModel.load` slices a logical
state onto whatever mesh it is restored to.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.distributed import Mesh
from repro_torch.launch.shardspecs import axis_size
from repro_torch.models.lm import LM, ModelConfig, param_axes, trainable

__all__ = ["Layout", "leaf_layout", "ShardedModel", "scatter", "gather", "reduce_into",
           "owned_parts", "accumulate"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one leaf's blocks live.  ``grid`` is the blocks per dimension,
    ``block`` a block's shape, ``owned`` each owning device's row-major
    block indices (the rows of its stack, in order)."""

    shape: tuple[int, ...]
    spec: tuple
    grid: tuple[int, ...]
    block: tuple[int, ...]
    owned: dict[torch.device, tuple[int, ...]]

    @property
    def n_blocks(self) -> int:
        return math.prod(self.grid)

    def sole_owner(self) -> torch.device | None:
        """The device that owns every block, if one does."""
        return next(iter(self.owned)) if len(self.owned) == 1 else None

    def interleaved(self) -> tuple[int, ...]:
        """The leaf viewed as (n_0, s_0, n_1, s_1, ...)."""
        return tuple(x for n, s in zip(self.grid, self.block) for x in (n, s))

    def blocks_first(self) -> tuple[int, ...]:
        """The permutation of :meth:`interleaved` to (n_0, n_1, ..., s_0, s_1, ...)."""
        k = len(self.shape)
        return tuple(range(0, 2 * k, 2)) + tuple(range(1, 2 * k, 2))


def _block_coord(mesh: Mesh, coord: tuple[int, ...], axes) -> int:
    """The block index along one dimension of the cell at ``coord``: the
    row-major index of its coordinates along ``axes`` (the first axis
    major, as ``PartitionSpec`` orders a tuple)."""
    if axes is None:
        return 0
    index = 0
    for a in (axes,) if isinstance(axes, str) else axes:
        index = index * mesh.shape[a] + coord[mesh.axis_names.index(a)]
    return index


def leaf_layout(mesh: Mesh, spec: tuple, shape) -> Layout:
    """The block layout of a leaf of ``shape`` under its fitted ``spec``."""
    shape = tuple(int(s) for s in shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    grid = tuple(axis_size(mesh, a) for a in spec)
    if any(s % n for s, n in zip(shape, grid)):
        raise ValueError(f"spec {spec} does not divide shape {shape}; fit it first")
    owner: dict[int, torch.device] = {}
    for coord in np.ndindex(*mesh.shape.values()):
        b = tuple(_block_coord(mesh, coord, a) for a in spec)
        owner.setdefault(int(np.ravel_multi_index(b, grid)) if grid else 0,
                         mesh.device_at(coord))
    owned: dict[torch.device, list[int]] = {}
    for b in sorted(owner):
        owned.setdefault(owner[b], []).append(b)
    return Layout(shape, spec, grid, tuple(s // n for s, n in zip(shape, grid)),
                  {d: tuple(ix) for d, ix in owned.items()})


def _blocks_view(layout: Layout, full: torch.Tensor) -> torch.Tensor:
    """``full`` as (n_0, ..., s_0, ...): block-major, a strided view."""
    return full.reshape(layout.interleaved()).permute(layout.blocks_first())


def _stack_view(layout: Layout, stack: torch.Tensor) -> torch.Tensor:
    """A sole owner's stack (n_blocks, *block) as (n_0, ..., s_0, ...)."""
    return stack.view(*layout.grid, *layout.block)


def scatter(layout: Layout, full: torch.Tensor) -> dict:
    """``{owner: stack}`` of ``full``'s blocks, each a new tensor on its owner."""
    out = {}
    for dev, ix in layout.owned.items():
        stack = torch.empty((len(ix), *layout.block), dtype=full.dtype, device=dev)
        load_blocks(layout, {dev: stack}, full)
        out[dev] = stack
    return out


@torch.no_grad()
def load_blocks(layout: Layout, stacks: dict, full: torch.Tensor) -> None:
    """Write ``full`` (a whole leaf, on any device) into ``stacks`` in place."""
    view = _blocks_view(layout, full)
    for dev, stack in stacks.items():
        ix = layout.owned[dev]
        if len(ix) == layout.n_blocks:
            _stack_view(layout, stack).copy_(view)
        else:
            rows = view.reshape(layout.n_blocks, *layout.block)[list(ix)]
            stack.copy_(rows)


@torch.no_grad()
def gather(layout: Layout, stacks: dict, out: torch.Tensor, device=None,
           tally: dict | None = None) -> torch.Tensor:
    """Assemble a leaf from its ``stacks`` into ``out`` (the whole leaf, on
    the gathering device ``device``, by default ``out``'s) and return it:
    one permuted copy where that device owns every block, else an index
    copy per owning device first.  ``tally``, if given, gains the bytes
    copied from other devices under ``device``."""
    dev = out.device if device is None else device
    if layout.sole_owner() == dev:
        full_blocks = _stack_view(layout, stacks[dev])
    else:
        flat = torch.empty((layout.n_blocks, *layout.block), dtype=out.dtype,
                           device=out.device)
        for owner, ix in layout.owned.items():
            rows = torch.as_tensor(ix, device=out.device)
            part = stacks[owner].to(out.device, non_blocking=True)
            if tally is not None and owner != dev:
                tally[dev] = tally.get(dev, 0) + part.numel() * part.element_size()
            flat.index_copy_(0, rows, part)
        full_blocks = _stack_view(layout, flat)
    out.view(layout.interleaved()).copy_(full_blocks.permute(_inverse(layout)))
    return out


def _inverse(layout: Layout) -> tuple[int, ...]:
    perm = layout.blocks_first()
    return tuple(int(i) for i in np.argsort(perm))


@torch.no_grad()
def reduce_into(layout: Layout, acc: dict, g: torch.Tensor, dtype, src=None,
                tally: dict | None = None) -> None:
    """Add one replica's full gradient ``g`` (computed on ``src``, by
    default ``g``'s device) onto each block's owner: ``acc`` is ``{owner:
    stack}`` in ``dtype``; a missing stack is made from ``g``'s blocks (the
    first replica), later replicas add to it.  ``tally``, if given, gains
    the bytes copied to each owner other than ``src``."""
    src = g.device if src is None else src
    for dev, ix, part in owned_parts(layout, g):
        part = part.to(dev, non_blocking=True)  # the same tensor on g's device
        if tally is not None and dev != src:
            tally[dev] = tally.get(dev, 0) + part.numel() * part.element_size()
        accumulate(layout, acc, dev, ix, part, dtype)


def owned_parts(layout: Layout, g: torch.Tensor):
    """``(owner, block indices, part)`` for each owner of a leaf's blocks,
    the parts on ``g``'s device (the replica's): the block view of ``g``
    itself where one owner holds every block, else rows of one contiguous
    copy of the blocks (one copy a leaf, not one an owner)."""
    view = _blocks_view(layout, g)
    flat = None
    for dev, ix in layout.owned.items():
        if len(ix) == layout.n_blocks:
            yield dev, ix, view
            continue
        if flat is None:
            flat = view.reshape(layout.n_blocks, *layout.block)
        yield dev, ix, flat[list(ix)]


def accumulate(layout: Layout, acc: dict, dev, ix, part: torch.Tensor, dtype) -> None:
    """Owner ``dev``'s half of a reduction: copy ``part`` (its blocks ``ix``,
    on its card) into a new ``acc[dev]`` in ``dtype``, or add it."""
    if dev not in acc:
        acc[dev] = torch.empty((len(ix), *layout.block), dtype=dtype, device=part.device)
        _rows(layout, acc[dev], ix).copy_(part)
    else:
        _rows(layout, acc[dev], ix).add_(part)


def _rows(layout: Layout, stack: torch.Tensor, ix) -> torch.Tensor:
    return _stack_view(layout, stack) if len(ix) == layout.n_blocks else stack


class ShardedModel:
    """A model's trainable parameters as blocks on ``mesh`` by ``specs``
    (fitted, ``{name: spec}``), built from ``model``, the whole model on
    the mesh's first device, which becomes that device's compute model.

    ``blocks[name]`` is ``{owner: stack}``, ``layouts[name]`` its
    :class:`Layout` and ``axes[name]`` its logical axes.  :meth:`compute`
    gathers the weights onto a device's compute model; :meth:`state_dict`
    and :meth:`host` give the logical (whole-leaf) state on the host,
    :meth:`load` writes one back.  ``copied`` counts the bytes the
    gathers and reductions have copied between distinct devices, by kind
    (``"gather"``, ``"reduce"``) and receiving device."""

    def __init__(self, cfg: ModelConfig, model: LM, mesh: Mesh, specs: dict):
        self.cfg, self.mesh, self.specs = cfg, mesh, dict(specs)
        self.device = mesh.devices[0]
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the mesh's first device "
                             f"is {self.device}")
        params = trainable(model)
        axes = param_axes(cfg, model)
        self.axes = {n: axes[n] for n in params}
        self.layouts = {n: leaf_layout(mesh, self.specs[n], p.shape)
                        for n, p in params.items()}
        self.dtypes = {n: p.dtype for n, p in params.items()}
        self.blocks = {n: scatter(self.layouts[n], p.detach()) for n, p in params.items()}
        self._compute = {self.device: model}
        self.copied: dict[str, dict] = {"gather": {}, "reduce": {}}

    def compute(self, device: torch.device) -> LM:
        """``device``'s compute model with every trainable leaf gathered
        from its blocks (its buffers are the model's own, fixed by the
        config)."""
        model = self._compute.get(device)
        if model is None:
            model = self._compute[device] = LM(self.cfg, device)
        for name, p in trainable(model).items():
            gather(self.layouts[name], self.blocks[name], p.data, device,
                   self.copied["gather"])
        return model

    def full(self, name: str, tree: dict | None = None, device="cpu") -> torch.Tensor:
        """The whole leaf ``name`` of ``tree`` (default: the parameters)
        assembled on ``device``."""
        stacks = (self.blocks if tree is None else tree)[name]
        dtype = next(iter(stacks.values())).dtype
        out = torch.empty(self.layouts[name].shape, dtype=dtype, device=device)
        return gather(self.layouts[name], stacks, out)

    def host(self, tree: dict) -> dict:
        """Every leaf of ``tree`` (``{name: {owner: stack}}``) on the host."""
        return {name: self.full(name, tree) for name in tree}

    def state_dict(self) -> dict:
        """The logical state on the host, in ``LM.state_dict()``'s order:
        the gathered parameters and the first compute model's buffers."""
        own = self._compute[self.device].state_dict()
        return {name: self.full(name) if name in self.blocks else t.detach().cpu()
                for name, t in own.items()}

    def leaf_dtypes(self) -> dict:
        """``{name: dtype}`` of :meth:`state_dict`'s leaves, with no copy."""
        return {name: t.dtype for name, t in self._compute[self.device].state_dict().items()}

    @torch.no_grad()
    def load(self, named: dict, tree: dict | None = None) -> None:
        """Write whole leaves (``{name: tensor}``, any device) into ``tree``
        (default: the parameters; a buffer goes to every compute model)."""
        target = self.blocks if tree is None else tree
        for name, value in named.items():
            if name in target:
                stacks = target[name]
                dtype = next(iter(stacks.values())).dtype
                load_blocks(self.layouts[name], stacks, value.to(dtype))
            elif tree is None:
                for model in self._compute.values():
                    model.state_dict()[name].copy_(value)

    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for b in self.blocks.values()
                   for s in b.values())

"""Production dry run: what every (architecture x input shape x mesh) cell
costs one card under the port's own placement, with no card.  The port's
counterpart of the JAX package's ``launch.dryrun``.

The JAX package lowers and compiles each cell on 512 placeholder XLA host
devices and reads FLOPs, HBM bytes and collective bytes off the HLO
(``launch.hlo_analysis``).  torch cannot lower onto placeholder devices;
the port runs its own step functions on ``meta`` tensors under
:class:`~repro_torch.launch.op_analysis.OpAnalyzer` and reckons the mesh
from its own layouts (``launch.mesh.make_production_mesh``: 256 or 512
logical cards).

**Placement reckoned** (the sharded train step's, ``runtime.sharded`` and
``runtime.trainer.make_sharded_train_step``): parameters and AdamW's state
are block stacks by ``rules_for(mesh)`` (``leaf_layout``); each microbatch
is split over the batch axes (``batch_shardings``); each batch replica
gathers the whole weights onto its card (``ShardedModel.compute``) and runs
``loss_fn`` and autograd there; each gradient is added onto the blocks'
owners (``reduce_into``), and each owner runs AdamW on its stacks
(``update_leaf``).  Prefill and decode cells reckon the same weights, held
by each replica as a compute model that stays between calls, and the
decode state stored by ``decode_state_shardings``: a replica gathers its
rows' state from their owners before a step and sends it back after
(kinds ``state_gather`` and ``state_scatter``).  The port serves no LM on
a mesh yet; the record's ``placement`` names what was reckoned.

**Per device** is the busiest card: the card whose largest roofline term
(``launch.roofline``) is largest.  Cards with the same work (replicas,
owned blocks, sole ownerships) form a class, and one card of each class
is costed by running the runtime's own functions for it on meta tensors:
one replica's traced step (``loss_fn`` and autograd of a microbatch, times
the microbatches), the gathers onto its card, its half of each reduction,
its update and its scalars.  Collective bytes are the bytes a card
receives from other cells (gathers, reductions; the layouts' own arithmetic,
not ring factors of collectives the port does not run).  The record also
carries the mesh's totals (every class times its size) and the number of
compute cards, for conservation checks.

**Depth.**  A model of more than ``DEPTH_FULL`` repeating units (layers; a
hybrid's super-blocks) is traced at one and two units and extrapolated
linearly (exact for identical units): the pieces carry the scales, and
``depth`` in the record says so.  Every token of a train or prefill
sequence is traced, RWKV-6's per-token loop and Mamba-2's per-chunk loop
included: the backward of an eager token loop is quadratic in the
sequence (each token's ``select`` gradient is a zero-filled full-length
tensor, and those add up), so a few tokens scaled linearly would
understate it.  A decode cell is one token.  Microbatches of one shape are
traced once and scaled by their count (``n_micro``).

**No fallback.**  A cell that reaches a kernel (the wrappers raise on a
meta tensor: a ``bcsr`` variant) or fails to trace records ``status:
error``; nothing switches tiers.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k \\
      --variant skip_masked_blocks=True --tag triangular
  python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape decode_32k --reduced

Each cell writes ``<arch>__<shape>__<mesh>__<tag>.json`` and, beside it,
the per-op trace ``.ops.json.gz`` that ``launch.rescore`` re-scores.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import gzip
import json
import math
import os
import time
import traceback
from collections import Counter

import numpy as np
import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ShapeSpec,
    cell_supported,
    get_config,
    get_reduced,
    input_specs,
)
from repro_torch.core.distributed import Mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpAnalyzer, OpCost, rows_cost
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.shardspecs import (
    axis_size,
    batch_shardings,
    decode_state_shardings,
    fit_tree,
    rules_for,
)
from repro_torch.models.common import set_active_rules
from repro_torch.models.lm import (
    ModelConfig,
    decode_step,
    init_decode_state,
    init_model,
    param_axes,
    prefill,
    trainable,
)
from repro_torch.optim.adamw import OptimConfig, adamw_init, step_scalars, update_leaf
from repro_torch.runtime.sharded import accumulate, gather, leaf_layout, owned_parts
from repro_torch.runtime.trainer import (
    _grads_of,
    _split_micro,
    _sum_on,
    make_train_step,
    replica_device,
    shardings_for,
)

__all__ = ["TRAIN_KNOBS", "DEPTH_FULL", "OUTDIR", "apply_variant", "card_bytes",
           "analyze_train_step",
           "analyze_decode_step", "reckon_cell", "run_cell", "card_costs", "main"]

OUTDIR = "experiments/dryrun_torch"
DEPTH_FULL = 4  # repeating units traced whole at or below this count
METRICS = ("loss", "lr", "grad_norm", "ce", "z_loss", "aux")

# Per-arch dry-run knobs: microbatch count for the 1M-token train batches and
# optimizer dtype trims for the biggest models (the JAX package's).
TRAIN_KNOBS: dict[str, dict] = {
    "llama3-405b": {"microbatches": 16, "moment_dtype": torch.bfloat16},
    "deepseek-67b": {"microbatches": 8},
    "qwen2-vl-72b": {"microbatches": 8},
    "llama4-scout-17b-a16e": {"microbatches": 8},
    "rwkv6-7b": {"microbatches": 4},
    "zamba2-2.7b": {"microbatches": 4},
    "h2o-danube-3-4b": {"microbatches": 4},
    "qwen1.5-4b": {"microbatches": 4},
    "granite-moe-1b-a400m": {"microbatches": 2},
    "whisper-tiny": {"microbatches": 2},
}


def apply_variant(cfg: ModelConfig, variant: dict) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(cfg)}
    updates = {k: v for k, v in variant.items() if k in fields}
    if isinstance(updates.get("sparse_ffn"), str):
        # e.g. --variant sparse_ffn=structured -> the paper technique as the
        # FFN layer, 16 diagonal groups + 1-group banded halo
        from repro_torch.models.ffn import SparseFFNConfig

        updates["sparse_ffn"] = SparseFFNConfig(
            kind=updates["sparse_ffn"], n_groups=16, band=1
        )
    return dataclasses.replace(cfg, **updates) if updates else cfg


# ---------------------------------------------------------------------------
# traced pieces
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Piece:
    """The ops of one traced piece of work: rows (op, ins, outs) -> calls,
    its peak of live bytes and its live bytes at the end."""

    rows: Counter
    peak_bytes: float = 0.0
    end_bytes: float = 0.0

    @classmethod
    def of(cls, an: OpAnalyzer) -> "Piece":
        return cls(Counter(an.rows), an.peak_bytes, an.live_bytes)

    def cost(self) -> OpCost:
        return rows_cost((op, ins, outs, n) for (op, ins, outs), n in self.rows.items())

    def add(self, other: "Piece", k: int = 1) -> None:
        for key, n in other.rows.items():
            self.rows[key] += n * k

    def json(self) -> dict:
        return {"rows": [[op, [list(s) for s in ins], [list(s) for s in outs], n]
                         for (op, ins, outs), n in self.rows.items()],
                "peak_bytes": self.peak_bytes, "end_bytes": self.end_bytes,
                "n_ops": sum(self.rows.values())}


def _traced(fn) -> Piece:
    with OpAnalyzer() as an:
        out = fn()
        piece = Piece.of(an)
    del out
    return piece


def _units(cfg: ModelConfig) -> int | None:
    """The repeating units of ``cfg`` that depth extrapolation counts:
    layers, or a hybrid's super-blocks; None for an encoder-decoder
    (whose two stacks are traced whole)."""
    if cfg.family == "audio":
        return None
    return cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid" else cfg.n_layers


def _cut(cfg: ModelConfig, units: int) -> ModelConfig:
    per = cfg.hybrid_period if cfg.family == "hybrid" else 1
    return dataclasses.replace(cfg, n_layers=units * per)


def depth_pieces(cfg: ModelConfig, work) -> tuple[list, dict]:
    """``work(cfg_u)`` (a thunk's factory: the traced work of a model of
    ``cfg_u``) at full depth, or at one and two units with scales that
    extrapolate linearly to the full count: ``([(Piece, scale)], depth
    record)``."""
    n = _units(cfg)
    if n is None or n <= DEPTH_FULL:
        return [(_traced(work(cfg)), 1.0)], {"traced": "full"}
    one, two = _traced(work(_cut(cfg, 1))), _traced(work(_cut(cfg, 2)))
    return ([(one, float(2 - n)), (two, float(n - 1))],
            {"traced": "1 and 2 units, extrapolated", "units": n})


def _scaled_peak(pieces) -> float:
    return sum(p.peak_bytes * k for p, k in pieces)


def _meta_like(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


MIB = 2**20


def card_bytes(n: int) -> int:
    """Bytes the CUDA caching allocator holds for one tensor of ``n``
    bytes given its own segment: ``n`` rounded up to 512; above 1 MiB the
    segment is 20 MiB (under 10 MiB) or ``n`` rounded up to 2 MiB, and the
    block keeps the segment's remainder unless it exceeds 1 MiB (the
    allocator splits off only larger ones).  A state built tensor by
    tensor on a card holds this (17a of ``chip_smoke.py``: within 1 %)."""
    if n <= 0:
        return 0
    r = max(512, -(-n // 512) * 512)
    if r <= MIB:
        return r
    seg = 20 * MIB if r < 10 * MIB else -(-r // (2 * MIB)) * 2 * MIB
    return seg if seg - r <= MIB else r


def _tree_bytes(tree, held: bool = False) -> int:
    """The bytes of a tree's tensors; ``held``: as the allocator holds them
    (:func:`card_bytes` of each)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, held) for v in tree.values())
    if not isinstance(tree, torch.Tensor):
        return 0
    return card_bytes(_nbytes(tree)) if held else _nbytes(tree)


def _rows_of(specs: dict, n_rep: int) -> dict:
    """One replica's share of a batch of meta tensors (``positions`` split
    on its second axis)."""
    out = {}
    for key, t in specs.items():
        if key == "positions":
            out[key] = _meta_like((t.shape[0], t.shape[1] // n_rep, *t.shape[2:]), t.dtype)
        else:
            out[key] = _meta_like((t.shape[0] // n_rep, *t.shape[1:]), t.dtype)
    return out


# ---------------------------------------------------------------------------
# one device: the whole step traced
# ---------------------------------------------------------------------------
def analyze_train_step(cfg: ModelConfig, batch: dict, opt_cfg: OptimConfig,
                       n_micro: int = 1) -> dict:
    """The single-device train step (``make_train_step``) of ``cfg`` on a
    batch of meta tensors, traced whole on ``meta``: ``{"cost", "piece",
    "argument_bytes", "temp_bytes", "output_bytes", "n_ops"}``, the
    arguments being the model's state and AdamW's as the allocator holds
    them (:func:`card_bytes`), the temporaries the traced peak."""
    model = init_model(cfg, device="meta")
    opt_state = adamw_init(trainable(model), opt_cfg)
    step = make_train_step(cfg, opt_cfg, n_micro)
    with OpAnalyzer() as an:
        _, _, metrics = step(model, opt_state, batch)
        piece = Piece.of(an)
    return {"cost": piece.cost(), "piece": piece,
            "argument_bytes": (_tree_bytes(model.state_dict(), True)
                               + _tree_bytes(opt_state, True)),
            "temp_bytes": piece.peak_bytes, "output_bytes": _tree_bytes(metrics),
            "n_ops": an.n_ops, "n_compute_ops": an.n_compute_ops}


def analyze_decode_step(cfg: ModelConfig, slots: int, max_seq: int) -> dict:
    """One ``decode_step`` of ``cfg`` at ``slots`` sequences and a
    ``max_seq`` cache, traced on ``meta``; its arguments are the model's
    state and the decode state."""
    model = init_model(cfg, device="meta")
    state = init_decode_state(cfg, slots, max_seq, device="meta")
    tokens = _meta_like((slots, 1), torch.int32)
    with OpAnalyzer() as an:
        _, logits = decode_step(cfg, model, state, tokens)
        piece = Piece.of(an)
    return {"cost": piece.cost(), "piece": piece,
            "argument_bytes": (_tree_bytes(model.state_dict(), True)
                               + _tree_bytes(state, True)),
            "temp_bytes": piece.peak_bytes, "output_bytes": _nbytes(logits),
            "n_ops": an.n_ops, "n_compute_ops": an.n_compute_ops}


# ---------------------------------------------------------------------------
# a mesh: the placement reckoned card by card
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Group:
    """Leaves of one shape, fitted spec and dtype (a layer's leaves repeat
    per layer): their layout and names."""

    shape: tuple
    spec: tuple
    dtype: torch.dtype
    layout: object
    names: list


def _groups(mesh: Mesh, cfg: ModelConfig, rules) -> tuple[list, object]:
    model = init_model(cfg, device="meta")
    params = trainable(model)
    axes = param_axes(cfg, model)
    specs = fit_tree(mesh, shardings_for(mesh, rules, {n: axes[n] for n in params}), params)
    by: dict = {}
    for name, p in params.items():
        key = (tuple(p.shape), specs[name], p.dtype)
        by.setdefault(key, []).append(name)
    groups = [Group(shape, spec, dtype, leaf_layout(mesh, spec, shape), names)
              for (shape, spec, dtype), names in by.items()]
    return groups, model


def _stacks(layout, dtype) -> dict:
    return {owner: _meta_like((len(ix), *layout.block), dtype)
            for owner, ix in layout.owned.items()}


def _class_key(card, groups, replicas: Counter, first, state_layouts=()) -> tuple:
    return (replicas.get(card, 0), card == first,
            tuple((len(g.layout.owned.get(card, ())), g.layout.sole_owner() == card)
                  for g in groups),
            tuple(len(lay.owned.get(card, ())) for _, _, lay in state_layouts))


def _block_bytes(layout, itemsize: int) -> int:
    return math.prod(layout.block) * itemsize


def _stacks_held(card, groups, itemsize: int | None = None) -> int:
    """What ``card``'s stacks of every leaf hold (one allocation a leaf, as
    :func:`card_bytes`), in the leaves' dtype or ``itemsize`` bytes an
    element."""
    return sum(len(g.names) * card_bytes(len(g.layout.owned.get(card, ())) * _block_bytes(
        g.layout, itemsize or g.dtype.itemsize)) for g in groups)


def _train_received(card, groups, replicas: Counter, n_micro: int) -> dict:
    """Bytes ``card`` receives from other cells in one train step, by kind,
    from the layouts: a replica's card gathers every block it does not own
    (whole stacks of each other owner), and an owner receives its blocks of
    every replica's gradient computed elsewhere, once per microbatch."""
    gathered = reduced = 0
    hosts = replicas.get(card, 0)
    elsewhere = sum(k for d, k in replicas.items() if d != card)
    for g in groups:
        blk = _block_bytes(g.layout, g.dtype.itemsize)
        own = len(g.layout.owned.get(card, ()))
        if hosts:
            gathered += len(g.names) * (g.layout.n_blocks - own) * blk
        reduced += len(g.names) * own * blk * elsewhere * n_micro
    return {k: v for k, v in (("gather", gathered), ("reduce", reduced)) if v}


def _state_received(card, rep_devs: list, state_layouts) -> int:
    """Bytes of the decode state that the replicas on ``card`` need for
    their rows and other cells own: blocks whose rows along the batch
    dimension meet a replica's rows."""
    total = 0
    n_rep = len(rep_devs)
    mine = [r for r, d in enumerate(rep_devs) if d == card]
    for t, bdim, lay in state_layouts:
        rows = lay.shape[bdim] // n_rep
        per_row = _block_bytes(lay, t.element_size()) // lay.block[bdim]
        for owner, ix in lay.owned.items():
            if owner == card:
                continue
            starts = np.unravel_index(np.asarray(ix), lay.grid)[bdim] * lay.block[bdim]
            for r in mine:
                lo, hi = r * rows, (r + 1) * rows
                overlap = np.clip(np.minimum(starts + lay.block[bdim], hi)
                                  - np.maximum(starts, lo), 0, None)
                total += int(overlap.sum()) * per_row
    return total


def _state_layouts(mesh: Mesh, cfg: ModelConfig, state: dict) -> list:
    """(leaf, batch dimension, layout) of every decode-state leaf, by
    ``decode_state_shardings``."""
    specs = decode_state_shardings(mesh, cfg, state)
    out = []

    def walk(tree, spec, group):
        for key, t in tree.items():
            if isinstance(t, dict):
                walk(t, spec[key], key)
            else:
                out.append((t, 2 if group == "mamba" else 1,
                            leaf_layout(mesh, spec[key], tuple(t.shape))))
    walk(state, specs, None)
    return out


PLACEMENT = {
    "train": "blocks by rules_for(mesh); each batch replica gathers whole weights and "
             "runs loss_fn and autograd; gradients reduced onto the owners; AdamW on "
             "each owner's stacks (make_sharded_train_step)",
    "prefill": "weights as blocks by rules_for(mesh); each batch replica keeps a "
               "gathered compute model between calls and prefills its rows (the "
               "prefill's state is its output)",
    "decode": "weights as for prefill; the decode state stored by "
              "decode_state_shardings; each replica gathers its rows' state, runs "
              "decode_step on them and sends the state back",
}


def card_costs(cfg: ModelConfig, mesh: Mesh, shape_name: str | ShapeSpec,
               knobs: dict) -> dict:
    """Every card class of the cell's placement: ``{"classes": [...],
    "pieces": {...}, "placement", "depth", "n_rep", "n_micro",
    "compute_cards"}``.  A class is ``{"cards", "n_cards", "uses": [[piece
    id, scale]], "collectives", "memory"}``; one of its cards costs the sum
    of its pieces' costs times their scales, plus its collectives.
    ``shape_name`` may be a :class:`ShapeSpec` off the grid."""
    sh = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    rules = rules_for(mesh)
    set_active_rules(rules)
    specs = input_specs(cfg, shape_name)
    groups, model = _groups(mesh, cfg, rules)
    first = mesh.devices[0]
    n_micro, opt_cfg = 1, None
    if sh.kind == "train":
        n_micro = int(knobs.get("microbatches", 1))
        opt_cfg = OptimConfig(moment_dtype=knobs.get("moment_dtype", torch.float32))
        mb = {k: v[0] for k, v in _split_micro(specs["batch"], n_micro).items()}
    else:
        mb = specs["batch"] if sh.kind == "prefill" else {"tokens": specs["tokens"]}
    b_spec = batch_shardings(mesh, cfg, {k: tuple(v.shape) for k, v in mb.items()})
    n_rep = axis_size(mesh, b_spec["tokens"][0])
    rep_devs = [replica_device(mesh, r) for r in range(n_rep)]
    replicas = Counter(rep_devs)
    shard = _rows_of(mb, n_rep)
    rows = shard["tokens"].shape[0]
    state_rows = 0

    # the replica's own work, at full depth or extrapolated
    if sh.kind == "train":
        count_dtype = torch.float64 if cfg.dtype == torch.float64 else torch.float32

        def work(c):
            m = init_model(c, device="meta")
            params = trainable(m)
            denom = _meta_like((), count_dtype)

            def run():
                cnt = (shard["labels"] >= 0).sum().to(count_dtype)
                return cnt, _grads_of(c, m, params, shard, denom=denom,
                                      aux_weight=1.0 / n_rep)
            return run
    elif sh.kind == "prefill":
        def work(c):
            m = init_model(c, device="meta")
            return lambda: prefill(c, m, shard, max_seq=sh.seq)
    else:
        state_rows = _tree_bytes(init_decode_state(cfg, rows, sh.seq, device="meta"))

        def work(c):
            m = init_model(c, device="meta")
            st = init_decode_state(c, rows, sh.seq, device="meta")
            return lambda: decode_step(c, m, st, shard["tokens"])
    rep_pieces, depth = depth_pieces(cfg, work)
    pieces: dict[str, Piece] = {f"replica{i}": p for i, (p, _) in enumerate(rep_pieces)}
    rep_peak = _scaled_peak(rep_pieces)
    rep_end = sum(p.end_bytes * k for p, k in rep_pieces)
    state_layouts = (_state_layouts(mesh, cfg, specs["state"]) if sh.kind == "decode"
                     else [])

    classes: dict = {}
    for card in dict.fromkeys(mesh.devices):
        classes.setdefault(_class_key(card, groups, replicas, first, state_layouts),
                           []).append(card)
    model_bytes = _tree_bytes(model.state_dict(), True)
    out_classes = []
    for ci, cards in enumerate(classes.values()):
        card = cards[0]
        hosts = replicas.get(card, 0)
        uses = [[f"replica{i}", k * hosts * n_micro]
                for i, (_, k) in enumerate(rep_pieces) if hosts]
        owned_bytes = _stacks_held(card, groups)
        # a replica's card keeps a whole compute model; the first card's is
        # the model the blocks were cut from
        resident = model_bytes if hosts or card == first else 0
        if sh.kind == "train":
            own, acc_bytes, upd_peak = _train_owner_work(card, groups, replicas, n_rep,
                                                         n_micro, opt_cfg, first)
            collectives = _train_received(card, groups, replicas, n_micro)
            opt_bytes = (2 * _stacks_held(card, groups, opt_cfg.moment_dtype.itemsize)
                         + (_stacks_held(card, groups, 4) if opt_cfg.master_fp32 else 0)
                         + card_bytes(4))
            memory = {"argument_size_in_bytes": owned_bytes + opt_bytes + resident,
                      "output_size_in_bytes": 4 * len(METRICS) if card == first else 0,
                      "temp_size_in_bytes": max((rep_peak if hosts else 0) + acc_bytes,
                                                acc_bytes + upd_peak)}
        else:
            own = Piece(Counter())
            st_own = sum(card_bytes(len(lay.owned.get(card, ()))
                                    * _block_bytes(lay, t.element_size()))
                         for t, _, lay in state_layouts)
            st_in = _state_received(card, rep_devs, state_layouts) if hosts else 0
            collectives = ({"state_gather": st_in, "state_scatter": st_in} if st_in
                           else {})
            memory = {"argument_size_in_bytes": owned_bytes + resident + st_own,
                      "output_size_in_bytes": rep_end * hosts,
                      "temp_size_in_bytes": (rep_peak + state_rows) * hosts}
        if own.rows:
            pieces[f"owner{ci}"] = own
            uses.append([f"owner{ci}", 1.0])
        out_classes.append({"cards": [str(c) for c in cards], "n_cards": len(cards),
                            "hosts_replicas": hosts, "first": card == first,
                            "uses": uses, "collectives": collectives, "memory": memory})
    return {"classes": out_classes, "pieces": pieces, "placement": PLACEMENT[sh.kind],
            "depth": depth, "n_rep": n_rep, "n_micro": n_micro,
            "compute_cards": len(replicas)}


def _train_owner_work(card, groups, replicas, n_rep, n_micro, opt_cfg, first):
    """(Piece, accumulator bytes, update peak) of ``card``'s share of the
    sharded step beside its replicas' forward and backward: the gathers
    onto it, the reductions' selections on its replicas and additions on
    its stacks, the division by the microbatch count, its norms, scalars
    and update, and, on the first card, the step's scalar sums."""
    hosts = replicas.get(card, 0)
    runs = n_rep * n_micro
    total = Piece(Counter())
    acc_bytes = 0
    upd_peak = 0.0
    for g in groups:
        lay, n = g.layout, len(g.names)
        ix_own = lay.owned.get(card)
        if hosts:  # the gather onto its compute model
            stacks = _stacks(lay, g.dtype)
            out = _meta_like(g.shape, g.dtype)
            total.add(_traced(lambda: gather(lay, stacks, out, card)), n)
            grad = _meta_like(g.shape, g.dtype)
            total.add(_traced(lambda: list(owned_parts(lay, grad))), n * hosts * n_micro)
        if not ix_own:
            continue
        acc_dtype = torch.float32 if n_micro > 1 else g.dtype
        part = next(p for d, _, p in owned_parts(lay, _meta_like(g.shape, g.dtype))
                    if d == card)
        acc: dict = {}
        total.add(_traced(lambda: accumulate(lay, acc, card, ix_own, part, acc_dtype)), n)
        if runs > 1:
            total.add(_traced(lambda: accumulate(lay, acc, card, ix_own, part, acc_dtype)),
                      n * (runs - 1))
        stack_g = acc[card]
        acc_bytes += n * _nbytes(stack_g)
        if n_micro > 1:
            total.add(_traced(lambda: stack_g.div_(n_micro)), n)
        total.add(_traced(lambda: torch.linalg.vector_norm(
            stack_g, dtype=torch.float32).square()), n)
        p = _meta_like(stack_g.shape, g.dtype)
        m = _meta_like(stack_g.shape, opt_cfg.moment_dtype)
        v = _meta_like(stack_g.shape, opt_cfg.moment_dtype)
        master = _meta_like(stack_g.shape, torch.float32) if opt_cfg.master_fp32 else None
        k = {key: _meta_like((), torch.float32) for key in ("scale", "lr", "b1c", "b2c")}
        piece = _traced(lambda: update_leaf(p, stack_g, m, v, master, k, opt_cfg))
        upd_peak = max(upd_peak, piece.peak_bytes)
        total.add(piece, n)
    # the step's scalars: every card advances its count; the first sums
    count = _meta_like((), torch.int32)
    norm = _meta_like((), torch.float32)
    total.add(_traced(lambda: step_scalars(count, norm, opt_cfg)))
    if card == first:
        total.add(_first_card_scalars(groups, n_rep, n_micro))
    return total, acc_bytes, upd_peak


def _first_card_scalars(groups, n_rep: int, n_micro: int) -> Piece:
    """The first card's sums: each microbatch's label count over the
    replicas, the losses and metrics, the global norm over every stack."""
    n_stacks = sum(len(g.names) * len(g.layout.owned) for g in groups)
    s = _meta_like((), torch.float32)

    def run():
        for _ in range(n_micro):
            torch.clamp(_sum_on([s] * n_rep, s.device), min=1.0)
        loss = _sum_on([s] * (n_rep * n_micro), s.device)
        if n_micro > 1:
            loss = loss / n_micro
        else:
            for _ in range(3):
                _sum_on([s] * n_rep, s.device)
        return torch.sqrt(_sum_on([s] * n_stacks, s.device))
    return _traced(run)


def class_cost(cls: dict, pieces: dict) -> OpCost:
    """One card of a class: its pieces' costs times their scales, plus its
    collectives."""
    total = OpCost()
    for pid, k in cls["uses"]:
        total += pieces[pid].cost().scaled(k)
    for kind, b in cls["collectives"].items():
        total.collectives[kind] = total.collectives.get(kind, 0) + b
        total.collective_bytes += b
    return total


def _bound_s(c: OpCost) -> float:
    return max(c.flops / PEAK_FLOPS, c.hbm_bytes / HBM_BW, c.collective_bytes / LINK_BW)


def per_device_of(reckoned: dict) -> tuple[dict, dict, dict]:
    """(per_device of the busiest class, its memory, the mesh totals) of
    :func:`card_costs`' result, or of a saved trace (``launch.rescore``)."""
    pieces = reckoned["pieces"]
    costs = [class_cost(c, pieces) for c in reckoned["classes"]]
    busiest = max(range(len(costs)), key=lambda i: _bound_s(costs[i]))
    total = OpCost()
    for c, cls in zip(costs, reckoned["classes"]):
        total += c.scaled(cls["n_cards"])
    best = costs[busiest]
    per_device = {"flops": best.flops, "hbm_bytes": best.hbm_bytes,
                  "collective_bytes": best.collective_bytes,
                  "collectives": {k: round(v) for k, v in best.collectives.items()},
                  "matmul_flops": best.matmul_flops,
                  "card": reckoned["classes"][busiest]["cards"][0]}
    mesh_totals = {"flops": total.flops, "hbm_bytes": total.hbm_bytes,
                   "collective_bytes": total.collective_bytes,
                   "collectives": {k: round(v) for k, v in total.collectives.items()},
                   "matmul_flops": total.matmul_flops}
    return per_device, reckoned["classes"][busiest]["memory"], mesh_totals


def reckon_cell(cfg: ModelConfig, shape_name: str | ShapeSpec, mesh: Mesh,
                knobs: dict) -> dict:
    """:func:`card_costs` and the figures of its busiest card."""
    reckoned = card_costs(cfg, mesh, shape_name, knobs)
    per_device, memory, totals = per_device_of(reckoned)
    reckoned.update(per_device=per_device, memory=memory, mesh_totals=totals)
    return reckoned


def _trace_json(reckoned: dict) -> dict:
    return {"pieces": {pid: p.json() for pid, p in reckoned["pieces"].items()},
            "classes": reckoned["classes"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool, variant: dict,
             tag: str, outdir: str, reduced: bool = False) -> dict:
    cfg = apply_variant((get_reduced if reduced else get_config)(arch), variant)
    ok, why = cell_supported(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": {k: str(v) for k, v in variant.items()}, "tag": tag,
    }
    if reduced:
        record["reduced"] = True
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record
    mesh = make_production_mesh(multi_pod=multi_pod)
    knobs = dict(TRAIN_KNOBS.get(arch, {}))
    t0 = time.perf_counter()
    reckoned = reckon_cell(cfg, shape_name, mesh, knobs)
    record["trace_s"] = round(time.perf_counter() - t0, 2)
    record["n_ops"] = sum(sum(p.rows.values()) for p in reckoned["pieces"].values())
    name = f"{arch}__{shape_name}__{mesh_name}__{tag}"
    with gzip.open(os.path.join(outdir, name + ".ops.json.gz"), "wt") as f:
        json.dump(_trace_json(reckoned), f)
    for key in ("placement", "depth", "n_rep", "n_micro", "compute_cards", "per_device",
                "memory", "mesh_totals"):
        record[key] = reckoned[key]
    record["n_cards"] = mesh.n_devices
    record["status"] = "ok"
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--variant", nargs="*", default=[],
                    help="cfg overrides k=v (python literals)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--reduced", action="store_true",
                    help="the configs' reduced models at the grid's shapes (tests)")
    args = ap.parse_args(argv)

    variant = {}
    for kv in args.variant:
        k, v = kv.split("=", 1)
        try:
            variant[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            variant[k] = v

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.outdir, exist_ok=True)
    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            name = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}__{args.tag}"
            out_path = os.path.join(args.outdir, name + ".json")
            try:
                rec = run_cell(arch, shape, mp, variant, args.tag, args.outdir,
                               args.reduced)
            except Exception as e:  # a cell that fails to trace records its error
                failures += 1
                rec = {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16", "tag": args.tag,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:],
                }
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                pd = rec["per_device"]
                extra = (f" flops/dev={pd['flops']:.3e}"
                         f" hbm/dev={pd['hbm_bytes']:.3e}B"
                         f" coll/dev={pd['collective_bytes']:.3e}B"
                         f" trace={rec['trace_s']}s")
            print(f"[{rec['status']:7s}] {name}{extra}", flush=True)
    print(f"{len(cells) * len(meshes)} cells in {time.perf_counter() - t_all:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

"""Training runtime: the train step with gradient accumulation, on one
device or sharded over an LM mesh, and the fault-tolerant training loop.
The port of ``repro.runtime.trainer``.

:func:`make_train_step` returns ``step(model, opt_state, batch) ->
(model, opt_state, metrics)``.  It differentiates :func:`~repro_torch.
models.lm.loss_fn` with ``torch.autograd.grad`` over the model's floating
parameters (a leaf the loss does not reach gets a zero gradient, as
``jax.grad`` gives), sums microbatch gradients in ``accum_dtype`` and
divides by their count, and applies :func:`~repro_torch.optim.adamw.
adamw_update`, which writes the parameters and the optimizer state in
place: the counterpart of the JAX package's donated buffers.  The step is
eager; nothing in it reads a device value on the host, so the metrics stay
device scalars until the caller reads them.

:func:`make_sharded_train_step` is the same step on a mesh
(``launch.mesh.make_mesh``), where the JAX package runs the step under
GSPMD with the state placed by ``shardings_for``.  The state is a
:class:`~repro_torch.runtime.sharded.ShardedModel` and block stacks of
AdamW's state; every microbatch is split over the batch axes (or, where
the batch axes do not divide it, computed once whole), each batch replica
gathers the weights onto its card and runs ``loss_fn`` and autograd there,
and its gradient is added onto the blocks' owners in shard order.  A
replica's cross-entropy and z-loss divide by the microbatch's global count
of unmasked labels and its MoE auxiliary loss is weighted by its share of
the rows, so the replicas' losses and gradients add up to the unsharded
step's (ROADMAP C.33).  AdamW updates each owner's blocks; the global norm
runs over the blocks, each once.  It is storage sharding (ZeRO-3 style):
every replica computes with the whole weights.

:func:`train_loop` is the JAX package's driver: restore from the latest
checkpoint at start, data by ``data.batch_at(step)`` (so a restart never
replays or skips a batch), an optional ``fault_hook``, the step timed with
the host's read of its metrics, a straggler :class:`Watchdog`, async
checkpoints every ``ckpt_every`` steps in the JAX package's layer-stacked
layout (so the two packages read each other's float32 checkpoints, and a
sharded run's checkpoint restores onto any mesh or one device), and on
a crash a rebuild from init, a restore of the latest checkpoint and a
bounded count of restarts; a final blocking save.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve_on
from repro_torch.core.distributed import Mesh
from repro_torch.interop import stack_params, unstack_params
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.shardspecs import axis_size, batch_shardings, fit_tree
from repro_torch.models.common import MeshRules, default_rules, set_active_rules
from repro_torch.models.lm import ModelConfig, init_model, loss_fn, param_axes, trainable
from repro_torch.optim.adamw import (
    OptimConfig,
    adamw_init,
    adamw_update,
    step_scalars,
    update_leaf,
)
from repro_torch.runtime.sharded import ShardedModel, reduce_into

__all__ = ["TrainConfig", "make_train_step", "shardings_for", "shard_model",
           "sharded_adamw_init", "replica_device", "sharded_grads", "sharded_adamw_update",
           "make_sharded_train_step", "train_loop", "Watchdog"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    accum_dtype: Any = torch.float32
    seed: int = 0


def _split_micro(batch: dict, n_micro: int) -> dict:
    """(B, ...) -> (n_micro, B / n_micro, ...); ``positions`` (3, B, s) ->
    (n_micro, 3, B / n_micro, s).  Microbatch i holds rows i·mb … (i+1)·mb - 1."""
    def rs(key, x):
        if key == "positions":
            b = x.shape[1]
            return x.reshape(3, n_micro, b // n_micro, *x.shape[2:]).swapaxes(0, 1)
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])

    return {k: rs(k, v) for k, v in batch.items()}


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _grads_of(cfg: ModelConfig, model, params: dict, batch: dict, **loss_kw):
    """(loss, metrics, {name: gradient}) of ``loss_fn`` over ``params``."""
    leaves = list(params.values())
    loss, metrics = loss_fn(cfg, model, batch, **loss_kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), metrics, {
        name: g if g is not None else torch.zeros_like(p)
        for (name, p), g in zip(params.items(), grads)}


def make_train_step(cfg: ModelConfig, opt_cfg: OptimConfig, n_micro: int = 1,
                    accum_dtype=torch.float32):
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``:
    metrics ``loss``, ``lr``, ``grad_norm`` and, with ``n_micro == 1``,
    ``ce``, ``z_loss`` and ``aux`` (float32 scalars on the device).  With
    ``n_micro > 1`` the batch splits into ``n_micro`` microbatches whose
    gradients are summed in ``accum_dtype`` and divided by ``n_micro``, and
    the loss is their mean.  The model's floating parameters are made
    trainable (:func:`~repro_torch.models.lm.trainable`); ``opt_state`` is
    :func:`~repro_torch.optim.adamw.adamw_init` of them."""

    def train_step(model, opt_state, batch):
        params = trainable(model)
        batch = _on(batch, model.device)
        with torch.enable_grad():
            if n_micro == 1:
                loss, metrics, grads = _grads_of(cfg, model, params, batch)
            else:
                micro = _split_micro(batch, n_micro)
                grads = {name: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                         for name, p in params.items()}
                loss = torch.zeros((), dtype=torch.float32, device=model.device)
                for i in range(n_micro):
                    l, _, g = _grads_of(cfg, model, params, {k: v[i] for k, v in micro.items()})
                    for name, acc in grads.items():
                        acc.add_(g[name].to(accum_dtype))
                    loss = loss + l
                    del g
                for acc in grads.values():
                    acc.div_(n_micro)
                loss = loss / n_micro
                metrics = {}
        _, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        out = {"loss": loss, **opt_metrics}
        out.update({k: v.detach() for k, v in metrics.items() if k != "tokens"})
        return model, opt_state, out

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
def shardings_for(mesh: Mesh, rules: MeshRules, axes_tree: dict) -> dict:
    """Logical-axes tree -> spec tree for this mesh, before
    ``launch.shardspecs.fit_tree`` fits the specs to the leaves' shapes."""
    return rules.tree_specs(axes_tree)


def _opt_shardings(mesh: Mesh, rules: MeshRules, axes_tree: dict, opt_cfg: OptimConfig):
    ps = shardings_for(mesh, rules, axes_tree)
    out = {"m": ps, "v": ps, "count": ()}
    if opt_cfg.master_fp32:
        out["master"] = ps
    return out


def shard_model(cfg: ModelConfig, model, mesh: Mesh, rules: MeshRules) -> ShardedModel:
    """``model`` (whole, on the mesh's first device) placed on ``mesh`` by
    ``rules``; the model becomes that device's compute model."""
    params = trainable(model)
    axes = param_axes(cfg, model)
    specs = fit_tree(mesh, shardings_for(mesh, rules, {n: axes[n] for n in params}), params)
    return ShardedModel(cfg, model, mesh, specs)


def sharded_adamw_init(sm: ShardedModel, opt_cfg: OptimConfig, rules: MeshRules) -> dict:
    """:func:`~repro_torch.optim.adamw.adamw_init` of a sharded model: each
    state leaf of ``_opt_shardings`` as block stacks beside its parameter's
    (``{name: {owner: stack}}``), ``count`` (replicated) on every device of
    the mesh."""
    specs = _opt_shardings(sm.mesh, rules, sm.axes, opt_cfg)
    state: dict = {}
    with torch.no_grad():
        for key in ("m", "v", "master"):
            if key not in specs:
                continue
            fitted = fit_tree(sm.mesh, specs[key],
                              {n: lay.shape for n, lay in sm.layouts.items()})
            if fitted != sm.specs:
                raise ValueError(f"opt state {key!r} is not laid out as the parameters")
            state[key] = {
                n: {d: (p.to(torch.float32, copy=True) if key == "master" else
                        torch.zeros(p.shape, dtype=opt_cfg.moment_dtype, device=d))
                    for d, p in stacks.items()}
                for n, stacks in sm.blocks.items()}
        state["count"] = {d: torch.zeros((), dtype=torch.int32, device=d)
                          for d in dict.fromkeys(sm.mesh.devices)}
    return state


def replica_device(mesh: Mesh, r: int) -> torch.device:
    """The card batch replica ``r`` computes on: the cell at index r along
    the batch axes, every other axis at 0."""
    axes = batch_axes(mesh)
    coord = [0] * len(mesh.axis_names)
    for a, i in zip(axes, np.unravel_index(r, [mesh.shape[a] for a in axes])):
        coord[mesh.axis_names.index(a)] = int(i)
    return mesh.device_at(coord)


def _replica_batch(mb: dict, r: int, n_rep: int, device) -> dict:
    """Rows r·b/n … (r+1)·b/n of a microbatch (``positions``' second axis)
    on ``device``."""
    def part(key, x):
        if n_rep > 1:
            rows = (x.shape[1] if key == "positions" else x.shape[0]) // n_rep
            cut = slice(r * rows, (r + 1) * rows)
            x = x[:, cut] if key == "positions" else x[cut]
        return x.to(device, non_blocking=True)

    return {k: part(k, v) for k, v in mb.items()}


def _sum_on(parts: list, device) -> torch.Tensor:
    """The parts moved to ``device`` and added in order."""
    total = parts[0].to(device)
    for t in parts[1:]:
        total = total + t.to(device, non_blocking=True)
    return total


def sharded_grads(cfg: ModelConfig, sm: ShardedModel, batch: dict, n_micro: int = 1,
                  accum_dtype=torch.float32, on_replica=None):
    """The sharded step's gradient, ``({name: {owner: stack}}, loss,
    metrics)``: the microbatches cut as :func:`_split_micro` cuts them,
    each split over the batch axes where the fitted batch spec splits it
    (else computed once, whole, on the mesh's first device), every
    replica's gradient added onto the owners in shard order.  Stacks are in
    the gradients' dtype with ``n_micro == 1`` and in ``accum_dtype``
    (divided by ``n_micro``) otherwise; ``loss`` and the metrics (``ce``,
    ``z_loss``, ``aux`` with ``n_micro == 1``) are device scalars on the
    first device.  ``on_replica(i, r, device, grads)``, if given, sees
    each replica's whole gradients before they are freed."""
    mesh, first = sm.mesh, sm.device
    micro = _split_micro(_on(batch, first), n_micro)
    shapes = {k: v[0] for k, v in micro.items()}
    n_rep = axis_size(mesh, batch_shardings(mesh, cfg, shapes)["tokens"][0])
    devices = [replica_device(mesh, r) for r in range(n_rep)]
    with record_function("sharded/gather"):
        models = {d: sm.compute(d) for d in dict.fromkeys(devices)}
    params = {d: trainable(m) for d, m in models.items()}
    count_dtype = torch.float64 if cfg.dtype == torch.float64 else torch.float32
    acc: dict = {name: {} for name in sm.blocks}
    losses, parts = [], {"ce": [], "z_loss": [], "aux": []}
    for i in range(n_micro):
        shards = [_replica_batch({k: v[i] for k, v in micro.items()}, r, n_rep, d)
                  for r, d in enumerate(devices)]
        counts = [(torch.as_tensor(s["labels"]) >= 0).sum().to(count_dtype) for s in shards]
        denom = torch.clamp(_sum_on(counts, first), min=1.0)
        for r, (dev, shard) in enumerate(zip(devices, shards)):
            with torch.enable_grad(), record_function("sharded/forward_backward"):
                loss, metrics, grads = _grads_of(cfg, models[dev], params[dev], shard,
                                                 denom=denom.to(dev), aux_weight=1.0 / n_rep)
            if on_replica is not None:
                on_replica(i, r, dev, grads)
            with record_function("sharded/reduce"):
                for name in list(grads):
                    reduce_into(sm.layouts[name], acc[name], grads.pop(name),
                                accum_dtype if n_micro > 1 else sm.dtypes[name], dev,
                                sm.copied["reduce"])
            losses.append(loss)
            for key, vals in parts.items():
                vals.append(metrics[key].detach())
    if n_micro == 1:
        return acc, _sum_on(losses, first), {k: _sum_on(v, first) for k, v in parts.items()}
    for stacks in acc.values():
        for s in stacks.values():
            s.div_(n_micro)
    return acc, _sum_on(losses, first) / n_micro, {}


@torch.no_grad()
def sharded_adamw_update(sm: ShardedModel, state: dict, grads: dict, cfg: OptimConfig):
    """One AdamW step over block stacks, in place (profiler range
    ``sharded/adamw``); returns ``{"lr", "grad_norm"}`` on the first
    device.  The global norm sums every block's square once on the first
    device; each owner advances its count and updates its stacks with the
    scalars of :func:`~repro_torch.optim.adamw.step_scalars`."""
    first = sm.device
    with record_function("sharded/adamw"):
        sq = [torch.linalg.vector_norm(s, dtype=torch.float32).square()
              for stacks in grads.values() for s in stacks.values()]
        norm = torch.sqrt(_sum_on(sq, first))
        k = {d: step_scalars(c, norm.to(d), cfg) for d, c in state["count"].items()}
        master = state.get("master") if cfg.master_fp32 else None
        for name, stacks in sm.blocks.items():
            for d, p in stacks.items():
                update_leaf(p, grads[name][d], state["m"][name][d], state["v"][name][d],
                            master[name][d] if master is not None else None, k[d], cfg)
    return {"lr": k[first]["lr"], "grad_norm": norm}


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: OptimConfig, n_micro: int = 1,
                            accum_dtype=torch.float32):
    """``step(sm, opt_state, batch) -> (sm, opt_state, metrics)`` on a
    :class:`~repro_torch.runtime.sharded.ShardedModel` and
    :func:`sharded_adamw_init`'s state: :func:`sharded_grads`, then
    :func:`sharded_adamw_update`.  The metrics are :func:`make_train_step`'s."""

    def train_step(sm, opt_state, batch):
        grads, loss, metrics = sharded_grads(cfg, sm, batch, n_micro, accum_dtype)
        opt_metrics = sharded_adamw_update(sm, opt_state, grads, opt_cfg)
        del grads
        return sm, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step


class Watchdog:
    """Per-step wall-time tracker; flags straggler-suspect steps (a step
    more than ``threshold`` standard deviations and 1.5x above the mean of
    the last ``window`` steps, once 10 are recorded)."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.times: list[float] = []
        self.window = window
        self.threshold = threshold
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 10:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            if dt > mu + self.threshold * sd and dt > 1.5 * mu:
                is_straggler = True
                self.flagged.append(step)
        self.times.append(dt)
        return is_straggler


def _state_tree(cfg: ModelConfig, model, opt_state: dict) -> dict:
    """``{"params", "opt"}`` in the JAX package's layer-stacked layout, on
    the host: what a checkpoint holds.  A sharded state is gathered into
    whole leaves first, so its checkpoint is the logical one."""
    if isinstance(model, ShardedModel):
        named = model.state_dict()
        opt = {key: model.host(opt_state[key]) for key in ("m", "v", "master")
               if key in opt_state}
        count = opt_state["count"][model.device]
    else:
        host = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
        named = host(model.state_dict())
        opt = {key: host(opt_state[key]) for key in ("m", "v", "master") if key in opt_state}
        count = opt_state["count"]
    tree = {key: stack_params(cfg, leaves) for key, leaves in opt.items()}
    tree["count"] = count.detach().cpu()
    return {"params": stack_params(cfg, named), "opt": tree}


def _state_like(cfg: ModelConfig, model, opt_state: dict) -> dict:
    """:func:`_state_tree`'s structure and dtypes with empty leaves: what
    a checkpoint is restored into (``CheckpointManager.restore`` reads a
    leaf's dtype and device only)."""
    empty = lambda dtypes: {k: torch.empty(0, dtype=d) for k, d in dtypes.items()}  # noqa: E731
    if isinstance(model, ShardedModel):
        params = model.leaf_dtypes()
        leaf = lambda stacks: next(iter(stacks.values())).dtype  # noqa: E731
    else:
        params = {n: t.dtype for n, t in model.state_dict().items()}
        leaf = lambda t: t.dtype  # noqa: E731
    tree = {key: stack_params(cfg, empty({n: leaf(v) for n, v in opt_state[key].items()}))
            for key in ("m", "v", "master") if key in opt_state}
    tree["count"] = torch.empty(0, dtype=torch.int32)
    return {"params": stack_params(cfg, empty(params)), "opt": tree}


@torch.no_grad()
def _load_state(cfg: ModelConfig, model, opt_state: dict, tree: dict) -> None:
    """Write a restored :func:`_state_tree` into ``model`` and
    ``opt_state``; a sharded model slices each whole leaf onto its mesh."""
    params = unstack_params(cfg, tree["params"])
    keys = [key for key in ("m", "v", "master") if key in opt_state]
    if isinstance(model, ShardedModel):
        model.load(params)
        for key in keys:
            model.load(unstack_params(cfg, tree["opt"][key]), opt_state[key])
        for count in opt_state["count"].values():
            count.copy_(tree["opt"]["count"])
        return
    own = model.state_dict()
    for name, value in params.items():
        own[name].copy_(value)
    for key in keys:
        for name, value in unstack_params(cfg, tree["opt"][key]).items():
            opt_state[key][name].copy_(value)
    opt_state["count"].copy_(tree["opt"]["count"])


def train_loop(
    cfg: ModelConfig,
    opt_cfg: OptimConfig,
    train_cfg: TrainConfig,
    data,  # .batch_at(step) -> dict of numpy arrays
    mesh: Mesh | None = None,
    rules: MeshRules | None = None,
    fault_hook: Callable[[int], None] | None = None,
    log: Callable[[str], None] = print,
    device=None,
):
    """Fault-tolerant training loop.  Returns (model, opt_state,
    history), history one dict a completed step: ``step``, ``time_s`` and
    the metrics as floats.  The model is ``init_model(cfg,
    train_cfg.seed)`` on ``device`` (``"cuda"`` by default; raises without
    a card), or, with a ``mesh``, on the mesh's first device and then
    placed on the mesh by ``rules`` (default ``default_rules(False)``, as
    the JAX package's): a :class:`~repro_torch.runtime.sharded.ShardedModel`
    trained by :func:`make_sharded_train_step`.  A failed gather or
    reduction fails its step like any crash."""
    rules = rules or default_rules(multi_pod=False)
    set_active_rules(rules)
    dev = resolve_on(device, mesh)
    manager = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.ckpt_keep)
    watchdog = Watchdog()
    history: list[dict] = []

    def build():
        model = init_model(cfg, train_cfg.seed, device=dev)
        if mesh is None:
            return model, adamw_init(trainable(model), opt_cfg)
        sm = shard_model(cfg, model, mesh, rules)
        return sm, sharded_adamw_init(sm, opt_cfg, rules)

    def restore(model, opt_state, step):
        like = _state_like(cfg, model, opt_state)
        _load_state(cfg, model, opt_state, manager.restore(step, like))

    model, opt_state = build()
    make = make_train_step if mesh is None else make_sharded_train_step
    step_fn = make(cfg, opt_cfg, train_cfg.microbatches, train_cfg.accum_dtype)

    start = 0
    latest = manager.latest_step()
    if latest is not None:
        log(f"[restore] resuming from checkpoint step {latest}")
        restore(model, opt_state, latest)
        start = latest + 1

    restarts = 0
    step = start
    while step < train_cfg.steps:
        try:
            batch = _on(data.batch_at(step), dev)
            if fault_hook is not None:
                fault_hook(step)  # test hook: raises to simulate a crash
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if watchdog.record(step, dt):
                log(f"[watchdog] step {step} straggler suspect ({dt:.3f}s)")
            history.append({"step": step, "time_s": dt, **metrics})
            if step % train_cfg.log_every == 0:
                log(f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"gnorm {metrics['grad_norm']:.3f} {dt * 1e3:.0f}ms")
            if train_cfg.ckpt_every and step and step % train_cfg.ckpt_every == 0:
                manager.save(step, _state_tree(cfg, model, opt_state))
            step += 1
        except Exception as e:  # crash path: restore and continue
            restarts += 1
            if restarts > train_cfg.max_restarts:
                raise
            latest = manager.latest_step()
            log(f"[fault] step {step} failed ({type(e).__name__}: {e}); "
                f"restart {restarts}/{train_cfg.max_restarts} from "
                f"{'checkpoint ' + str(latest) if latest is not None else 'scratch'}")
            del model, opt_state
            model, opt_state = build()
            if latest is not None:
                restore(model, opt_state, latest)
                step = latest + 1
            else:
                step = 0
    manager.save(train_cfg.steps - 1, _state_tree(cfg, model, opt_state), blocking=True)
    return model, opt_state, history

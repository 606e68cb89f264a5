"""Training runtime: the train step with gradient accumulation, and the
fault-tolerant driver loop.  The port of ``repro.runtime.trainer``.

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

:func:`train_loop` is the JAX package's driver: restore from the latest
checkpoint at start, data by ``data.batch_at(step)`` (so a restart never
replays or skips a batch), an optional ``fault_hook``, the step timed with
the host's read of its metrics, a straggler :class:`Watchdog`, async
checkpoints every ``ckpt_every`` steps in the JAX package's layer-stacked
layout (so the two packages read each other's float32 checkpoints), and on
a crash a rebuild from init, a restore of the latest checkpoint and a
bounded count of restarts; a final blocking save.

One card only: ``mesh=`` and ``rules=`` raise ``NotImplementedError``.
The LM meshes, the sharded step and ``shardings_for`` come with ROADMAP
A.5.7.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve
from repro_torch.interop import stack_params, unstack_params
from repro_torch.models.lm import ModelConfig, init_model, loss_fn, trainable
from repro_torch.optim.adamw import OptimConfig, adamw_init, adamw_update

__all__ = ["TrainConfig", "make_train_step", "train_loop", "Watchdog"]

MESH_ITEM = "ROADMAP A.5.7 (the LM meshes and the sharded train step)"


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

    def grads_of(model, params, batch):
        leaves = list(params.values())
        loss, metrics = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), metrics, {
            name: g if g is not None else torch.zeros_like(p)
            for (name, p), g in zip(params.items(), grads)}

    def train_step(model, opt_state, batch):
        params = trainable(model)
        batch = _on(batch, model.device)
        with torch.enable_grad():
            if n_micro == 1:
                loss, metrics, grads = grads_of(model, params, batch)
            else:
                micro = _split_micro(batch, n_micro)
                grads = {name: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                         for name, p in params.items()}
                loss = torch.zeros((), dtype=torch.float32, device=model.device)
                for i in range(n_micro):
                    l, _, g = grads_of(model, params, {k: v[i] for k, v in micro.items()})
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
    the host: what a checkpoint holds."""
    host = lambda named: {k: v.detach().cpu() for k, v in named.items()}  # noqa: E731
    opt = {key: stack_params(cfg, host(opt_state[key]))
           for key in ("m", "v", "master") if key in opt_state}
    opt["count"] = opt_state["count"].detach().cpu()
    return {"params": stack_params(cfg, host(model.state_dict())), "opt": opt}


@torch.no_grad()
def _load_state(cfg: ModelConfig, model, opt_state: dict, tree: dict) -> None:
    """Write a restored :func:`_state_tree` into ``model`` and ``opt_state``."""
    own = model.state_dict()
    for name, value in unstack_params(cfg, tree["params"]).items():
        own[name].copy_(value)
    for key in ("m", "v", "master"):
        if key in opt_state:
            for name, value in unstack_params(cfg, tree["opt"][key]).items():
                opt_state[key][name].copy_(value)
    opt_state["count"].copy_(tree["opt"]["count"])


def train_loop(
    cfg: ModelConfig,
    opt_cfg: OptimConfig,
    train_cfg: TrainConfig,
    data,  # .batch_at(step) -> dict of numpy arrays
    mesh=None,
    rules=None,
    fault_hook: Callable[[int], None] | None = None,
    log: Callable[[str], None] = print,
    device="cuda",
):
    """Fault-tolerant training driver on ``device`` (``"cuda"`` by default;
    raises without a card).  Returns (model, opt_state, history), history
    one dict a completed step: ``step``, ``time_s`` and the metrics as
    floats.  The model is ``init_model(cfg, train_cfg.seed)``."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(f"train_loop runs on one device; mesh= and rules= "
                                  f"wait for {MESH_ITEM}")
    dev = resolve(device)
    manager = CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.ckpt_keep)
    watchdog = Watchdog()
    history: list[dict] = []

    def build():
        model = init_model(cfg, train_cfg.seed, device=dev)
        return model, adamw_init(trainable(model), opt_cfg)

    def restore(model, opt_state, step):
        like = _state_tree(cfg, model, opt_state)
        _load_state(cfg, model, opt_state, manager.restore(step, like))

    model, opt_state = build()
    step_fn = make_train_step(cfg, opt_cfg, train_cfg.microbatches, train_cfg.accum_dtype)

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

"""Fault-tolerant checkpoints: async, atomic, keep-N, in the JAX package's
file format.

The contract is the JAX package's ``checkpoint.manager``:

* **Logical layout** — a checkpoint stores whole arrays keyed by their
  tree path (``params/blocks/attn/wq``, ``opt/count``): ``arrays.npz``
  beside ``meta.json`` (``{"step", "n_arrays"}``).  The trainer saves the
  JAX package's layer-stacked layout (``interop.stack_params``), so a
  float32 checkpoint written by either package restores in the other bit
  for bit.
* **Atomic publish** — a save writes ``step_XXXXXXXX.tmp/``, fsyncs it and
  renames it to ``step_XXXXXXXX/``; a crash mid-write leaves a ``.tmp``
  that :meth:`CheckpointManager.all_steps` ignores.
* **Async save** — :meth:`CheckpointManager.save` copies every leaf to host
  memory at the call, then one worker thread serializes while training
  goes on; the next save (or :meth:`~CheckpointManager.wait`) joins it.
* **Keep-N GC** — older steps are deleted after a successful publish.

bfloat16 leaves are written as the JAX package writes them, 2-byte ``|V2``
records holding the bf16 bits, and read back by viewing those bytes as
``torch.bfloat16``: no ``ml_dtypes`` is needed.  So the port restores the
JAX package's bf16 checkpoints, which the JAX package itself cannot (its
``astype`` has no cast from ``|V2``: ROADMAP C.28).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "tree_paths"]

_BF16_BITS = np.dtype("V2")


def tree_paths(tree) -> dict[str, Any]:
    """Flatten nested dicts, lists and tuples to ``{"a/b/0": leaf}``, dict
    keys sorted, as ``jax.tree_util`` orders them."""
    flat: dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{prefix}{key}/")
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                walk(value, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = node

    walk(tree, "")
    return flat


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf taken now; bf16 as its ``|V2`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.array(leaf)


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (``|V2`` records read as bf16 bits) as a tensor of
    ``like``'s dtype on its device."""
    if arr.dtype == _BF16_BITS:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _rebuild(like, flat: dict, prefix=""):
    if isinstance(like, dict):
        return {key: _rebuild(value, flat, f"{prefix}{key}/") for key, value in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(value, flat, f"{prefix}{i}/")
                          for i, value in enumerate(like))
    return flat[prefix[:-1]]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: cf.Future | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Snapshot every leaf of ``tree`` to host memory now; serialize in
        the background (or before returning, with ``blocking``)."""
        self.wait()
        host = {k: _to_host(v) for k, v in tree_paths(tree).items()}
        self._pending = self._pool.submit(self._write, step, host)
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, np.ndarray]) -> int:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **host)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_arrays": len(host)}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return step

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree):
        """``like_tree``'s structure rebuilt from disk, each leaf (a
        tensor) as a tensor of its dtype on its device."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as data:
            flat = {key: _from_host(data[key], like)
                    for key, like in tree_paths(like_tree).items()}
        return _rebuild(like_tree, flat)

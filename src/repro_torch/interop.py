"""Carry prepared state across from the JAX package.

``repro.kernels.ops`` and ``repro.tune.operator.prepare`` build prepared
dicts whose leaves are device arrays; :func:`split` turns such a dict into
host numpy arrays plus its static metadata (``np.asarray`` reads any array
exposing the buffer protocol, so this module imports no JAX), and
:func:`prep_from_arrays` puts them on a torch device in this package's
layout, so the port's kernels and plain versions can run on exactly the
arrays the JAX package prepared.

:func:`lm_params_from_numpy` does the same for a language model: the JAX
package's ``init_model`` tree as numpy arrays becomes the port's
:class:`~repro_torch.models.lm.LM` for the same configuration, so both
packages compute the same function (``jax.random`` and
``torch.Generator`` draw different weights from one seed), and
:func:`lm_params_to_numpy` goes back.  :func:`stack_params` and
:func:`unstack_params` map between the port's per-layer names and the JAX
package's layer-stacked tree, which the checkpoints use.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import torch

from repro_torch.core.device import resolve
from repro_torch.core.formats import CSRMatrix
from repro_torch.kernels import merge_spmv
from repro_torch.kernels.ops import from_arrays
from repro_torch.models.ffn import SparseFFNConfig
from repro_torch.models.lm import LM, ModelConfig
from repro_torch.models.moe import MoEConfig

__all__ = ["split", "prep_from_arrays", "port_config", "lm_params_from_numpy",
           "lm_params_to_numpy", "stack_params", "unstack_params"]

_ARRAY_KEYS = ("cols", "vals", "row_perm", "block_rows", "block_cols", "blocks",
               "bounds", "col_start", "col_len", "rows", "indices", "data",
               "start", "end", "perm")


def split(prep: dict[str, Any]) -> tuple[dict, dict]:
    """(arrays as numpy, metadata) of a JAX-side prepared dict.  A
    ``slabs`` list (per-slab SELL) and a reordered candidate's ``inner``
    dict are split recursively; its permuted ``matrix`` becomes
    ``(shape, indptr, indices, data)``."""
    arrays: dict[str, Any] = {}
    meta: dict[str, Any] = {}
    for key, value in prep.items():
        if key == "slabs":
            arrays["slabs"] = [split(slab)[0] for slab in value]
            meta["chunk_tile"] = int(value[0].get("chunk_tile", 8)) if value else 8
        elif key == "inner":
            arrays["inner"], meta["inner"] = split(value)
        elif key == "matrix":
            arrays["matrix"] = (tuple(int(v) for v in value.shape),
                                np.asarray(value.indptr), np.asarray(value.indices),
                                np.asarray(value.data))
        elif key in _ARRAY_KEYS:
            arrays[key] = np.asarray(value)
        else:
            meta[key] = value
    return arrays, meta


def prep_from_arrays(fmt: str, arrays: dict, meta: dict, device) -> dict[str, Any]:
    """The port's prepared dict for ``fmt`` on ``device``, built from host
    arrays such as :func:`split` returns.  ``fmt`` is one of
    :func:`~repro_torch.kernels.ops.from_arrays`'s formats, ``"merge"``, or
    ``"reorder:<inner fmt>"`` for a reordered candidate (its permutation,
    permuted matrix and the inner format's dict)."""
    if fmt == "merge":
        return merge_spmv.from_host(arrays, meta, device)
    if fmt.startswith("reorder:"):
        shape, indptr, indices, data = arrays["matrix"]
        return {
            "perm": torch.as_tensor(np.asarray(arrays["perm"], np.int64), device=device),
            "matrix": CSRMatrix(tuple(shape), indptr, indices, data),
            "inner": prep_from_arrays(fmt.split(":", 1)[1], arrays["inner"],
                                      meta["inner"], device),
        }
    return from_arrays(fmt, arrays, meta, device)


def port_config(cfg):
    """The port's ``ModelConfig`` with the fields of ``cfg``, a
    configuration of either package: its dtype becomes the torch dtype of
    the same name, its ``MoEConfig`` the port's, and a bcsr FFN's
    ``"pallas"`` tier the kernel's ``"cuda"``."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if not isinstance(fields["dtype"], torch.dtype):
        fields["dtype"] = getattr(torch, np.dtype(fields["dtype"]).name)
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(fields["moe"]))
    sff = fields["sparse_ffn"]
    if sff is not None:
        sff = {f.name: getattr(sff, f.name) for f in dataclasses.fields(sff)}
        for key in ("impl", "impl_w2"):
            if sff[key] == "pallas":
                sff[key] = "cuda"
        fields["sparse_ffn"] = SparseFFNConfig(**sff)
    return ModelConfig(**fields)


def _stacked(cfg) -> dict[str, tuple[int, ...]]:
    """The JAX package's stacked subtrees and their leading (layer) axes."""
    if cfg.family == "hybrid":
        return {"blocks": (cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period)}
    if cfg.family == "audio":
        return {"enc_blocks": (cfg.enc_layers,), "dec_blocks": (cfg.n_layers,)}
    return {"blocks": (cfg.n_layers,)}


def unstack_params(cfg, tree: dict) -> dict[str, Any]:
    """The JAX package's parameter tree (nested dicts, layers stacked on
    leading axes) as the port's flat names: ``blocks.attn.wq`` (L, ...)
    becomes ``blocks.0.attn.wq`` ... ``blocks.{L-1}.attn.wq``, a hybrid's
    ``blocks.{i}.{j}.*``.  Leaves are indexed, not copied (numpy or torch)."""
    stacked = _stacked(cfg)

    def flat(node, prefix=""):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    out = {}
    for name, value in flat(tree):
        top, _, rest = name.partition(".")
        lead = stacked.get(top)
        if lead is None:
            out[name] = value
            continue
        if tuple(value.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: leading axes {tuple(value.shape[:len(lead)])}, "
                             f"the config has {lead}")
        for index in np.ndindex(*lead):
            out[f"{top}.{'.'.join(map(str, index))}.{rest}"] = value[index]
    return out


def stack_params(cfg, named: dict[str, Any]) -> dict:
    """The inverse of :func:`unstack_params`: leaves keyed by the port's
    names (a ``state_dict``, or optimizer moments keyed by parameter names)
    as the JAX package's nested tree, each layer-stacked group stacked on
    its leading axes (``torch.stack`` or ``np.stack``, as the leaves are)."""
    stacked = _stacked(cfg)
    groups: dict[tuple[str, str], dict] = {}
    tree: dict = {}

    def put(path: str, value) -> None:
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value

    for name, value in named.items():
        top, _, rest = name.partition(".")
        lead = stacked.get(top)
        if lead is None:
            put(name, value)
            continue
        parts = rest.split(".")
        index = tuple(int(i) for i in parts[:len(lead)])
        groups.setdefault((top, ".".join(parts[len(lead):])), {})[index] = value
    for (top, rest), leaves in groups.items():
        lead = stacked[top]
        order = list(np.ndindex(*lead))
        if sorted(leaves) != order:
            raise ValueError(f"{top}.*.{rest}: layers {sorted(leaves)}, the config "
                             f"has {lead}")
        items = [leaves[i] for i in order]
        if isinstance(items[0], torch.Tensor):
            value = torch.stack(items).reshape(*lead, *items[0].shape)
        else:
            value = np.stack(items).reshape(*lead, *items[0].shape)
        put(f"{top}.{rest}", value)
    return tree


def lm_params_to_numpy(cfg, model) -> dict:
    """The port's model as the JAX package's ``init_model(cfg)[0]`` tree
    with numpy leaves (the inverse of :func:`lm_params_from_numpy`; a
    round trip is bit for bit).  bf16 leaves come out as float32, which
    holds them exactly (numpy has no bfloat16); indices as int32."""
    host = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        host[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return stack_params(port_config(cfg), host)


def lm_params_from_numpy(cfg, params: dict, device="cuda"):
    """The port's model for ``cfg`` holding the weights of ``params``, on
    ``device`` (``"cuda"`` by default; raises without a card).

    ``params`` is the JAX package's ``init_model(cfg)[0]`` tree with numpy
    leaves: ``embed``, ``unembed``, ``ln_f`` and ``blocks`` stacked on a
    leading layers axis (a bcsr FFN as ``w*_blocks`` / ``w*_rows`` /
    ``w*_cols``; a MoE FFN as ``ffn.router`` / ``wi_gate`` / ``wi_up`` /
    ``wo``; an RWKV-6 block's leaves, ``mu_base`` to ``ln2``, directly under
    ``blocks``).  A hybrid's ``blocks`` (``ln``, ``mamba.*``) are stacked on
    two leading axes (n_super, period) and become ``blocks.{i}.{j}.*``; its
    ``shared`` block, ``lora_a`` and ``lora_b`` carry across as they are.
    An audio model's ``enc_blocks`` (leading axis ``enc_layers``) and
    ``dec_blocks`` (``n_layers``; ``ln1``, ``attn``, ``lnx``, ``xattn``,
    ``ln2``, ``ffn``) are unstacked the same way, beside ``ln_enc``.
    Every leaf takes the dtype of the port's own parameter, so ``A_log``,
    ``D`` and ``dt_bias`` stay float32 in a bf16 model, as in the JAX
    package.  ``cfg`` may be either package's configuration
    (:func:`port_config`).  The bcsr block positions must be the port's own
    seeded pattern, which they are for the same ``SparseFFNConfig``.
    """
    cfg = port_config(cfg)
    model = LM(cfg, resolve(device))
    state = {name: np.asarray(value) for name, value in unstack_params(cfg, params).items()}
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"parameter trees differ: only in params "
                         f"{sorted(set(state) - set(own))}, only in the port "
                         f"{sorted(set(own) - set(state))}")
    for name, target in own.items():
        # float leaves through float32 (exact for bf16), indices as int64
        value = torch.as_tensor(np.array(
            state[name], np.float32 if target.is_floating_point() else np.int64))
        if value.shape != target.shape:
            raise ValueError(f"{name}: shape {tuple(value.shape)}, the port "
                             f"expects {tuple(target.shape)}")
        if name.endswith(("_rows", "_cols")):
            if not torch.equal(value.to(target.device), target.long()):
                raise ValueError(f"{name}: another block pattern than the port's")
        target.copy_(value)
    return model

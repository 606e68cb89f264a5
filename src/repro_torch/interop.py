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
``torch.Generator`` draw different weights from one seed).
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

__all__ = ["split", "prep_from_arrays", "port_config", "lm_params_from_numpy"]

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
    # the stacked trees and their leading (layer) axes
    if cfg.family == "hybrid":
        stacked = {"blocks": (cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period)}
    elif cfg.family == "audio":
        stacked = {"enc_blocks": (cfg.enc_layers,), "dec_blocks": (cfg.n_layers,)}
    else:
        stacked = {"blocks": (cfg.n_layers,)}

    def flat(tree, prefix=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", np.asarray(value)

    state = {}
    for name, value in flat(params):
        top, _, rest = name.partition(".")
        lead = stacked.get(top)
        if lead is None:
            state[name] = value
            continue
        if value.shape[:len(lead)] != lead:
            raise ValueError(f"{name}: leading axes {value.shape[:len(lead)]}, "
                             f"the config has {lead}")
        for index in np.ndindex(*lead):
            state[f"{top}.{'.'.join(map(str, index))}.{rest}"] = value[index]
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

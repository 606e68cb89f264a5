"""Shard specs for every input of a step: parameters, optimizer state,
batches and decode state.  The port of the JAX package's
``launch.shardspecs``.

A spec is a plain tuple with one entry per dimension: the mesh axis (or
tuple of mesh axes, the first major) that splits the dimension, or None,
in ``PartitionSpec``'s normal form; where the JAX package returns a
``NamedSharding`` tree, the port returns the same tree of specs for the
given mesh.  :func:`fit_spec` is the safety net for uneven dimensions (GQA
kv heads over a wide ``model`` axis, a batch of one over ``data``): a mesh
axis that does not divide its dimension is dropped to replication.

Parameter and optimizer trees are the port's flat ``{name: ...}`` dicts
(:func:`repro_torch.models.lm.param_axes`); batch and decode-state trees
are dicts of tensors or shapes.  Decode caches shard their slot dimension
over ``model``, as the JAX package's do.  ``sparse_rhs_sharding`` is left
out with distributed SpMSpV (ROADMAP A).
"""
from __future__ import annotations

from repro_torch.core.distributed import Mesh
from repro_torch.models.common import MeshRules, spec_entry, default_rules
from repro_torch.models.lm import ModelConfig

from .mesh import batch_axes

__all__ = ["rules_for", "fit_spec", "fit_tree", "param_shardings", "opt_shardings",
           "batch_shardings", "decode_state_shardings"]


def rules_for(mesh: Mesh) -> MeshRules:
    return default_rules(multi_pod="pod" in mesh.axis_names)


def axis_size(mesh: Mesh, axes) -> int:
    """Cells along a spec entry: 1 for None, the product for a tuple."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _shape(x) -> tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def fit_spec(mesh: Mesh, spec: tuple, shape) -> tuple:
    """``spec`` with each mesh axis that does not evenly divide its
    dimension dropped to None; one entry per entry of ``spec``."""
    shape = _shape(shape)
    out = []
    for i, axes in enumerate(spec):
        if i >= len(shape):
            out.append(None)
            continue
        size = axis_size(mesh, axes)
        out.append(spec_entry(axes) if size > 0 and shape[i] % size == 0 else None)
    return tuple(out)


def fit_tree(mesh: Mesh, spec_tree: dict, shape_tree: dict) -> dict:
    """(spec tree, tree of tensors or shapes) -> fitted spec tree."""
    return {k: fit_tree(mesh, v, shape_tree[k]) if isinstance(v, dict)
            else fit_spec(mesh, v, shape_tree[k]) for k, v in spec_tree.items()}


def param_shardings(mesh: Mesh, rules: MeshRules, axes_tree: dict,
                    shapes_tree: dict) -> dict:
    return fit_tree(mesh, rules.tree_specs(axes_tree), shapes_tree)


def opt_shardings(mesh: Mesh, rules: MeshRules, axes_tree: dict, shapes_tree: dict,
                  opt_state_shapes: dict) -> dict:
    """The AdamW state's specs: ``m``, ``v`` (and ``master``) as their
    parameters, ``count`` replicated."""
    ps_spec = rules.tree_specs(axes_tree)
    out = {
        "m": fit_tree(mesh, ps_spec, opt_state_shapes["m"]),
        "v": fit_tree(mesh, ps_spec, opt_state_shapes["v"]),
        "count": (),
    }
    if "master" in opt_state_shapes:
        out["master"] = fit_tree(mesh, ps_spec, opt_state_shapes["master"])
    return out


def batch_shardings(mesh: Mesh, cfg: ModelConfig, batch_shapes: dict) -> dict:
    """Every batch leaf split over the batch axes on its leading dimension;
    ``positions`` (3, b, s) on its second."""
    ba = batch_axes(mesh)
    specs = {}
    for key, sd in batch_shapes.items():
        if key == "positions":
            specs[key] = (None, ba, None)
        else:
            specs[key] = (ba, *([None] * (len(_shape(sd)) - 1)))
    return fit_tree(mesh, specs, batch_shapes)


def _kv_cache_spec(ba) -> dict:
    # k/v: (L, b, slots, kvh, hd), slots over 'model'; positions (L, b,
    # slots) and pos (L, b) follow the batch and slot splits
    return {
        "k": (None, ba, "model", None, None),
        "v": (None, ba, "model", None, None),
        "positions": (None, ba, "model"),
        "pos": (None, ba),
    }


def decode_state_shardings(mesh: Mesh, cfg: ModelConfig, state_shapes: dict) -> dict:
    """Specs of :func:`repro_torch.models.lm.init_decode_state`'s tree."""
    ba = batch_axes(mesh)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        specs = {"kv": _kv_cache_spec(ba)}
    elif fam == "ssm":
        specs = {
            "rwkv": {
                "tm_shift": (None, ba, "model"),
                "cm_shift": (None, ba, "model"),
                "wkv": (None, ba, "model", None, None),
            }
        }
    elif fam == "hybrid":
        specs = {
            "kv": _kv_cache_spec(ba),
            "mamba": {
                "conv": (None, None, ba, None, "model"),
                "ssd": (None, None, ba, "model", None, None),
            },
        }
    elif fam == "audio":
        specs = {
            "kv": _kv_cache_spec(ba),
            "cross": {
                "k": (None, ba, None, None, None),
                "v": (None, ba, None, None, None),
            },
        }
    else:
        raise ValueError(fam)
    return fit_tree(mesh, specs, state_shapes)

"""Op-level cost analysis of an eager step: the port's counterpart of the
JAX package's ``launch.hlo_analysis``.

The JAX package compiles a step and reads FLOPs and bytes off the HLO
text, multiplying while bodies by their trip counts, because XLA's own
cost analysis visits a loop body once.  The port runs eagerly, and
:class:`OpAnalyzer`, a ``TorchDispatchMode``, sees every aten op the step
executes, the backward pass and the recomputation of ``remat="full"``
included: a loop over layers or tokens dispatches its ops once per
iteration, so the loop multiplication that ``hlo_analysis`` exists for
does not arise.  On ``meta`` tensors the step runs with no storage and no
card, so a full-size model's step is costed on the host.

Conventions (``hlo_analysis``'s, per aten op):

  flops       a matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``, and what
              ``einsum``, ``matmul`` and ``linear`` lower to; ``mv``,
              ``addmv``, ``dot``) costs 2*M*N*K, the bias of ``addmm`` and
              ``baddbmm`` folded in; an elementwise op (``Tag.pointwise``)
              costs 1 an output element, a reduction 1 an input element;
              casts, copies, gathers and allocations cost none
  hbm_bytes   operand bytes plus output bytes.  A view (``view``,
              ``detach``, ``permute``, ``expand``, ...) costs nothing; an
              in-place op counts its output once (what it reads, self
              included, plus the write); ``copy_``, ``fill_`` and
              ``zero_`` read only their source; a gather (``embedding``,
              ``index_select``, ``gather``, ``index``) moves twice its
              output plus its indices, and an in-place scatter
              (``index_put_``, ``index_copy_``, ``index_add_``,
              ``scatter_``, ``scatter_add_``) twice its update plus its
              indices, not the whole table; ``empty`` moves nothing and a
              filled factory (``zeros``, ``full``, ``arange``) writes its
              output.

The matmul FLOPs are also kept apart (``matmul_flops``): the share that
the profiler's ``with_flops`` counts and that the JAX package's dot ops
hold.  The analyzer tracks the bytes of every storage the step allocates
while it is alive (``peak_bytes``, ``live_bytes``), and keeps a per-op
trace aggregated by identical rows (op, input and output shapes and
dtypes, count: ``rows``), which :func:`rows_cost` turns back into an
:class:`OpCost` (``launch.rescore`` re-scores saved traces with it).  Collective bytes are
not ops: the dry run adds them from the mesh layouts.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "OpAnalyzer", "op_cost", "rows_cost"]

MATMULS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "linalg_vector_norm",
              "norm", "var", "std", "var_mean", "std_mean", "prod", "cumsum", "cumprod",
              "argmax", "argmin", "any", "all", "_softmax", "_log_softmax", "topk", "sort",
              "count_nonzero"}
POINTWISE_EXTRA = {"_softmax_backward_data", "_log_softmax_backward_data"}
GATHERS = {"embedding", "index_select", "gather", "index"}
SCATTERS = {"index_put_", "index_put", "index_copy_", "index_add_", "scatter_", "scatter_add_",
            "_index_put_impl_"}
OVERWRITES = {"copy_", "fill_", "zero_"}
EMPTY = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
ALIASES = {"_unsafe_view", "alias", "lift_fresh"}
_ITEMSIZE: dict[str, int] = {}


@dataclasses.dataclass
class OpCost:
    """A step's (or a card's) FLOPs, HBM bytes and collective bytes, as the
    JAX package's ``HLOCost``; ``matmul_flops`` is the matmuls' share of
    ``flops``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    matmul_flops: float = 0.0

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.hbm_bytes * k, self.collective_bytes * k,
                      {n: c * k for n, c in self.collectives.items()}, self.matmul_flops * k)

    def __iadd__(self, o: "OpCost"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.collective_bytes += o.collective_bytes
        self.matmul_flops += o.matmul_flops
        for k, v in o.collectives.items():
            self.collectives[k] = self.collectives.get(k, 0) + v
        return self


def _itemsize(dtype: str) -> int:
    if dtype not in _ITEMSIZE:
        _ITEMSIZE[dtype] = getattr(torch, dtype.removeprefix("torch.")).itemsize
    return _ITEMSIZE[dtype]


def _nbytes(spec) -> int:
    shape, dtype = spec
    return math.prod(shape) * _itemsize(dtype)


@functools.lru_cache(maxsize=None)
def _kind(op: str) -> tuple[str, str]:
    """(base name, kind) of an op named ``aten.<name>.<overload>``: kind is
    ``view``, ``inplace``, ``inplace-pointwise`` or ``op`` (from the op's
    schema and tags), or ``pointwise`` for an out-of-place elementwise op."""
    ns, name, overload = op.split(".")
    func = getattr(getattr(getattr(torch.ops, ns), name), overload)
    schema = func._schema
    if any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments):
        return name, ("inplace-pointwise" if torch.Tag.pointwise in func.tags else "inplace")
    if name in ALIASES or any(r.alias_info is not None for r in schema.returns):
        return name, "view"
    if torch.Tag.pointwise in func.tags or name in POINTWISE_EXTRA:
        return name, "pointwise"
    return name, "op"


def op_cost(op: str, ins: tuple, outs: tuple) -> tuple[float, float, float]:
    """(flops, hbm bytes, matmul flops) of one call of ``op`` (``aten.mm.
    default``) whose tensor inputs and outputs have the (shape, dtype)
    specs ``ins`` and ``outs`` (dtype as ``str(torch.dtype)``), under the
    module's conventions."""
    name, kind = _kind(op)
    if kind == "view" or name in EMPTY:
        return 0.0, 0.0, 0.0
    in_b = sum(_nbytes(s) for s in ins)
    out_b = sum(_nbytes(s) for s in outs)
    out_n = sum(math.prod(s[0]) for s in outs)
    if name in MATMULS:
        # K: the last dimension of the left matrix (of either vector of dot)
        k = ins[0][0][-1] if name == "dot" else ins[-2][0][-1]
        f = 2.0 * out_n * k
        return f, float(in_b + out_b), f
    if name in GATHERS:
        idx = sum(_nbytes(s) for s in ins[1:])  # the table is the first input
        return 0.0, float(2 * out_b + idx), 0.0
    if name in SCATTERS:
        upd = _nbytes(ins[-1])
        idx = sum(_nbytes(s) for s in ins[1:-1])
        return (float(math.prod(ins[-1][0])) if name == "index_add_" else 0.0,
                float(2 * upd + idx), 0.0)
    if name in OVERWRITES:
        return 0.0, float(sum(_nbytes(s) for s in ins[1:]) + out_b), 0.0
    if kind in ("inplace", "inplace-pointwise"):
        # the output aliases self: what the op reads plus one write
        flops = float(out_n) if kind == "inplace-pointwise" else 0.0
        return flops, float(in_b + out_b), 0.0
    if kind == "pointwise":
        return float(out_n), float(in_b + out_b), 0.0
    if name in REDUCTIONS:
        return float(math.prod(ins[0][0])) if ins else 0.0, float(in_b + out_b), 0.0
    if not ins:  # a filled factory: zeros, full, arange, ...
        return 0.0, float(out_b), 0.0
    return 0.0, float(in_b + out_b), 0.0


def rows_cost(rows) -> OpCost:
    """The :class:`OpCost` of trace rows ``[op, ins, outs, count]``."""
    total = OpCost()
    for op, ins, outs, count in rows:
        f, b, mm = op_cost(op, _specs(ins), _specs(outs))
        total.flops += f * count
        total.hbm_bytes += b * count
        total.matmul_flops += mm * count
    return total


def _specs(specs) -> tuple:
    return tuple((tuple(s), d) for s, d in specs)


def _spec_of(leaves) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in leaves if isinstance(t, torch.Tensor))


class OpAnalyzer(TorchDispatchMode):
    """``with OpAnalyzer() as an: step(...)``: every aten op the block
    dispatches, counted by identical row in ``an.rows`` ((op, input specs,
    output specs) -> calls), with the live bytes of the storages those ops
    allocate (``an.live_bytes``) and their peak (``an.peak_bytes``).  A
    storage that existed before the block (a parameter, the optimizer
    state) is not counted, so the peak is the step's temporaries."""

    def __init__(self):
        super().__init__()
        self.rows: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        in_leaves = tree_flatten((args, kwargs))[0]
        out_leaves = tree_flatten(out)[0]
        self.rows[(str(func), _spec_of(in_leaves), _spec_of(out_leaves))] += 1
        known = {t.untyped_storage()._cdata for t in in_leaves if isinstance(t, torch.Tensor)}
        for t in out_leaves:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    @property
    def n_ops(self) -> int:
        """Aten ops dispatched, views included."""
        return sum(self.rows.values())

    @property
    def n_compute_ops(self) -> int:
        """Aten ops that are not views or bare allocations: what a card
        would launch a kernel for."""
        return sum(n for (op, _, _), n in self.rows.items()
                   if _kind(op)[1] != "view" and _kind(op)[0] not in EMPTY)

    def cost(self) -> OpCost:
        return rows_cost((op, ins, outs, n) for (op, ins, outs), n in self.rows.items())


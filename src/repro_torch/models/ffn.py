"""Feed-forward layers: dense SwiGLU / GELU, and the block-sparse FFN.

The block-sparse FFN is the paper's kernels as a model layer: y =
W2 · silu(W1 · x) with W1 (d_ff × d_model) and W2 (d_model × d_ff)
block-sparse, their block patterns drawn at init from
``np.random.default_rng(cfg.seed)`` exactly as the JAX package draws them
(bit for bit).  Two kinds:

* ``structured``: G diagonal groups plus a banded halo on the hidden
  dimension, as reshaped dense products (the JAX package's multi-chip
  form; plain torch here);
* ``bcsr``: arbitrary block patterns through the BCSR kernel
  (``kernels/bcsr_spmm.py``, ``csrc/bcsr_spmm.cu``).  ``impl="cuda"``
  (the default) runs the kernel, in the model's dtype: bf16 weights and
  activations take its bf16 path, float32 its float32 path; ``"ref"`` is
  the plain dense-block product; ``"auto"`` is resolved per weight by
  :func:`tune_sparse_ffn`.  Each weight's block-row pointer (``indptr``,
  which the kernel walks) is built once at init.

The kernel has no backward: under grad, a ``"cuda"`` tier whose weight or
input requires grad raises ``NotImplementedError`` (on the CPU too), and
``"ref"`` trains.  The kernel returns float32; the layer returns the
input's dtype, so a bf16 model's residual stream stays bf16.  (The JAX
package's ``"pallas"`` tier returns float32 there, which its layer scan
refuses for a bf16 model: ROADMAP C.17.)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain

from .common import frozen, upcast, weight

__all__ = ["swiglu_init", "swiglu_apply", "gelu_ffn_init", "gelu_ffn_apply",
           "SwiGLU", "GeluFFN", "SparseFFN", "SparseFFNConfig",
           "sparse_ffn_init", "sparse_ffn_apply", "sparse_ffn_weight_csr",
           "tune_sparse_ffn"]


# ---------------------------------------------------------------------------
# Dense SwiGLU (llama family) and GELU (whisper) FFNs
# ---------------------------------------------------------------------------
class SwiGLU(nn.Module):
    # logical axes of each weight (``lm.param_axes``), the JAX package's
    AXES = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}

    def __init__(self, d_model: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        self.wi_gate = weight(gen, (d_model, d_ff), dtype, device)
        self.wi_up = weight(gen, (d_model, d_ff), dtype, device)
        self.wo = weight(gen, (d_ff, d_model), dtype, device)

    def forward(self, x):
        gate = x @ self.wi_gate
        up = x @ self.wi_up
        h = F.silu(upcast(gate)).to(x.dtype) * up
        return h @ self.wo


class GeluFFN(nn.Module):
    AXES = {"wi": ("embed", "mlp"), "bi": ("mlp",), "wo": ("mlp", "embed"),
            "bo": ("embed",)}

    def __init__(self, d_model: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        self.wi = weight(gen, (d_model, d_ff), dtype, device)
        self.bi = frozen(torch.zeros((d_ff,), dtype=dtype, device=device))
        self.wo = weight(gen, (d_ff, d_model), dtype, device)
        self.bo = frozen(torch.zeros((d_model,), dtype=dtype, device=device))

    def forward(self, x):
        h = x @ self.wi + self.bi
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(upcast(h), approximate="tanh").to(x.dtype)
        return h @ self.wo + self.bo


def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.float32) -> SwiGLU:
    return SwiGLU(d_model, d_ff, dtype, gen.device, gen)


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return p(x)


def gelu_ffn_init(gen, d_model: int, d_ff: int, dtype=torch.float32) -> GeluFFN:
    return GeluFFN(d_model, d_ff, dtype, gen.device, gen)


def gelu_ffn_apply(p: GeluFFN, x: torch.Tensor) -> torch.Tensor:
    return p(x)


# ---------------------------------------------------------------------------
# Block-sparse FFN
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SparseFFNConfig:
    kind: str = "structured"  # "structured" | "bcsr"
    n_groups: int = 8  # diagonal groups (structured)
    band: int = 1  # banded halo width in groups (0 = pure block-diagonal)
    density: float = 0.25  # bcsr: fraction of (bm, bk) blocks kept
    block: tuple[int, int] = (128, 128)  # bcsr block shape
    seed: int = 0
    # bcsr execution tier: "cuda" (the BCSR kernel; its plain version on
    # the CPU), "ref" (plain dense-block product), or "auto" — resolved to
    # one of the two per weight by tune_sparse_ffn.  impl drives W1,
    # impl_w2 drives W2 (None = follow impl).
    impl: str = "cuda"
    impl_w2: str | None = None

    def impl_for(self, which: str) -> str:
        if which == "w2" and self.impl_w2 is not None:
            return self.impl_w2
        return self.impl


def bcsr_pattern(cfg: SparseFFNConfig, d_model: int, d_ff: int):
    """((rows1, cols1), (rows2, cols2)): the W1 and W2 block positions, row
    sorted, every block row keeping at least one block."""
    bm, bk = cfg.block
    gm, gk = d_ff // bm, d_model // bk
    rng = np.random.default_rng(cfg.seed)
    mask1 = rng.random((gm, gk)) < cfg.density
    mask1[:, 0] |= ~mask1.any(axis=1)
    mask2 = rng.random((gk, gm)) < cfg.density
    mask2[:, 0] |= ~mask2.any(axis=1)
    return np.nonzero(mask1), np.nonzero(mask2)


class SparseFFN(nn.Module):
    """The block-sparse FFN's weights.  bcsr: ``w*_blocks`` (n, bm, bk) for
    W1 and (n, bk, bm) for W2, ``w*_rows`` / ``w*_cols`` int32 (as the JAX
    package stores them) and ``w*_indptr`` (not part of the state dict;
    derived from the rows)."""

    AXES = {"w1": (None, "embed", "mlp"), "w2": (None, "mlp", "embed"),  # structured
            "w1_blocks": (None, None, None), "w2_blocks": (None, None, None),
            "w1_rows": (None,), "w1_cols": (None,), "w2_rows": (None,), "w2_cols": (None,)}

    def __init__(self, d_model: int, d_ff: int, cfg: SparseFFNConfig, dtype,
                 device, gen=None):
        super().__init__()
        if cfg.kind == "structured":
            G = cfg.n_groups
            if d_model % G or d_ff % G:
                raise ValueError(f"d_model {d_model} and d_ff {d_ff} must divide "
                                 f"into {G} groups")
            dm_g, df_g = d_model // G, d_ff // G
            width = 1 + 2 * cfg.band
            self.w1 = weight(gen, (G, width * dm_g, df_g), dtype, device)
            self.w2 = weight(gen, (G, df_g, width * dm_g), dtype, device)
            return
        if cfg.kind != "bcsr":
            raise ValueError(cfg.kind)
        bm, bk = cfg.block
        (r1, c1), (r2, c2) = bcsr_pattern(cfg, d_model, d_ff)
        self.w1_blocks = weight(gen, (len(r1), bm, bk), dtype, device,
                                scale=(cfg.density * d_model) ** -0.5)
        self.w2_blocks = weight(gen, (len(r2), bk, bm), dtype, device,
                                scale=(cfg.density * d_ff) ** -0.5)
        for which, rows, cols, n_rows in (("w1", r1, c1, d_ff // bm),
                                          ("w2", r2, c2, d_model // bk)):
            indptr = np.zeros(n_rows + 1, np.int64)
            np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
            self.register_buffer(f"{which}_rows", torch.as_tensor(
                rows, dtype=torch.int32, device=device))
            self.register_buffer(f"{which}_cols", torch.as_tensor(
                cols, dtype=torch.int32, device=device))
            self.register_buffer(f"{which}_indptr", torch.as_tensor(
                indptr, dtype=torch.int32, device=device), persistent=False)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


def sparse_ffn_init(gen, d_model: int, d_ff: int, cfg: SparseFFNConfig,
                    dtype=torch.float32) -> SparseFFN:
    return SparseFFN(d_model, d_ff, cfg, dtype, gen.device, gen)


def _structured_gather(x_g: torch.Tensor, band: int) -> torch.Tensor:
    """x_g (b, s, G, dm_g) -> (b, s, G, width * dm_g) with the banded halo."""
    parts = [torch.roll(x_g, shifts=-o, dims=2) for o in range(-band, band + 1)]
    return torch.cat(parts, dim=-1)


def sparse_ffn_apply(p: SparseFFN, x: torch.Tensor, cfg: SparseFFNConfig,
                     d_ff: int) -> torch.Tensor:
    b, s, d_model = x.shape
    if cfg.kind == "structured":
        G = p.w1.shape[0]
        x_g = x.reshape(b, s, G, d_model // G)
        h = torch.einsum("bsge,gef->bsgf", _structured_gather(x_g, cfg.band), p.w1)
        h = F.silu(h.float()).to(x.dtype)
        y = torch.einsum("bsgf,gfe->bsge", h, p.w2)
        width = 1 + 2 * cfg.band
        out = torch.zeros_like(x_g)
        for part, o in zip(torch.split(y, y.shape[-1] // width, dim=-1),
                           range(-cfg.band, cfg.band + 1)):
            out = out + torch.roll(part, shifts=o, dims=2)
        return out.reshape(b, s, d_model)
    if cfg.kind != "bcsr":
        raise ValueError(cfg.kind)
    bm, bk = cfg.block
    T = b * s

    def mm(which: str, x_blocked: torch.Tensor) -> torch.Tensor:
        impl = cfg.impl_for(which)
        fn = {"cuda": bcsr_spmm, "ref": bcsr_spmm_plain}.get(impl)
        if fn is None:
            raise ValueError(f"sparse FFN impl {impl!r} for {which}: resolve "
                             "'auto' with tune_sparse_ffn first")
        blocks = p[f"{which}_blocks"]
        if impl == "cuda" and torch.is_grad_enabled() and (
                blocks.requires_grad or x_blocked.requires_grad):
            raise NotImplementedError(
                f"the bcsr FFN's {which} runs the BCSR kernel (impl='cuda'), which "
                "has no backward; train the FFN with impl='ref' (the plain "
                "dense-block product), as the JAX package's jax.grad through its "
                "Pallas tier raises too")
        return fn(blocks, p[f"{which}_cols"], p[f"{which}_indptr"], x_blocked)

    # the kernel takes A @ X with X (n_col_blocks, bk, T) contiguous
    xt = x.reshape(T, d_model).t().contiguous().view(d_model // bk, bk, T)
    h = F.silu(mm("w1", xt)).to(x.dtype)  # (d_ff // bm, bm, T)
    y = mm("w2", h)  # (d_model // bk, bk, T) float32
    return y.reshape(d_model, T).t().reshape(b, s, d_model).to(x.dtype)


# ---------------------------------------------------------------------------
# Autotuned routing: the FFN weight matrices through repro_torch.tune
# ---------------------------------------------------------------------------
def sparse_ffn_weight_csr(p, which: str, cfg: SparseFFNConfig, d_model: int,
                          d_ff: int):
    """One bcsr FFN weight (``which`` in {"w1", "w2"}) as a host CSRMatrix,
    from a :class:`SparseFFN` (every layer shares the seeded pattern, which
    is all the structure-keyed tuner looks at)."""
    from repro_torch.core.formats import csr_from_coo

    bm, bk = cfg.block
    blocks = p[f"{which}_blocks"].detach().float().cpu().numpy()
    brows = p[f"{which}_rows"].cpu().numpy().astype(np.int64)
    bcols = p[f"{which}_cols"].cpu().numpy().astype(np.int64)
    if which == "w2":
        bm, bk = bk, bm  # w2 blocks are (bk, bm): maps d_ff -> d_model
        shape = (d_model, d_ff)
    else:
        shape = (d_ff, d_model)
    ii, jj = np.meshgrid(np.arange(bm), np.arange(bk), indexing="ij")
    rows = (brows[:, None, None] * bm + ii[None]).reshape(-1)
    cols = (bcols[:, None, None] * bk + jj[None]).reshape(-1)
    return csr_from_coo(shape, rows, cols, blocks.reshape(-1), sum_duplicates=False)


def tune_sparse_ffn(cfg: SparseFFNConfig, p, d_model: int, d_ff: int, *,
                    k: int = 16, cache=None, **build_kwargs) -> SparseFFNConfig:
    """Resolve ``impl="auto"`` by routing each weight through the tuner.

    W1 and W2 are separate searches (transposed shapes, independent
    patterns, their own cache entries).  Each weight's CSR form runs
    :class:`repro_torch.tune.SparseOperator`'s measured SpMM search at
    width ``k`` (at least 2), on ``p``'s device unless ``device=`` says
    otherwise; a winning ``("bcsr", "cuda")`` plan keeps the kernel
    (``"cuda"``), anything else selects the plain ``"ref"`` tier.
    """
    from repro_torch.tune import SparseOperator

    if cfg.kind != "bcsr" or cfg.impl != "auto":
        return cfg
    build_kwargs.setdefault("device", p["w1_blocks"].device)

    def resolve(which: str) -> str:
        a = sparse_ffn_weight_csr(p, which, cfg, d_model, d_ff)
        plan = SparseOperator.build(a, k=max(int(k), 2), cache=cache,
                                    **build_kwargs).plan
        return "cuda" if (plan.fmt, plan.impl) == ("bcsr", "cuda") else "ref"

    return dataclasses.replace(cfg, impl=resolve("w1"), impl_w2=resolve("w2"))

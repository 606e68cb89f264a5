"""The port's public surface against the JAX package's, on the CPU.

* Every public name of each facade ``src/repro/<pkg>/__init__.py`` (its
  ``__all__``, else the names its source binds) has a counterpart in
  ``repro_torch.<pkg>``, the port's own object, except the left-outs
  stated in ``LEFT_OUT``.  Every module of ``repro`` has a module of the
  same path in the port, except ``MODULES_LEFT_OUT``.
* ``core.spmv`` / ``core.spmm`` dispatch as ``repro``'s: for each format
  (CSR, SELL, BCSR, merge) and impl, on the same numpy inputs, within
  1e-5 (|A| |x|)_i of ``repro``'s plain tier and of a float64 oracle (the
  merge tier within its own limit, 1e-5 (|A| |x|)_i + 8 * 2**-24 * max|P|).
  ``impl="cuda"`` on CPU tensors runs the kernels' plain versions;
  ``"pallas"`` raises.
* ``.device("cpu")`` of CSR, BCSR and SELL holds ``repro``'s ``.device()``
  keys with equal values (BCSR's and SELL's beside the kernels' fill-in,
  SELL's through the port's slot-major layout);
  ``SparseOperator.matvec`` is ``op @ x``; ``kernels.ref.
  banded_attention_scores_ref`` equals ``repro``'s.
"""
import ast
import importlib
import inspect
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.kernels import merge_spmv as jmerge
from repro.kernels import ref as jref

import repro_torch.core as tcore
import repro_torch.tune as ttune
from repro_torch.kernels import merge_spmv as tmerge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_tiers import limits, rand_dense, rand_x

# the modules (the facades' ``spmv`` is the dispatcher function)
jspmv = importlib.import_module("repro.core.spmv")

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Names of the JAX package's facades that the port leaves out on purpose
# (ROADMAP A, "Left out on purpose"), by facade.
LEFT_OUT = {
    # the TPU kernels' own names: the port's kernels are ``sell_spmv``,
    # ``sell_spmv_blocked`` and ``bcsr_spmm`` (no ``*_pallas`` aliases)
    "kernels": {"bcsr_spmm_pallas", "sell_spmv_pallas", "sell_spmv_blocked_pallas",
                # a helper with no pallas_call; its multi-stage loads live in
                # the BCSR kernels' cp.async rings
                "slab_pipeline"},
}
# Modules of the JAX package with no module of the same path in the port.
MODULES_LEFT_OUT = {
    "core/compat.py",  # jax-version shims
    "kernels/pipeline.py",  # slab_pipeline, above
    "launch/hlo_analysis.py",  # replaced by launch/op_analysis.py (an aten-op analyzer)
}
# Names of ``repro.models.common`` the port has no counterpart of: ``Px`` is
# a GSPMD layout hint and ``KeyGen`` a JAX PRNG key splitter (the port
# draws from explicit ``torch.Generator``s).
COMMON_LEFT_OUT = {"Px", "KeyGen"}


def facade_names(path: Path) -> set[str]:
    """The public names a facade binds: its ``__all__`` if it has one, else
    every name its source imports from a module of the package or defines
    at top level (imports of other packages, such as ``jax``, are not part
    of the surface)."""
    tree = ast.parse(path.read_text())
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
        if isinstance(node, ast.ImportFrom) and node.module != "__future__" and (
                node.level > 0 or (node.module or "").startswith("repro")):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


FACADES = sorted(p.parent.name for p in REF.glob("*/__init__.py"))


def test_the_facades_are_the_ones_expected():
    assert FACADES == ["checkpoint", "configs", "core", "kernels", "optim", "tune"]


@pytest.mark.parametrize("pkg", FACADES)
def test_every_facade_name_has_the_ports_own_counterpart(pkg):
    ref_names = facade_names(REF / pkg / "__init__.py")
    left_out = LEFT_OUT.get(pkg, set())
    assert left_out <= ref_names, left_out - ref_names  # the list stays current
    mod = importlib.import_module(f"repro_torch.{pkg}")
    missing = sorted(n for n in ref_names - left_out if not hasattr(mod, n))
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    for name in sorted(ref_names - left_out):
        obj = getattr(mod, name)
        owner = (obj.__name__ if isinstance(obj, types.ModuleType)
                 else getattr(obj, "__module__", None))
        if owner is not None and (inspect.isroutine(obj) or inspect.isclass(obj)
                                  or isinstance(obj, types.ModuleType)):
            assert owner.startswith("repro_torch."), (pkg, name, owner)
    assert not any(hasattr(mod, n) for n in left_out)


def test_every_reference_module_has_a_port_module():
    ref = {str(p.relative_to(REF)) for p in REF.rglob("*.py")}
    port = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert MODULES_LEFT_OUT <= ref
    assert sorted(ref - port - MODULES_LEFT_OUT) == []


def test_models_common_left_outs_are_the_stated_ones():
    jcommon = facade_names(REF / "models" / "common.py")
    tcommon = importlib.import_module("repro_torch.models.common")
    assert COMMON_LEFT_OUT <= jcommon
    assert not any(hasattr(tcommon, n) for n in COMMON_LEFT_OUT)


def test_facade_imports_of_the_examples_work():
    from repro_torch.core import bcsr_from_csr, rcm, spmm, spmv, spmv_csr, ucld  # noqa: F401
    from repro_torch.kernels import (  # noqa: F401
        bcsr_spmm,
        merge_spmv,
        ops,
        ref,
        sell_spmv,
        sell_spmv_blocked,
        spmspv_scatter,
    )
    from repro_torch.optim import ef_compressed_psum, quantize_int8  # noqa: F401
    from repro_torch.tune import (  # noqa: F401
        MERGE_CHUNKS,
        REORDER_METHODS,
        SCHEDULES,
        TIMED,
        WARMUP,
        bcsr_block_count,
        enumerate_mesh_candidates,
        sell_padded_slots,
        split_reorder,
    )
    assert callable(sell_spmv) and callable(bcsr_spmm) and isinstance(ops, types.ModuleType)


# ---------------------------------------------------------------------------
# the dispatchers
# ---------------------------------------------------------------------------
def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _pair(seed=1, m=300, n=280):
    d = rand_dense(seed, m=m, n=n, empty_rows=(5, 77))
    return d, jformats.csr_from_dense(d), tcore.csr_from_dense(d)


def _check(got, ref, want, lim, what):
    got = _np(got).astype(np.float64)
    for other, label in ((ref, "repro"), (want, "float64")):
        err = np.abs(got - np.asarray(other, np.float64))
        assert err.shape == lim.shape, (what, label, err.shape, lim.shape)
        assert np.all(err <= lim), (what, label, float((err - lim).max()))


@pytest.mark.parametrize("impl", ["vector", "scalar", "cuda"])
@pytest.mark.parametrize("fmt", ["csr", "sell", "merge"])
def test_spmv_dispatch_matches_repro(fmt, impl):
    d, ja, ta = _pair()
    m = d.shape[0]
    x = rand_x(2, d.shape[1], 1)
    want = d.astype(np.float64) @ x.astype(np.float64)
    lim = limits(d, x, merge=fmt == "merge")
    if fmt == "csr":
        jmat, tmat = ja.device(), ta.device("cpu")
    elif fmt == "sell":
        jmat = jformats.sell_from_csr(ja, C=8, sigma=64).device()
        tmat = tcore.sell_from_csr(ta, C=8, sigma=64).device("cpu")
    else:
        jmat, tmat = jmerge.merge_prepare(ja, 2048), tmerge.merge_prepare(ta, 2048,
                                                                         device="cpu")
    ref = jspmv.spmv(fmt, jmat, jnp.asarray(x), n_rows=m,
                     impl="scalar" if impl == "scalar" else "vector")
    got = tcore.spmv(fmt, tmat, torch.as_tensor(x), n_rows=m, impl=impl)
    _check(got, ref, want, lim, f"spmv {fmt} {impl}")


@pytest.mark.parametrize("impl", ["vector", "cuda"])
@pytest.mark.parametrize("fmt", ["csr", "sell", "merge", "bcsr"])
def test_spmm_dispatch_matches_repro(fmt, impl):
    d, ja, ta = _pair(seed=3)
    m, n = d.shape
    k = 5
    x = rand_x(4, n, k)
    want = d.astype(np.float64) @ x.astype(np.float64)
    lim = limits(d, x, merge=fmt == "merge")
    X = torch.as_tensor(x)
    if fmt == "bcsr":
        jb = jformats.bcsr_from_csr(ja, (8, 16))
        tb = tcore.bcsr_from_csr(ta, (8, 16))
        gm, gn = jb.grid_shape
        xb = np.zeros((gn * 16, k), np.float32)
        xb[:n] = x
        xb = xb.reshape(gn, 16, k)
        ref = np.asarray(jspmv.spmm("bcsr", jb.device(), jnp.asarray(xb),
                                    n_rows=gm)).reshape(gm * 8, k)[:m]
        if impl == "cuda":  # the kernel takes X unblocked and returns (m, k)
            got = tcore.spmm("bcsr", tb.device("cpu"), X, n_rows=m, impl="cuda")
            _check(got, ref, want, lim, "spmm bcsr cuda on .device()")
            got = tcore.spmm("bcsr", tops.bcsr_prepare(tb, "cpu"), X, n_rows=m,
                             impl="cuda")
        else:
            got = tcore.spmm("bcsr", tb.device("cpu"), torch.as_tensor(xb),
                             n_rows=gm).reshape(gm * 8, k)[:m]
        _check(got, ref, want, lim, f"spmm bcsr {impl}")
        return
    if fmt == "csr":
        jmat, tmat = ja.device(), ta.device("cpu")
    elif fmt == "sell":
        jmat = jformats.sell_from_csr(ja, C=8, sigma=64).device()
        tmat = tcore.sell_from_csr(ta, C=8, sigma=64).device("cpu")
    else:
        jmat, tmat = jmerge.merge_prepare(ja, 2048), tmerge.merge_prepare(ta, 2048,
                                                                         device="cpu")
    ref = jspmv.spmm(fmt, jmat, jnp.asarray(x), n_rows=m)
    got = tcore.spmm(fmt, tmat, X, n_rows=m, impl=impl)
    _check(got, ref, want, lim, f"spmm {fmt} {impl}")


def test_sell_kernel_dispatch_takes_the_prepared_dict_too():
    d, _, ta = _pair(seed=5)
    x = rand_x(6, d.shape[1], 1)
    sell = tcore.sell_from_csr(ta, C=8, sigma=64, width_align=8)
    a = tcore.spmv("sell", sell.device("cpu"), torch.as_tensor(x), n_rows=d.shape[0],
                   impl="cuda")
    b = tcore.spmv("sell", tops.sell_prepare(sell, device="cpu"), torch.as_tensor(x),
                   n_rows=d.shape[0], impl="cuda")
    assert torch.equal(a, b)


@pytest.mark.parametrize("call", ["spmv", "spmm"])
def test_pallas_impl_raises_and_names_cuda(call):
    _, _, ta = _pair()
    fn = getattr(tcore, call)
    x = torch.zeros(ta.shape[1]) if call == "spmv" else torch.zeros(ta.shape[1], 2)
    with pytest.raises(ValueError, match="cuda"):
        fn("sell" if call == "spmv" else "bcsr", {}, x, n_rows=ta.shape[0],
           impl="pallas")
    with pytest.raises(ValueError, match="unknown format"):
        fn("coo", ta.device("cpu"), x, n_rows=ta.shape[0])


def test_the_bcsr_kernel_wrapper_takes_no_n_tile():
    """ROADMAP C: the JAX package's ``n_tile`` clamps a VMEM strip; the CUDA
    kernel picks its own tiles, so the port has no such knob."""
    assert "n_tile" not in inspect.signature(tops.bcsr_spmm).parameters


# ---------------------------------------------------------------------------
# .device(), matvec, the banded-attention oracle
# ---------------------------------------------------------------------------
def test_device_dicts_hold_the_references_keys_and_values():
    """CSR's dict equals ``repro``'s; BCSR's and SELL's are the kernels'
    prepared dicts (``kops.bcsr_prepare`` / ``kops.sell_prepare``), which
    hold ``repro``'s values and add the fill-in: a zero block at column 0
    for each block row that stores none, and empty chunks (``row_perm``
    -1) up to a multiple of 8 chunks."""
    d, ja, ta = _pair(seed=7)
    d[16:40] = 0  # block rows 2-4 store no block
    jb = jformats.bcsr_from_csr(jformats.csr_from_dense(d), (8, 16))
    tb = tcore.bcsr_from_csr(tcore.csr_from_dense(d), (8, 16))
    js = jformats.sell_from_csr(ja, C=8, sigma=64, width_align=8)
    ts = tcore.sell_from_csr(ta, C=8, sigma=64, width_align=8)
    pairs = [(ja.device(), ta.device("cpu"), {"offsets"}),
             (jb.device(), tb.device("cpu"), {"grid_shape", "block_shape", "shape"}),
             (js.device(), ts.device("cpu"), {"chunk_w", "shape", "chunk_tile"})]
    for ref, got, extra in pairs:
        assert set(got) == set(ref) | extra
        for key, val in ref.items():
            assert torch.is_tensor(got[key]) and got[key].device.type == "cpu"
            assert got[key].dtype == torch.from_numpy(np.array(val)).dtype, key
    csr, bcsr, sell = (got for _, got, _ in pairs)
    for key, val in pairs[0][0].items():
        np.testing.assert_array_equal(_np(csr[key]), np.asarray(val), err_msg=key)
    np.testing.assert_array_equal(_np(csr["offsets"]), ta.indptr.astype(np.int64))

    rows = _np(bcsr["block_rows"]).astype(np.int64)
    fill = ~np.isin(rows, jb.block_rows)
    assert fill.sum() == np.sum(np.diff(jb.indptr) == 0) == 3
    for key in ("block_rows", "block_cols", "blocks"):
        np.testing.assert_array_equal(_np(bcsr[key])[~fill], getattr(jb, key), err_msg=key)
    assert not _np(bcsr["blocks"])[fill].any() and not _np(bcsr["block_cols"])[fill].any()
    np.testing.assert_array_equal(np.diff(_np(bcsr["indptr"])),
                                  np.maximum(np.diff(jb.indptr), 1))

    n = js.n_chunks
    assert sell["cols"].shape[0] % 8 == 0 and sell["cols"].shape[0] > n
    for key in ("cols", "vals"):  # (n_chunks, 8, W) views of slot-major storage
        assert sell[key].transpose(1, 2).is_contiguous() and not sell[key].is_contiguous()
        np.testing.assert_array_equal(_np(sell[key])[:n], getattr(js, key), err_msg=key)
        assert not _np(sell[key])[n:].any()
    np.testing.assert_array_equal(_np(sell["row_perm"])[:n * 8], js.row_perm)
    assert (_np(sell["row_perm"])[n * 8:] == -1).all()


def test_device_defaults_to_the_card_and_raises_without_one():
    _, _, ta = _pair()
    mats = [ta, tcore.bcsr_from_csr(ta, (8, 8)), tcore.sell_from_csr(ta)]
    for mat in mats:
        assert inspect.signature(mat.device).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mat.device()


def test_matvec_is_matmul():
    d, _, ta = _pair(seed=9)
    op = ttune.SparseOperator.from_candidate(ta, ttune.make("csr", "vector"), device="cpu")
    x = torch.as_tensor(rand_x(10, d.shape[1], 1))
    assert torch.equal(op.matvec(x), op @ x)


@pytest.mark.parametrize("window", [1, 4, 64])
def test_banded_attention_scores_equal_the_references(window):
    rng = np.random.default_rng(window)
    q, k = (rng.standard_normal((24, 16)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jref.banded_attention_scores_ref(jnp.asarray(q), jnp.asarray(k),
                                                      window))
    got = tref.banded_attention_scores_ref(torch.as_tensor(q), torch.as_tensor(k),
                                           window).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    band = ~np.isinf(ref)
    np.testing.assert_allclose(got[band], ref[band], rtol=1e-5, atol=1e-5)

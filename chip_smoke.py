#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
scipy; imports nothing of JAX or of the JAX package.  Phases:

1. print the card's name and power limit; build the four kernels from
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a, all in parallel);
2. hold each kernel against its plain torch version on the card, at the
   paper's Table 1 sizes (``cant``, ``ldoor`` at scale 1.0), with x from
   ``default_rng(0)``.  Tolerance per row i: |kernel - plain| <=
   1e-5 * (|A| |x|)_i, because only the summation order differs.  Also
   checks that the csr/vector tier is bitwise repeatable on the card;
3. the tuned main path: ``SparseOperator.build`` on cant for SpMV and k=16
   (fresh plan cache), an ldoor SpMV search over a cut candidate list, and
   pinned column-slab operators on cant (shared-memory x) and ldoor
   (global x); every result against a scipy float64 oracle;
4. serving on cant: a tuned ``SparseEngine`` answers 64 requests; an engine
   pinned to sell/cuda (k=1) and bcsr/cuda (k>1) answers 64 more, async
   equal to ``async_depth=0`` bit for bit; ``repro_torch.launch.serve
   --sparse cant --scale 1.0`` serves 64 more from the plan cache; every
   kernel's launch count over phases 3-4 must be > 0;
5. times per kernel (CUDA events, median of 25 single launches, L2
   flushed before each): kernel, plain version, one cuSPARSE call through
   ``torch.sparse_csr_tensor`` (``library_ms``), and the bound of the
   function itself (see ``bound``), whatever format the kernel stores;
6. sparse right-hand sides (SpMSpV) on the power-law graphs webbase-1M and
   torso1 at scale 1.0, x sorted unique indices from ``default_rng``:
   the scatter kernel against its plain version (at nnz(x) = n/256 and
   n/4, all four engine buckets on webbase-1M); then, with the launch
   counts set to 0, ``SparseOperator.build(webbase, x_nnz=B)`` at the four
   default buckets, a pinned ``spmspv/cuda`` operator, a tuned
   ``SparseEngine`` answering 65 ``submit_sparse`` requests (one thicker
   than n/4, which goes to the dense k=1 lane) and an engine whose sparse
   lane is pinned to ``spmspv/cuda`` at ``async_depth`` 2 and 0, all
   against a scipy float64 oracle; last the scatter's times at the four
   buckets (kernel, plain ``index_add_``, which is also the library call,
   the bound 8*T + 4*m bytes) beside a whole ``apply_sparse`` and one
   cuSPARSE ``torch.mv`` on the densified x.  The scatter's atomics reorder
   each row's sum: a row that breaks 1e-5 * (|A| |x|)_i is printed with its
   term count k_i and held to k_i * 2**-24 * (|A| |x|)_i instead.

Any failed check exits non-zero.  The last lines are the card's name and
power limit, one JSON object with the kernel table, and the JSON status
line.  The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5  # relative to (|A| |x|)_i: only the summation order differs
REPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
K_BUCKETS = (1, 4, 16, 64)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")

    import numpy as np
    import scipy.sparse as sp

    from repro_torch.core.formats import bcsr_from_csr, sell_from_csr
    from repro_torch.core.spmv import csr_prepare, spmm_csr, spmv_csr
    from repro_torch.data.suite import generate
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain
    from repro_torch.kernels.sell_spmv import (
        sell_spmv,
        sell_spmv_blocked,
        sell_spmv_blocked_plain,
        sell_spmv_plain,
        stages_x_in_smem,
    )
    from repro_torch.kernels.spmspv import (
        expand_products,
        pad_sparse_rhs,
        spmspv_prepare,
        spmspv_scatter,
        spmspv_scatter_plain,
        work_bucket,
    )
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime.engine import SparseEngine
    from repro_torch.tune import (
        BCSR_BLOCKS,
        NoSpMMTier,
        PlanCache,
        SparseOperator,
        make,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions stay float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record: dict = {"phases_s": {}}
    t_start = time.perf_counter()

    def phase_done(name: str, t0: float) -> None:
        record["phases_s"][name] = round(time.perf_counter() - t0, 3)
        print(f"[{name}] done in {record['phases_s'][name]:.1f}s", flush=True)

    lap_t = [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the previous lap, printed and kept in the record."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        record.setdefault("laps_s", {})[name] = round(now - lap_t[0], 3)
        print(f"  [{name}: {now - lap_t[0]:.2f}s]", flush=True)
        lap_t[0] = now

    # -- phase 1: card and build ------------------------------------------
    t0 = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"numpy {np.__version__}", flush=True)
    targets = _build.ensure_built()
    for name, path in targets.items():
        ptxas = [ln for ln in _build.BUILD_LOG.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"built {path.name}: " + ("; ".join(ptxas) or "(cached)"))
    record["build"] = {n: _build.BUILD_LOG.get(n, "") for n in targets}
    phase_done("build", t0)

    # -- shared inputs ----------------------------------------------------
    t0 = time.perf_counter()
    mats = {name: generate(name, scale=1.0) for name in ("cant", "ldoor")}
    A64 = {
        name: sp.csr_matrix(
            (a.data.astype(np.float64), a.indices, a.indptr), shape=a.shape
        )
        for name, a in mats.items()
    }
    xs_host = {
        name: np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
        for name, a in mats.items()
    }
    xs = {name: torch.as_tensor(v, device=dev) for name, v in xs_host.items()}
    abs_csr = {}
    for name, a in mats.items():
        d = csr_prepare(a, dev)
        d["data"] = d["data"].abs()
        abs_csr[name] = d
    for name, a in mats.items():
        print(f"{name}: {a.shape[0]}x{a.shape[1]} nnz={a.nnz}")
    phase_done("inputs", t0)

    def row_scale(name: str, x: torch.Tensor) -> torch.Tensor:
        """(|A| |x|) in float32 on the card."""
        fn = spmv_csr if x.dim() == 1 else spmm_csr
        return fn(abs_csr[name], x.abs(), n_rows=mats[name].shape[0])

    def check(what: str, got, ref, scale) -> float:
        got = torch.as_tensor(got, device=dev).double()
        ref = torch.as_tensor(ref, device=dev).double()
        scale = torch.as_tensor(scale, device=dev).double()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or "
                 "non-finite output")
        err = (got - ref).abs()
        bad = err > TOL * scale
        if bool(bad.any()):
            i = int(torch.argmax((err - TOL * scale).flatten()))
            fail(f"{what}: {int(bad.sum())} entries off, worst at {i}: "
                 f"err {float(err.flatten()[i]):.3e} > "
                 f"{TOL:g} * {float(scale.flatten()[i]):.3e}")
        m = float(err.max()) if err.numel() else 0.0
        print(f"  ok {what}: max_abs_err {m:.3e}")
        return m

    def oracle(name: str, x_host: np.ndarray):
        A = A64[name]
        x64 = x_host.astype(np.float64)
        return A @ x64, abs(A) @ np.abs(x64)

    # -- phase 2: each kernel against its plain version -------------------
    t0 = time.perf_counter()
    errs: dict[str, float] = {}
    preps: dict[str, dict] = {}
    print("phase 2: kernels against their plain versions", flush=True)
    for name in ("ldoor", "cant"):
        a, x = mats[name], xs[name]
        sell = sell_from_csr(a, C=8, sigma=64, width_align=8)
        for ct in (8, 16):
            p = kops.sell_prepare(sell, ct, device=dev)
            y = sell_spmv(p["cols"], p["vals"], x, p["row_perm"],
                          n_rows=a.shape[0], chunk_tile=ct)
            yp = sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"], a.shape[0])
            torch.cuda.synchronize()
            errs[f"sell_spmv/{name}/ct{ct}"] = check(
                f"sell_spmv {name} chunk_tile={ct}", y, yp, row_scale(name, x))
            if ct == 8:
                preps[f"sell/{name}"] = p
            del p, y, yp
        del sell
        torch.cuda.empty_cache()
    for name, smem in (("cant", True), ("ldoor", False)):
        a, x = mats[name], xs[name]
        p = kops.sell_prepare_blocked_stacked(a, 2, device=dev)
        if stages_x_in_smem(p["slab_n"]) != smem:
            fail(f"{name}: slab_n {p['slab_n']} does not take the "
                 f"{'shared' if smem else 'global'}-memory path")
        x_pad = torch.zeros(2 * p["slab_n"], device=dev)
        x_pad[: a.shape[1]] = x
        y = sell_spmv_blocked(p["cols"], p["vals"], x_pad, p["row_perm"],
                              n_rows=a.shape[0], slab_n=p["slab_n"])
        yp = sell_spmv_blocked_plain(p["cols"], p["vals"], x_pad, p["row_perm"],
                                     a.shape[0], p["slab_n"])
        torch.cuda.synchronize()
        path = "smem" if smem else "global"
        errs[f"sell_spmv_blocked/{name}/{path}"] = check(
            f"sell_spmv_blocked {name} n_slabs=2 ({path} x)", y, yp,
            row_scale(name, x))
        preps[f"blocked/{name}"] = dict(p, x_pad=x_pad)
        del y, yp
    cant = mats["cant"]
    m, n = cant.shape
    for block in BCSR_BLOCKS:
        p = kops.bcsr_prepare(bcsr_from_csr(cant, block), dev)
        gm, gn = p["grid_shape"]
        bm, bk = p["block_shape"]
        for k in K_BUCKETS:
            X = torch.as_tensor(
                np.random.default_rng(0).standard_normal((n, k)).astype(np.float32),
                device=dev)
            xb = torch.zeros((gn * bk, k), device=dev)
            xb[:n] = X
            xb = xb.view(gn, bk, k)
            y = bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], xb)
            yp = bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"], xb)
            torch.cuda.synchronize()
            scale = row_scale("cant", X)
            errs[f"bcsr_spmm/{block[0]}x{block[1]}/k{k}"] = check(
                f"bcsr_spmm cant {block} k={k}",
                y.reshape(gm * bm, k)[:m], yp.reshape(gm * bm, k)[:m], scale)
            if block == (8, 8):
                preps[f"bcsr/k{k}"] = dict(p, xb=xb)
            del y, yp
    csr = csr_prepare(cant, dev)
    X16 = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, 16)).astype(np.float32),
        device=dev)
    for what, fn, arg in (("spmv", spmv_csr, xs["cant"]), ("spmm k=16", spmm_csr, X16)):
        if not torch.equal(fn(csr, arg, n_rows=m), fn(csr, arg, n_rows=m)):
            fail(f"csr/vector {what} is not bitwise repeatable on the card")
        print(f"  ok csr/vector {what}: bitwise repeatable")
    torch.cuda.empty_cache()
    phase_done("kernels_vs_plain", t0)

    # -- phase 3 + 4: the main path, launches counted ---------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    print("phase 3: tuned main path", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    cache = PlanCache(Path(tmp.name) / "plans.json")
    record["searches"] = {}

    def report_search(label: str, op) -> None:
        failures = {key: repr(e) for key, e in op.search_failures.items()}
        record["searches"][label] = {
            "plan": op.plan.candidate.key(),
            "measured_ms": {key: round(v * 1e3, 6) for key, v in op.measurements.items()},
            "search_failures": failures,
        }
        print(f"  {label}: plan {op.plan.candidate.key()} "
              f"({op.plan.measured_s * 1e3:.4f} ms), {len(op.measurements)} timed")
        for key, v in sorted(op.measurements.items(), key=lambda kv: kv[1]):
            print(f"    {key}: {v * 1e3:.4f} ms")
        for key, e in op.search_failures.items():
            print(f"    FAILED {key}: {e!r}")
            if not isinstance(e, NoSpMMTier):
                fail(f"{label}: candidate {key} failed in the search: {e!r}")

    op1 = SparseOperator.build(cant, cache=cache, device=dev)
    report_search("cant spmv", op1)
    y64, sc = oracle("cant", xs_host["cant"])
    check("tuned cant spmv vs float64 oracle", op1 @ xs["cant"], y64, sc)
    op16 = SparseOperator.build(cant, k=16, cache=cache, device=dev)
    report_search("cant spmm k=16", op16)
    X16h = X16.cpu().numpy()
    check("tuned cant spmm k=16 vs float64 oracle", op16 @ X16,
          A64["cant"] @ X16h.astype(np.float64),
          abs(A64["cant"]) @ np.abs(X16h.astype(np.float64)))
    ldoor = mats["ldoor"]
    opL = SparseOperator.build(
        ldoor, cache=cache, device=dev,
        candidates=[
            make("csr", "vector"),
            make("sell", "cuda", C=8, sigma=64, chunk_tile=8),
            make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8),
        ],
    )
    report_search("ldoor spmv (cut candidate list)", opL)
    y64, sc = oracle("ldoor", xs_host["ldoor"])
    check("tuned ldoor spmv vs float64 oracle", opL @ xs["ldoor"], y64, sc)
    del opL
    slab_cand = make("sell_blocked", "cuda", C=8, sigma=64, n_slabs=2, chunk_tile=8)
    for name in ("cant", "ldoor"):
        op = SparseOperator.from_candidate(mats[name], slab_cand, device=dev)
        y64, sc = oracle(name, xs_host[name])
        check(f"pinned {slab_cand.key()} on {name} vs float64 oracle",
              op @ xs[name], y64, sc)
        del op
    torch.cuda.empty_cache()
    phase_done("tuned_main_path", t0)

    t0 = time.perf_counter()
    print("phase 4: serving on cant", flush=True)
    rng = np.random.default_rng(0)
    req_host = [rng.standard_normal(n).astype(np.float32) for _ in range(128)]
    req_dev = [torch.as_tensor(v, device=dev) for v in req_host]
    groups = (1, 3, 4, 12, 44)  # -> buckets 1, 4, 4, 16, 64

    def serve(eng, xs_):
        reqs, i = [], 0
        for g in groups:
            reqs += [eng.submit(x) for x in xs_[i : i + g]]
            i += g
            eng.step()
        eng.drain()
        return [r.result() for r in reqs]

    def check_served(label, ys, hosts):
        X = np.stack(hosts, axis=1).astype(np.float64)
        Y = torch.stack(list(ys), dim=1)
        return check(label, Y, A64["cant"] @ X, abs(A64["cant"]) @ np.abs(X))

    eng = SparseEngine(cant, ks=K_BUCKETS, cache=cache, device=dev)
    plans = {k: op.plan.candidate.key() for k, op in eng.ops.items()}
    print(f"  tuned engine plans: {plans}")
    record["engine_plans"] = plans
    check_served("tuned engine, 64 requests vs float64 oracle",
                 serve(eng, req_dev[:64]), req_host[:64])
    print(f"  tuned engine stats: {eng.stats.summary()}")
    pinned = {
        k: SparseOperator.from_candidate(
            cant,
            make("sell", "cuda", C=8, sigma=64, chunk_tile=8) if k == 1
            else make("bcsr", "cuda", block=(8, 8)),
            k=None if k == 1 else k, device=dev,
        )
        for k in K_BUCKETS
    }
    eng_async = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                             async_depth=2)
    ys_async = serve(eng_async, req_dev[64:])
    eng_sync = SparseEngine(cant, ks=K_BUCKETS, ops=pinned, device=dev,
                            async_depth=0)
    ys_sync = serve(eng_sync, req_dev[64:])
    if not all(torch.equal(a_, b_) for a_, b_ in zip(ys_async, ys_sync)):
        fail("pinned engine: async results differ from async_depth=0 results")
    print("  ok pinned engine: async == sync bit for bit")
    check_served("pinned engine, 64 requests vs float64 oracle", ys_async,
                 req_host[64:])
    by_bucket = eng_async.stats.summary()["by_bucket"]
    if sorted(by_bucket) != list(K_BUCKETS):
        fail(f"pinned engine did not serve every bucket: {by_bucket}")
    for eng_ in (eng, eng_async, eng_sync):
        eng_.close()
    # The serve CLI, on the plan table the tuned engine left in the cache.
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp.name) / "plans.json")
    serve_stats = Path(tmp.name) / "serve.json"
    serve_cli.main(["--sparse", "cant", "--scale", "1.0", "--requests", "64",
                "--stats-json", str(serve_stats)])
    record["serve_cli"] = json.loads(serve_stats.read_text())
    if record["serve_cli"]["served"] != 64:
        fail(f"serve CLI served {record['serve_cli']['served']}/64 requests")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"  launches over phases 3-4: {launches}")
    for key in ("sell_spmv", "sell_spmv_blocked", "sell_spmv_blocked.smem",
                "sell_spmv_blocked.global", "bcsr_spmm"):
        if launches.get(key, 0) <= 0:
            fail(f"kernel {key} was never launched on the main path")
    record["launches"] = launches
    tmp.cleanup()
    phase_done("serving", t0)

    # -- phase 5: times ----------------------------------------------------
    t0 = time.perf_counter()
    print("phase 5: times (median of 25, L2 flushed before each)", flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(REPS):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))

    def csr_lib(name: str):
        a = mats[name]
        return torch.sparse_csr_tensor(
            torch.as_tensor(a.indptr, device=dev),
            torch.as_tensor(a.indices, device=dev),
            torch.as_tensor(a.data, device=dev), size=a.shape,
            check_invariants=False)

    def nbytes(*ts) -> int:
        return int(sum(t.numel() * t.element_size() for t in ts))

    def bound(a, k: int) -> tuple[int, int]:
        """Bytes and flops that Y = A X needs, whatever the format: A as CSR
        (a value and a column index per nonzero, m + 1 row pointers), X
        read once, Y written once; 2 flops per nonzero and column of X."""
        m_, n_ = a.shape
        return 8 * a.nnz + 4 * (m_ + 1) + 4 * (n_ + m_) * k, 2 * a.nnz * k

    kernels = []

    def entry(name, source, replaces, launch_key, err_key, shape, kernel, plain,
              library, a, k, stored_bytes):
        fn_bytes, flops = bound(a, k)
        bytes_s = fn_bytes / HBM_BYTES_PER_S
        flops_s = flops / FP32_FLOPS
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "shape": shape,
            "launches": int(launches.get(launch_key, 0)),
            "max_abs_err": errs[err_key],
            "ms": time_ms(kernel),
            "plain_ms": time_ms(plain),
            "bound_ms": max(bytes_s, flops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= flops_s else "operations",
            "bytes": int(fn_bytes),
            "flops": int(flops),
            "stored_bytes": int(stored_bytes),
            "library_ms": time_ms(library),
        }
        kernels.append(row)
        print(f"  {name} [{shape}]: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
              f"cuSPARSE {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB needed, "
              f"{row['stored_bytes'] / 1e6:.1f} MB stored), "
              f"launches {row['launches']}", flush=True)

    for name in ("cant", "ldoor"):
        p, x, a = preps[f"sell/{name}"], xs[name], mats[name]
        A = csr_lib(name)
        entry("sell_spmv", "src/repro_torch/kernels/csrc/sell_spmv.cu",
              "src/repro/kernels/sell_spmv.py:53", "sell_spmv",
              f"sell_spmv/{name}/ct8",
              f"{name} SELL-8-64 W={p['cols'].shape[2]} chunk_tile=8",
              lambda: sell_spmv(p["cols"], p["vals"], x, p["row_perm"],
                                n_rows=a.shape[0], chunk_tile=8),
              lambda: sell_spmv_plain(p["cols"], p["vals"], x, p["row_perm"],
                                      a.shape[0]),
              lambda: torch.mv(A, x), a, 1,
              nbytes(p["cols"], p["vals"], p["row_perm"], x) + 4 * a.shape[0])
        del A
    for name, path in (("cant", "smem"), ("ldoor", "global")):
        p, a = preps[f"blocked/{name}"], mats[name]
        A = csr_lib(name)
        x = xs[name]
        entry("sell_spmv_blocked", "src/repro_torch/kernels/csrc/sell_spmv_blocked.cu",
              "src/repro/kernels/sell_spmv.py:98", "sell_spmv_blocked",
              f"sell_spmv_blocked/{name}/{path}",
              f"{name} 2 slabs W={p['cols'].shape[3]} ({path} x)",
              lambda: sell_spmv_blocked(p["cols"], p["vals"], p["x_pad"],
                                        p["row_perm"], n_rows=a.shape[0],
                                        slab_n=p["slab_n"]),
              lambda: sell_spmv_blocked_plain(p["cols"], p["vals"], p["x_pad"],
                                              p["row_perm"], a.shape[0],
                                              p["slab_n"]),
              lambda: torch.mv(A, x), a, 1,
              nbytes(p["cols"], p["vals"], p["row_perm"], p["x_pad"])
              + 4 * a.shape[0])
        del A
    A = csr_lib("cant")
    for k in K_BUCKETS:
        p = preps[f"bcsr/k{k}"]
        Xk = p["xb"].reshape(-1, k)[:n].contiguous()
        entry("bcsr_spmm", "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
              "src/repro/kernels/bcsr_spmm.py:56", "bcsr_spmm",
              f"bcsr_spmm/8x8/k{k}", f"cant 8x8 blocks k={k}",
              lambda: bcsr_spmm(p["blocks"], p["block_cols"], p["indptr"], p["xb"]),
              lambda: bcsr_spmm_plain(p["blocks"], p["block_cols"], p["indptr"],
                                      p["xb"]),
              (lambda: torch.mv(A, Xk[:, 0])) if k == 1 else (lambda: A @ Xk),
              cant, k,
              nbytes(p["blocks"], p["block_cols"], p["indptr"], p["xb"])
              + 4 * p["grid_shape"][0] * p["block_shape"][0] * k)
    del A, preps
    torch.cuda.empty_cache()
    phase_done("times", t0)

    # -- phase 6: sparse right-hand sides (SpMSpV) --------------------------
    t0 = time.perf_counter()
    print("phase 6: sparse right-hand sides on webbase-1M and torso1", flush=True)
    graphs = {name: generate(name, scale=1.0) for name in ("webbase-1M", "torso1")}
    G64, G_abs, G_pat = {}, {}, {}
    for name, g in graphs.items():
        G64[name] = sp.csr_matrix((g.data.astype(np.float64), g.indices, g.indptr),
                                  shape=g.shape)
        G_abs[name] = abs(G64[name])
        G_pat[name] = sp.csr_matrix((np.ones(g.nnz), g.indices, g.indptr),
                                    shape=g.shape)
        print(f"{name}: {g.shape[0]}x{g.shape[1]} nnz={g.nnz}, longest row "
              f"{int(np.diff(g.indptr).max())}, longest column "
              f"{int(np.bincount(g.indices).max())}")
    web = graphs["webbase-1M"]
    m_w, n_w = web.shape
    buckets = (n_w // 256, n_w // 64, n_w // 16, n_w // 4)  # the engine's
    sp_limits = record["spmspv_limits"] = {}

    def sparse_x(n_: int, nx: int, seed: int = 0):
        rng_ = np.random.default_rng(seed)
        idx = np.sort(rng_.choice(n_, size=nx, replace=False)).astype(np.int64)
        return idx, rng_.standard_normal(nx).astype(np.float32)

    def sparse_oracle(name: str, idx, val):
        """(y64, (|A| |x|), k_i = the touched terms of each row)."""
        x64 = np.zeros(graphs[name].shape[1])
        x64[idx] = val
        mask = np.zeros_like(x64)
        mask[idx] = 1.0
        return G64[name] @ x64, G_abs[name] @ np.abs(x64), G_pat[name] @ mask

    def check_sparse(what: str, got, ref, scale, terms, quiet=False) -> float:
        """Per row |got - ref| <= 1e-5 * scale_i; a row that breaks it is
        printed with its term count k_i and held to k_i * 2**-24 * scale_i."""
        got = torch.as_tensor(got, device=dev).double()
        ref = torch.as_tensor(ref, device=dev).double()
        scale = torch.as_tensor(scale, device=dev).double()
        terms = torch.as_tensor(terms, device=dev).double()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or "
                 "non-finite output")
        err = (got - ref).abs()
        lim = TOL * scale
        used = "1e-5"
        if bool((err > lim).any()):
            i = int(torch.argmax(err - lim))
            print(f"  {what}: {int((err > lim).sum())} rows break 1e-5, worst row "
                  f"{i}: err {float(err[i]):.3e}, (|A||x|)_i {float(scale[i]):.3e}, "
                  f"k_i = {int(terms[i])} terms; limit becomes k_i * 2^-24")
            lim = torch.clamp(terms * 2.0**-24, min=TOL) * scale
            used = "k_i*2^-24"
            if bool((err > lim).any()):
                j = int(torch.argmax(err - lim))
                fail(f"{what}: row {j} err {float(err[j]):.3e} > k_i * 2^-24 * "
                     f"{float(scale[j]):.3e} with k_i = {int(terms[j])}")
        sp_limits[what] = used
        worst = float(err.max()) if err.numel() else 0.0
        if not quiet:
            print(f"  ok {what}: max_abs_err {worst:.3e} (limit {used})")
        return worst

    # 6a: the scatter kernel against its plain version on the card
    sp_prep_web = None
    for name, g in graphs.items():
        m_, n_ = g.shape
        prep = spmspv_prepare(g, device=dev)
        for B in buckets if name == "webbase-1M" else (n_ // 256, n_ // 4):
            idx, val = sparse_x(n_, B)
            xi, xv = pad_sparse_rhs(idx, val, B, n_)
            T = int(prep["col_len_np"][xi].sum())
            G = work_bucket(T, g.nnz)
            rows, prods = expand_products(prep, torch.as_tensor(xi, device=dev),
                                          torch.as_tensor(xv, device=dev), G)
            y = spmspv_scatter(rows, prods, m=m_, total=T)
            yp = spmspv_scatter_plain(rows, prods, m_, T)
            torch.cuda.synchronize()
            _, scale, _ = sparse_oracle(name, idx, val)
            terms = torch.bincount(rows[:T].long(), minlength=m_)
            errs[f"spmspv_scatter/{name}/B{B}"] = check_sparse(
                f"spmspv_scatter {name} x_nnz={B} (T={T}, G={G}, max k_i "
                f"{int(terms.max())})", y, yp, scale, terms)
            del rows, prods, y, yp
        if name == "webbase-1M":
            sp_prep_web = prep
        del prep
    torch.cuda.empty_cache()
    phase_done("spmspv_kernel_vs_plain", t0)

    # 6b: the sparse-RHS main path on webbase-1M, launches counted
    _build.reset_launches()
    t0 = time.perf_counter()
    print("phase 6b: sparse-RHS main path on webbase-1M", flush=True)
    sp_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sp_")
    sp_cache = PlanCache(Path(sp_tmp.name) / "plans.json")
    pinned_sp = make("spmspv", "cuda", slab=4096)
    lap_t[0] = time.perf_counter()
    for B in buckets:
        op = SparseOperator.build(web, x_nnz=B, cache=sp_cache, device=dev)
        lap(f"build x_nnz={B}")
        report_search(f"webbase-1M spmspv x_nnz={B}", op)
        idx, val = sparse_x(n_w, B, seed=1)
        y64, scale, terms = sparse_oracle("webbase-1M", idx, val)
        y = op.apply_sparse(idx, val)
        check_sparse(f"tuned x_nnz={B} apply_sparse vs float64 oracle", y, y64,
                     scale, terms)
        check_sparse(f"tuned x_nnz={B} op @ (idx, val) vs apply_sparse",
                     op @ (idx, val), y, scale, terms)
        pin = SparseOperator.from_candidate(web, pinned_sp, x_nnz=B, device=dev)
        check_sparse(f"pinned {pinned_sp.key()} x_nnz={B} vs float64 oracle",
                     pin.apply_sparse(idx, val), y64, scale, terms)
        del op, pin
        lap(f"checks x_nnz={B}")
    # 64 requests spread over the four buckets, then one thicker than n/4
    rng = np.random.default_rng(2)
    lows = (0,) + buckets[:-1]
    sizes = [int(rng.integers(lo + 1, hi + 1)) for lo, hi in zip(lows, buckets)
             for _ in range(16)]
    rng.shuffle(sizes)
    sizes.append(buckets[-1] + 1000)
    sp_reqs = [sparse_x(n_w, s_, seed=100 + j) for j, s_ in enumerate(sizes)]
    sp_oracles = [sparse_oracle("webbase-1M", i_, v_) for i_, v_ in sp_reqs]
    lap("65 requests and their oracles")

    def check_answers(label: str, ys) -> float:
        worst = max(check_sparse(f"{label} request {j}", y_, o[0], o[1], o[2],
                                 quiet=True)
                    for j, (y_, o) in enumerate(zip(ys, sp_oracles)))
        print(f"  ok {label}: {len(ys)} answers vs float64 oracle, max_abs_err "
              f"{worst:.3e}")
        return worst

    eng_sp = SparseEngine(web, ks=(1,), cache=sp_cache, device=dev)
    lap("tuned engine built")
    futs = []
    for i_, v_ in sp_reqs:  # one at a time: each latency is one request's
        futs.append(eng_sp.submit_sparse(i_, v_))
        futs[-1].result()
    lap("tuned engine served")
    check_answers("tuned engine", [f.result() for f in futs])
    lap("tuned engine checked")
    summary = eng_sp.stats.summary()
    lat_by_bucket = {}
    for f in futs:
        key = f"spmspv{f.bucket[1]}" if isinstance(f.bucket, tuple) else f"dense k={f.bucket}"
        lat_by_bucket.setdefault(key, []).append(f.latency_s * 1e3)
    lat_by_bucket = {key: round(float(np.median(v)), 4)
                     for key, v in lat_by_bucket.items()}
    sparse_plans = {B: op.plan.candidate.key() for B, op in eng_sp._sparse_ops.items()}
    print(f"  tuned engine sparse plans: {sparse_plans}")
    print(f"  tuned engine stats: {summary}")
    print(f"  tuned engine median latency by lane (ms): {lat_by_bucket}")
    record["spmspv_engine"] = {"plans": sparse_plans, "stats": summary,
                               "median_latency_ms": lat_by_bucket}
    if sorted(summary["sparse_by_bucket"]) != sorted(f"spmspv{B}" for B in buckets):
        fail(f"tuned engine did not serve every x-nnz bucket: "
             f"{summary['sparse_by_bucket']}")
    if summary["by_bucket"] != {1: 1}:
        fail(f"the oversize request did not take the dense k=1 lane: "
             f"{summary['by_bucket']}")
    ys_by_depth = {}
    pin_cache = PlanCache()  # the second engine loads the first one's plans
    for depth in (2, 0):
        eng_ = SparseEngine(web, ks=(1,), ops={1: eng_sp.ops[1]}, cache=pin_cache,
                            device=dev, async_depth=depth, candidates=[pinned_sp])
        lap(f"pinned engine async_depth={depth} built")
        futs_ = [eng_.submit_sparse(i_, v_) for i_, v_ in sp_reqs]
        eng_.drain()
        ys_by_depth[depth] = [f.result() for f in futs_]
        lap(f"pinned engine async_depth={depth} served")
        lanes = {op.plan.candidate for op in eng_._sparse_ops.values()}
        if lanes != {pinned_sp}:
            fail(f"pinned engine's sparse lane ran {lanes}")
        check_answers(f"pinned engine async_depth={depth}", ys_by_depth[depth])
        eng_.close()
    for j, (ya, ys_) in enumerate(zip(ys_by_depth[2], ys_by_depth[0])):
        o = sp_oracles[j]
        check_sparse(f"pinned engine request {j}: async vs sync", ya, ys_, o[1],
                     o[2], quiet=True)
    print("  ok pinned engine: async_depth=2 agrees with async_depth=0 within "
          "the tolerance (the scatter's atomics make it not bitwise)")
    lap("pinned engines checked")
    eng_sp.close()
    torch.cuda.synchronize()
    sp_launches = dict(_build.LAUNCHES)
    print(f"  launches over phase 6b: {sp_launches}")
    if sp_launches.get("spmspv_scatter", 0) <= 0:
        fail("kernel spmspv_scatter was never launched on the sparse-RHS main path")
    record["spmspv_launches"] = sp_launches
    sp_tmp.cleanup()
    torch.cuda.empty_cache()
    phase_done("spmspv_main_path", t0)

    # 6c: times at the four webbase buckets
    t0 = time.perf_counter()
    print("phase 6c: spmspv times on webbase-1M (median of 25, L2 flushed)",
          flush=True)

    def wall_ms(fn) -> float:
        """Host clock around fn() and a synchronise: a whole request."""
        for _ in range(3):
            fn()
        ts = []
        for _ in range(REPS):
            flush.zero_()
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t_) * 1e3)
        return float(np.median(ts))

    A_web = torch.sparse_csr_tensor(
        torch.as_tensor(web.indptr, device=dev), torch.as_tensor(web.indices, device=dev),
        torch.as_tensor(web.data, device=dev), size=web.shape, check_invariants=False)
    for B in buckets:
        idx, val = sparse_x(n_w, B)
        xi, xv = pad_sparse_rhs(idx, val, B, n_w)
        T = int(sp_prep_web["col_len_np"][xi].sum())
        G = work_bucket(T, web.nnz)
        xi_d = torch.as_tensor(xi, device=dev)
        xv_d = torch.as_tensor(xv, device=dev)
        rows, prods = expand_products(sp_prep_web, xi_d, xv_d, G)
        x_dense = torch.zeros(n_w, device=dev)
        x_dense[torch.as_tensor(idx, device=dev)] = torch.as_tensor(val, device=dev)
        pin = SparseOperator.from_candidate(web, pinned_sp, x_nnz=B, device=dev)
        fn_bytes, ops_ = 8 * T + 4 * m_w, T
        bytes_s, ops_s = fn_bytes / HBM_BYTES_PER_S, ops_ / FP32_FLOPS
        row = {
            "name": "spmspv_scatter",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spmspv_scatter.cu",
            "replaces": "src/repro/kernels/spmspv.py:212",
            "shape": f"webbase-1M x_nnz={B} T={T} G={G}",
            "launches": int(sp_launches.get("spmspv_scatter", 0)),
            "max_abs_err": errs[f"spmspv_scatter/webbase-1M/B{B}"],
            "ms": time_ms(lambda: spmspv_scatter(rows, prods, m=m_w, total=T)),
            "plain_ms": time_ms(lambda: spmspv_scatter_plain(rows, prods, m_w, T)),
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes": int(fn_bytes),
            "flops": int(ops_),
            "library_ms": time_ms(lambda: torch.zeros(m_w, device=dev).index_add_(
                0, rows[:T], prods[:T])),
            "x_nnz": B,
            "T": T,
            "G": G,
            "padded_share_G_over_T": G / T if T else None,
            "expand_ms": time_ms(lambda: expand_products(sp_prep_web, xi_d, xv_d, G)),
            "zero_fill_ms": time_ms(lambda: torch.zeros(m_w, device=dev)),
            "apply_sparse_ms": wall_ms(lambda: pin.apply_sparse(idx, val)),
            "cusparse_dense_mv_ms": time_ms(lambda: torch.mv(A_web, x_dense)),
        }
        kernels.append(row)
        print(f"  spmspv_scatter [{row['shape']}]: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, index_add_ {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}), G/T "
              f"{row['padded_share_G_over_T']:.2f}, expand {row['expand_ms']:.4f}, "
              f"zero fill {row['zero_fill_ms']:.4f}; whole apply_sparse "
              f"{row['apply_sparse_ms']:.4f} ms vs cuSPARSE mv on the densified x "
              f"{row['cusparse_dense_mv_ms']:.4f} ms; launches {row['launches']}",
              flush=True)
        del rows, prods, pin
    phase_done("spmspv_times", t0)

    record["kernels"] = kernels
    record["card"] = smi
    record["total_s"] = round(time.perf_counter() - t_start, 3)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1) + "\n")
    print(f"total {record['total_s']:.1f}s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()

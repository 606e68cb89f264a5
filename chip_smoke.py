#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
scipy; imports nothing of JAX or of the JAX package.  Phases:

1. print the card's name and power limit; build the three kernels from
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
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
   function itself (see ``bound``), whatever format the kernel stores.

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

    # -- phase 1: card and build ------------------------------------------
    t0 = time.perf_counter()
    smi = smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
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
    phase_done("times", t0)

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

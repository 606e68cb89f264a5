"""One run of one cell: set-up, the measured window, the check.

The window drives the program's ``SparseEngine`` through its public API
(``submit``, ``step``, ``EngineRequest.result``, ``drain``) from one loop,
which submits each request once it is due (at once, in a closed loop)
while fewer than the mix's ``outstanding`` are in the engine, and
dispatches whatever is queued.

When the engine's in-flight window is full, the loop waits for the oldest
batch through its oldest request's ``result()`` before it calls ``step()``,
so a ``step()`` span times the dispatch and not the wait.  Every request is
timed from when it was due (an open loop) and counted as completed when
it retired inside the window.  The retired answers are sampled by batch
width and by slot within the batch, reservoir-style from the seed, so
every slot of every width that served is judged, after the window,
against the configuration's plain reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from . import data, spec, trace as trace_mod
from .bound import batch_bound_s
from .traffic import WARM_ROUNDS, Schedule, schedule

SAMPLES_PER_WIDTH = 64
DRAIN_GRACE_S = 60.0  # after the window, a due request may take this long more


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What the metric readers read (``bench/metrics/<name>.py``)."""

    setup_s: float
    build_s: float
    window_s: float
    completed: int  # requests retired inside the window
    latencies_ms: list  # open loop: every request due in the window, inf if failed
    step_host_s: list  # every step() that dispatched, in the window but
    # outside the traced stretch (where the harness's host spans are on)
    dispatches: int  # engine counters over the window
    occupied_cols: int
    trace: dict | None  # the traced stretch (trace.reduce), with bound_s
    submitted: int = 0
    backlog: tuple = (None, None)  # requests unanswered after 1 s and at the end


class Reservoir:
    """A sample, drawn from the seed, of one batch width's answers,
    stratified by slot within the batch: ``max(1, size // width)`` answers
    of each slot, each a uniform sample of that slot's answers, copied out
    of its batch on the device with the pool index of its x."""

    def __init__(self, size: int, m: int, device, seed: int, width: int):
        self.width, self.per_slot = width, max(1, size // width)
        cap = width * self.per_slot
        self.Y = torch.empty((cap, m), dtype=torch.float32, device=device)
        self.pool_idx = np.full(cap, -1, dtype=np.int64)
        self.seen_slot = np.zeros(width, dtype=np.int64)
        self.rng = np.random.default_rng([seed, 2, width])

    @property
    def seen(self) -> int:
        return int(self.seen_slot.sum())

    def offer(self, y: torch.Tensor, pool_idx: int, slot: int) -> None:
        slot %= self.width
        seen, size = int(self.seen_slot[slot]), self.per_slot
        j = seen if seen < size else int(self.rng.integers(0, seen + 1))
        self.seen_slot[slot] += 1
        if j < size:
            self.Y[slot * size + j].copy_(y)
            self.pool_idx[slot * size + j] = pool_idx

    def kept(self) -> tuple[torch.Tensor, np.ndarray]:
        rows = np.flatnonzero(self.pool_idx >= 0)
        return self.Y[torch.as_tensor(rows, device=self.Y.device)], self.pool_idx[rows]

    def slots(self) -> int:
        """Slots with at least one answer kept."""
        return int(np.count_nonzero(self.seen_slot))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (an infinity stays one)."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One process's run of a cell: the set-up (matrix, values, x pool,
    engine, warm-up), one or more measured windows, then the check."""

    def __init__(self, cell: spec.Cell, seed: int, device, t_start: float, *,
                 scale: float | None = None, cache: Path | None = None,
                 samples: int = SAMPLES_PER_WIDTH, warm: tuple[int, ...] = ()):
        from repro_torch.core.formats import CSRMatrix
        from repro_torch.runtime.engine import SparseEngine

        self.cell, self.t_start = cell, t_start
        self.device = device = torch.device(device)
        self.seed = seed = int(seed) % 2**63
        config = cell.config
        ts = time.perf_counter()
        self.generated = not data.structure_path(cell.root, config, scale, cache).exists()
        n, indptr, indices = data.structure(cell.root, config, scale, cache=cache)
        self.n, self.nnz = n, int(indices.shape[0])
        t_struct = time.perf_counter() - ts
        values, self.X = data.draw(seed, self.nnz, n, int(cell.traffic["pool"]), device)
        self.ref_arrays = (torch.as_tensor(indptr, device=device),
                           torch.as_tensor(indices, device=device), values)
        a = CSRMatrix((n, n), indptr.copy(), indices.copy(), values.cpu().numpy())
        log(f"{config['name']}: {n} rows, {self.nnz} stored values; structure "
            f"{t_struct:.3f} s, values and x pool {time.perf_counter() - ts - t_struct:.3f}"
            f" s; {time.perf_counter() - t_start:.3f} s since start")

        t0 = time.perf_counter()
        self.eng = eng = SparseEngine(a, device=device)
        for width in warm:
            for _ in range(WARM_ROUNDS):
                for i in range(width):
                    eng.submit(self.X[i % self.X.shape[0]])
                eng.drain()
        _sync(device)
        self.build_s = time.perf_counter() - t0
        self.plans = {str(k): str(op.plan.candidate.key()) for k, op in eng.ops.items()}
        self.searched = not eng.from_cache
        log(f"plans: {self.plans}, from cache: {eng.from_cache}; engine built and "
            f"warmed in {self.build_s:.3f} s")
        if device.type == "cuda":
            log(f"card: {torch.cuda.get_device_name(device)}")
        self.res = {w: Reservoir(samples, n, device, seed, w) for w in eng.ks}
        self.failed = 0
        self.unanswered = 0

    def window(self, sched: Schedule, seconds: float, trace: bool) -> Context:
        """Measure ``seconds`` of ``sched``'s traffic; every request it
        offered is answered (or failed) when this returns."""
        eng, X, device = self.eng, self.X, self.device
        window = max(1, eng.async_depth)
        outstanding: deque = deque()  # (request, index, due), submit order
        lat_ms: list = []
        late_s: list = []
        stretch_b: list = []
        counts = {"submitted": 0, "completed": 0, "failed": 0}
        tracing = {"on": False}
        spans = contextlib.nullcontext()
        prof = None
        timed = sched.timed
        due_s = sched.due_s
        n_due = due_s.shape[0] if timed else math.inf
        cap = sched.outstanding
        res = self.res
        # The slot of a retired answer within its batch: answers of one
        # batch are views of one output and retire in a row.  The last
        # answer's view is held, so a later batch's output, allocated
        # before that batch's first answer retires, never takes its address.
        last = {"ptr": None, "slot": -1, "y": None}

        def span(name: str):
            if tracing["on"]:
                return torch.profiler.record_function("bench." + name)
            return spans

        def submit(i: int, due: float) -> None:
            outstanding.append((eng.submit(X[sched.pool_index(i)]), i, due))
            counts["submitted"] += 1

        def collect(t_lo: float, t_hi: float) -> None:
            while outstanding and outstanding[0][0].done:
                req, i, due = outstanding.popleft()
                in_window = due < t_hi
                if req.failed:
                    counts["failed"] += 1
                    if timed and in_window:
                        lat_ms.append(math.inf)
                    continue
                if t_lo <= req.t_done <= t_hi:
                    counts["completed"] += 1
                if timed and in_window:
                    lat_ms.append((req.t_done - due) * 1e3)
                    late_s.append(req.t_submit - due)
                y = req.y
                ptr = y.untyped_storage().data_ptr()
                slot = last["slot"] + 1 if ptr == last["ptr"] else 0
                last.update(ptr=ptr, slot=slot, y=y)
                res[req.bucket].offer(y, sched.pool_index(i), slot)

        def wait_oldest() -> None:
            try:
                outstanding[0][0].result()
            except Exception:  # a failed batch: counted where it is collected
                pass

        def dispatch() -> None:
            ts = time.perf_counter()
            with span("step"):
                b = eng.step()
            if b:
                phase[trace_state].append(time.perf_counter() - ts)
                if tracing["on"]:
                    stretch_b.append(b)

        def backlog(now: float) -> int:
            due_left = int(np.searchsorted(due_s, now - w0, "right")) - i if timed else 0
            return len(outstanding) - sum(1 for r in outstanding if r[0].done) + due_left

        stretch = 0.5 * seconds
        tr_lo = 0.5 * (seconds - stretch)

        def end_stretch() -> None:
            _sync(device)
            mark.__exit__(None, None, None)
            tracing["on"] = False

        disp0, occ0 = eng.stats.n_dispatches, eng.stats.occupied_cols
        # What set-up left is frozen out of the collector's sweeps, as a
        # serving process does after start-up; the window's own objects
        # are still collected, and every pause is logged.
        gc.collect()
        gc.freeze()
        pauses = _GcPauses()
        gc.callbacks.append(pauses)
        setup_s = time.perf_counter() - self.t_start
        if trace:
            # The profiler records the whole window: its start (seconds on a
            # card) and its stop stay outside it.  The stretch it is read
            # over is the window's middle half, between two markers.
            prof = torch.profiler.profile(activities=_activities(device))
            ts = time.perf_counter()
            prof.start()
            log(f"profiler started in {time.perf_counter() - ts:.3f} s")
        w0 = time.perf_counter()
        w1 = w0 + seconds
        i = 0
        trace_state = 0  # 0 before the stretch, 1 in it, 2 after
        mark = None
        tr_end = w1
        backlog_1s = None
        phase = ([], [], [])  # step() host seconds before, in and after the stretch
        while True:
            now = time.perf_counter()
            if now >= w1:
                break
            if backlog_1s is None and now - w0 >= 1.0:
                backlog_1s = backlog(now)
            if trace and trace_state == 0 and now - w0 >= tr_lo:
                _sync(device)
                tracing["on"] = True
                mark = torch.profiler.record_function("bench.stretch")
                mark.__enter__()
                trace_state = 1
                tr_end = min(time.perf_counter() + stretch, w1)
            elif trace_state == 1 and now >= tr_end:
                end_stretch()
                trace_state = 2
            with span("submit"):
                while (i < n_due and len(outstanding) < cap
                       and (not timed or w0 + due_s[i] <= now)):
                    submit(i, w0 + due_s[i] if timed else now)
                    i += 1
            if eng.pending:
                if eng.in_flight >= window:
                    with span("wait"):
                        wait_oldest()
                dispatch()
            elif eng.in_flight:
                with span("poll"):
                    eng.step()
            elif timed and len(outstanding) < cap:
                nxt = w0 + due_s[i] if i < n_due else w1
                with span("generator"):
                    while time.perf_counter() < min(nxt, w1):
                        pass
            with span("retire"):
                collect(w0, w1)
        window_s = time.perf_counter() - w0
        gc.callbacks.remove(pauses)
        backlog_end = backlog(w0 + window_s)
        if trace_state == 1:  # a window shorter than the loop's last turn
            end_stretch()
            trace_state = 2
        disp1, occ1 = eng.stats.n_dispatches, eng.stats.occupied_cols
        if timed:  # requests due in the window that the loop had not reached
            while i < n_due:
                submit(i, w0 + due_s[i])
                i += 1
        # Serve what is left batch by batch, dropping each retired batch
        # as its answers are read: a backlog retired at once would hold
        # every batch's output on the card together.
        deadline = w0 + window_s + DRAIN_GRACE_S
        while outstanding and time.perf_counter() < deadline:
            if eng.pending and eng.in_flight < window:
                eng.step(force=True)
            else:
                wait_oldest()
            collect(w0, w1)
        self.unanswered += len(outstanding)
        self.failed += counts["failed"]
        gc.unfreeze()
        if prof is not None:  # stopped once every request has its answer
            ts = time.perf_counter()
            prof.stop()
            log(f"profiler stopped in {time.perf_counter() - ts:.3f} s")
        log(f"window {window_s:.3f} s: {counts}, backlog after 1 s {backlog_1s}, at the "
            f"end {backlog_end}; offered {counts['submitted'] / window_s:.1f} req/s; "
            f"garbage collections by generation {pauses.count}, longest "
            f"{pauses.longest * 1e3:.3f} ms")
        if late_s:
            log(f"generator lateness (submit - due) over {len(late_s)} requests: "
                f"p50 {percentile(late_s, 50) * 1e3:.4f} ms, p99 "
                f"{percentile(late_s, 99) * 1e3:.4f} ms, max {max(late_s) * 1e3:.4f} ms")
        traced = None
        if trace:
            log("step() host us before / in / after the traced stretch: " + " / ".join(
                f"{1e6 * sum(p) / len(p):.1f} ({len(p)})" if p else "-" for p in phase))
        if trace_state == 2:
            traced = _reduce(prof)
            traced["bound_s"] = sum(batch_bound_s(self.nnz, self.n, self.n, b)
                                    for b in stretch_b)
            traced["batches"] = len(stretch_b)
        return Context(setup_s=setup_s, build_s=self.build_s,
                       window_s=window_s, completed=counts["completed"],
                       latencies_ms=lat_ms, step_host_s=phase[0] + phase[2],
                       dispatches=disp1 - disp0, occupied_cols=occ1 - occ0,
                       trace=traced, submitted=counts["submitted"],
                       backlog=(backlog_1s, backlog_end))

    def check(self) -> tuple[dict, int]:
        """Free the program's state, then judge every kept answer against
        the configuration's reference; returns ``(checks, peak bytes)``."""
        eng, device = self.eng, self.device
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        log("engine over the run: " + str({k: v for k, v in eng.stats.summary().items()
                                           if not k.startswith("latency")}))
        eng.close(drain=False)  # anything still unanswered has been counted
        kept = {w: r.kept() for w, r in self.res.items() if r.seen}
        slots = {w: (r.slots(), r.width) for w, r in self.res.items() if r.seen}
        del self.eng, self.res, eng
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = spec.reference(self.cell.root, self.cell.config["reference"])
        errs = {}
        for w, (Y, idx) in kept.items():
            Xs = self.X[torch.as_tensor(idx, device=device)].T.contiguous()
            Y64, AX = ref.reference(*self.ref_arrays, Xs)
            errs[w] = ref.rel_err(Y.T, Y64, AX)
            del Y64, AX, Xs
        log(f"worst relative error by batch width (answers kept, slots of the width "
            f"kept): { {w: (errs[w], int(kept[w][1].shape[0]), slots[w]) for w in errs} }")
        err = max(errs.values()) if errs else math.inf
        return {
            "rel_err": {"value": err, "limit": ref.MAX_REL_ERR},
            "unanswered": {"value": self.unanswered, "limit": 0},
            "failed": {"value": self.failed, "limit": 0},
        }, int(peak)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, scale: float | None = None, cache: Path | None = None,
        samples: int = SAMPLES_PER_WIDTH) -> dict:
    """Run ``cell`` once: set-up, one window of ``seconds``, the check."""
    from repro_torch.kernels import _build

    sched = schedule(cell.traffic, int(seed) % 2**63, seconds)
    r = Run(cell, seed, device, t_start, scale=scale, cache=cache, samples=samples,
            warm=sched.warm)
    ctx = r.window(sched, seconds, trace)
    if trace:
        log(f"kernel launches over the run: {dict(_build.LAUNCHES)}")
    checks, peak = r.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"ctx": ctx, "correct": bool(correct), "attempted": ctx.submitted,
            "failed": r.failed + r.unanswered, "memory_peak_bytes": peak,
            "cold": {"structure_generated": r.generated, "plans_searched": r.searched},
            "plans": r.plans, "checks": checks}


class _GcPauses:
    """A ``gc.callbacks`` entry: collections by generation, longest pause."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.longest = 0.0
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.longest = max(self.longest, time.perf_counter() - self._t)


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _reduce(prof) -> dict:
    """The stretch's device operations and harness spans, from the
    profiler's raw events."""
    events = prof.profiler.kineto_results.events()
    lo = hi = None
    device, spans = [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith("bench."):  # a host span's mirror on the device's row
                device.append((name, e.start_ns(), e.end_ns()))
        elif name == "bench.stretch":
            lo, hi = e.start_ns(), e.end_ns()
        elif name.startswith("bench."):
            spans.append((name[len("bench."):], e.start_ns(), e.end_ns()))
    if lo is None:
        raise RuntimeError("the traced stretch's marker is missing from the trace")
    return trace_mod.reduce(lo, hi, device, spans)


def result(cell: spec.Cell, out: dict, trace: bool) -> dict:
    """The result line: the cell's end-to-end metrics (``trace`` False) or
    per-layer ones, each from its reader; a reader that finds nothing to
    read leaves its metric out."""
    ctx = out["ctx"]
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(cell.root, m.name)(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        line["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                             "idle_gaps": ctx.trace["idle_gaps"]}
    # Whether this run generated the structure or searched the plans (a
    # checkout's first run), and the plan each bucket runs: a set-up or a
    # rate that moves with the plan shows why.
    line["cold"] = out["cold"]
    line["plans"] = out["plans"]
    line["checks"] = out["checks"]
    return line

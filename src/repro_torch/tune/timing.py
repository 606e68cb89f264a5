"""The paper's timing protocol (§4: warm up, then steady-state runs).

* warmup runs are discarded (the first eats lazy setup such as the kernel
  build or cuBLAS handle creation);
* the reported figure is the **median** of the timed reps;
* ``REPRO_TUNE_REPS`` / ``REPRO_TUNE_WARMUP`` set a process-wide *floor*
  on the rep counts (the same variables as the JAX package's).

On a CUDA device each rep is timed with CUDA events around the call and
ends in a synchronise, so the figure is the device's time for the work, not
the host's enqueue time; on the CPU it is ``perf_counter`` wall time.

Candidate racing (``abort_above=``): a candidate whose *first* timed rep
exceeds the bound — confirmed by one more rep, so a lone blip cannot
discard the true best — is abandoned (``inf``) without its remaining reps.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

__all__ = ["WARMUP", "TIMED", "RACE_FACTOR", "time_fn"]

RACE_FACTOR = 3.0
WARMUP = 3
TIMED = 10

_ENV_REPS = "REPRO_TUNE_REPS"
_ENV_WARMUP = "REPRO_TUNE_WARMUP"


def _floor_from_env(name: str, value: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return value
    try:
        return max(value, int(raw))
    except ValueError:
        return value


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _timer(device: torch.device):
    """A ``run(fn, args) -> seconds`` clock for one device."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run(fn, args):
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        return run

    def run(fn, args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    return run


def time_fn(
    fn,
    *args,
    warmup: int = WARMUP,
    timed: int = TIMED,
    abort_above: float | None = None,
    device: torch.device | None = None,
) -> float:
    """Median time (seconds) over ``timed`` runs after ``warmup``.

    The device is ``device``, else that of the first tensor argument (a
    sparse operand is a host tuple, so its search names the device).  A
    floored ``timed``
    forces ``warmup >= 1``, and so does racing, so a cold first call never
    enters the median or triggers an abort.
    """
    timed_floored = _floor_from_env(_ENV_REPS, max(int(timed), 1))
    if timed_floored > timed:
        warmup = max(warmup, 1)
    timed = timed_floored
    if abort_above is not None:
        warmup = max(warmup, 1)
    warmup = _floor_from_env(_ENV_WARMUP, int(warmup))
    device = _device_of(args) if device is None else torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    clock = _timer(device)
    times = []
    for _ in range(timed):
        times.append(clock(fn, args))
        if abort_above is not None and len(times) == 1 and times[0] > abort_above:
            confirm = clock(fn, args)
            if confirm > abort_above:
                return math.inf
            times.append(confirm)
    return float(np.median(times))

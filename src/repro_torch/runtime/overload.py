"""Overload protection for the serving runtime: admission, shedding, brownout.

The paper's saturation curves are the motivation: on a memory-bound
machine SpMV throughput flat-lines once latency binds, and past that point
extra concurrent work buys no throughput, only latency.  A serving stack
without that discipline turns a traffic spike into unbounded queue memory
and unbounded p99.  This module holds the pieces the engine uses (the same
classes, with the same state machines, as the JAX package's):

* the typed errors: :class:`OverloadError` (admission refused: the queue
  is full under ``reject``, ``block`` timed out, a token bucket ran dry,
  or the brownout controller is shedding — raised from ``submit``, in
  microseconds); :class:`DeadlineExceededError` (an ``OverloadError``: the
  request was admitted but lapsed before dispatch, and its future fails);
  :class:`EngineClosedError` (the engine was closed);
* :class:`TokenBucket` — non-blocking rate admission;
* :class:`BrownoutController` — a watermark state machine (HEALTHY ->
  BROWNOUT -> SHED) over a scalar pressure in [0, 1+] (the engine feeds
  the max of queue fill and oldest-request age), with
  hysteresis (separate enter/exit watermarks) and a minimum dwell time, so
  a boundary load cannot flap it; SHED steps down through BROWNOUT, never
  straight to HEALTHY.  Listeners (the engine's supervisor) get every
  transition.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

__all__ = [
    "OverloadError",
    "DeadlineExceededError",
    "EngineClosedError",
    "TokenBucket",
    "BrownoutController",
    "BrownoutTransition",
    "HEALTHY",
    "BROWNOUT",
    "SHED",
]


class OverloadError(RuntimeError):
    """Admission refused under load: the bounded queue is full (``reject``
    policy or a ``block`` timeout), a token bucket ran dry, or the
    brownout controller is shedding.  Fails fast at ``submit()`` — the
    typed signal for callers to back off or retry elsewhere."""


class DeadlineExceededError(OverloadError):
    """The request was admitted but waited past its deadline before
    dispatch; its future fails instead of occupying a bucket slot computing
    an answer nobody is waiting for."""


class EngineClosedError(RuntimeError):
    """The engine is closed: new submissions are refused, and any future
    still unresolved at ``close(drain=False)`` carries this instead of
    blocking its caller in ``result()`` forever."""


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``try_take`` is non-blocking by design — rate admission must fail a
    greedy caller in microseconds, not stall the submit path.
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t = time.perf_counter()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0, now: float | None = None) -> bool:
        """Consume ``n`` tokens if available; False (and no debt) if not."""
        with self._lock:
            if now is None:
                now = time.perf_counter()
            dt = max(0.0, now - self._t)
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self._t = now
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"TokenBucket(rate={self.rate:g}/s, burst={self.burst:g}, "
            f"tokens={self.tokens:.2f})"
        )


HEALTHY = "healthy"
BROWNOUT = "brownout"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class BrownoutTransition:
    """One state change of a :class:`BrownoutController`."""

    t: float
    frm: str
    to: str
    pressure: float


class BrownoutController:
    """Watermark state machine over a scalar overload-pressure signal.

    Pressure is a dimensionless fraction: the caller feeds
    ``update(max(queue_depth/max_queue, oldest_age/shed_after_s))`` (see
    :meth:`pressure`), and the controller
    answers with one of three states:

    ========== ==============================================================
    state      meaning
    ========== ==============================================================
    HEALTHY    serve normally
    BROWNOUT   degrade gracefully: pin dispatch to the widest k-bucket,
               pause the background repair probes
    SHED       additionally refuse NEW work fast (``OverloadError`` at
               submit) while queued work keeps draining
    ========== ==============================================================

    Hysteresis: the state *enters* at ``enter_brownout``/``enter_shed`` and
    only *exits* below the strictly lower ``exit_brownout``/``exit_shed``
    watermarks, so a load sitting exactly on a boundary cannot flap the
    state.  ``min_dwell_s`` additionally pins every state for a minimum
    time; SHED de-escalates to BROWNOUT (never straight to HEALTHY), so
    recovery is observable as two transitions.  ``listeners`` receive each
    :class:`BrownoutTransition` — the engine subscribes its supervisor's
    event log.

    Thread-safety: ``update`` is called from one driving thread (the
    serving loop); ``state`` reads are a single attribute load and safe
    from any thread (the engine's repair worker polls it).
    """

    def __init__(
        self,
        *,
        enter_brownout: float = 0.7,
        exit_brownout: float = 0.35,
        enter_shed: float = 0.95,
        exit_shed: float = 0.7,
        min_dwell_s: float = 0.05,
    ):
        if not (exit_brownout < enter_brownout and exit_shed < enter_shed):
            raise ValueError(
                "exit watermarks must sit strictly below their enter "
                "watermarks (that gap IS the hysteresis)"
            )
        if enter_brownout > enter_shed:
            raise ValueError("enter_brownout must not exceed enter_shed")
        self.enter_brownout = float(enter_brownout)
        self.exit_brownout = float(exit_brownout)
        self.enter_shed = float(enter_shed)
        self.exit_shed = float(exit_shed)
        self.min_dwell_s = float(min_dwell_s)
        self.state = HEALTHY
        self.pressure_last = 0.0
        self.transitions: list[BrownoutTransition] = []
        self.listeners: list[Callable[[BrownoutTransition], None]] = []
        self._t_entered = time.perf_counter()

    @staticmethod
    def pressure(**signals: float | None) -> float:
        """Fold named normalized signals into one scalar: the max of all
        non-None values, floored at 0 (callers pass e.g. ``queue=0.4,
        age=None`` without filtering)."""
        vals = [float(v) for v in signals.values() if v is not None]
        return max(vals) if vals else 0.0

    def add_listener(self, fn: Callable[[BrownoutTransition], None]) -> None:
        self.listeners.append(fn)

    def entries(self, state: str) -> int:
        """How many transitions entered ``state``."""
        return sum(1 for tr in self.transitions if tr.to == state)

    def update(self, pressure: float, now: float | None = None) -> str:
        """Advance the state machine one observation; returns the state."""
        if now is None:
            now = time.perf_counter()
        self.pressure_last = float(pressure)
        # min_dwell_s == 0 disables dwell gating entirely (a synthetic
        # ``now`` clock may predate the construction-time anchor).
        if self.min_dwell_s > 0.0 and now - self._t_entered < self.min_dwell_s:
            return self.state
        nxt = self.state
        if self.state == HEALTHY:
            if pressure >= self.enter_shed:
                nxt = SHED
            elif pressure >= self.enter_brownout:
                nxt = BROWNOUT
        elif self.state == BROWNOUT:
            if pressure >= self.enter_shed:
                nxt = SHED
            elif pressure <= self.exit_brownout:
                nxt = HEALTHY
        else:  # SHED: step down one level at a time — recovery is gradual
            if pressure <= self.exit_shed:
                nxt = BROWNOUT
        if nxt is not self.state:
            tr = BrownoutTransition(
                t=now, frm=self.state, to=nxt, pressure=float(pressure)
            )
            self.state = nxt
            self._t_entered = now
            self.transitions.append(tr)
            for fn in self.listeners:
                fn(tr)
        return self.state

    def summary(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "pressure": round(self.pressure_last, 4),
            "transitions": len(self.transitions),
            "brownout_entries": self.entries(BROWNOUT),
            "shed_entries": self.entries(SHED),
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"BrownoutController(state={self.state}, "
            f"pressure={self.pressure_last:.2f}, "
            f"transitions={len(self.transitions)})"
        )

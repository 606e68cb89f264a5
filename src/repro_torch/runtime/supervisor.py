"""Supervision policy for the serving runtime: retry, demote, repair.

The paper's central finding — the best kernel is per matrix, and the gap to
a safe baseline is performance, not correctness — is what makes degraded
serving possible: when a tuned executable starts failing there is always a
slower tier that computes the same y = A @ x.

* :class:`Supervisor` — the retry/backoff policy plus an event log and
  counters.  A failed batch is retried up to ``max_retries`` times with
  capped exponential backoff; persistent failure walks the bucket down the
  **fallback chain**; an exhausted chain fails the batch's futures (a
  request always resolves, with a result or an exception).
* :data:`FALLBACK_TIERS` / :func:`fallback_op` — the chain: tuned plan ->
  ``csr/vector`` (gather + row sum, every matrix at every k) ->
  ``sell/ref`` (an independently written gather tier, sigma = 1, so a bug
  in the CSR path cannot take both down).  Each tier is a full
  :meth:`SparseOperator.from_candidate` operator on the engine's device.
  Demotion is visible: ``events_of("demote")`` and ``stats.demotions``.
* :class:`NonFiniteOutput` — the failure the opt-in on-device finite guard
  reports.
* :class:`CircuitOpenError` — the fleet's per-tenant circuit breaker is
  open (``runtime.fleet``).
* :func:`injected` — whether a failure came from an armed fault plan.  On a
  card only those are retried and demoted: a kernel that really fails (a
  refused launch, a device fault, a non-finite result of real inputs)
  fails its batch's futures and is never replaced by a plain tier.

Re-promotion is the engine's job (``SparseEngine._repair_worker``).  The
event log also carries ``brownout`` transitions and ``engine_aborted``
(futures failed by ``close(drain=False)``), so one ``events_of`` query
reconstructs an incident across fault and load protection.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from repro_torch.runtime.faults import InjectedFault
from repro_torch.tune import SparseOperator
from repro_torch.tune.candidates import make

__all__ = [
    "Supervisor",
    "SupervisorEvent",
    "NonFiniteOutput",
    "CircuitOpenError",
    "injected",
    "FALLBACK_TIERS",
    "fallback_op",
]


class NonFiniteOutput(RuntimeError):
    """A batch produced NaN/Inf outputs (flagged by the opt-in on-device
    guard, ``nan_guard=True``); treated exactly like a dispatch fault.
    ``injected`` is True when the engine's ``engine.nan`` site poisoned the
    batch."""

    def __init__(self, msg: str, *, injected: bool = False):
        super().__init__(msg)
        self.injected = bool(injected)


class CircuitOpenError(RuntimeError):
    """The fleet's per-tenant circuit breaker is open: the tenant's batches
    kept failing, so its requests fail fast instead of stalling the
    cross-tenant scheduler.  Resubmit after the cooldown."""


def injected(exc: BaseException) -> bool:
    """True when ``exc`` is a failure an armed :class:`FaultPlan` caused:
    an :class:`InjectedFault`, or the non-finite result of a batch the
    ``engine.nan`` site poisoned."""
    return isinstance(exc, InjectedFault) or getattr(exc, "injected", False) is True


# The degraded-mode chain, most capable first.  sigma = 1 disables the
# row-sorting window: a fallback must not pay a reorder.
FALLBACK_TIERS: tuple[tuple[str, Any], ...] = (
    ("csr/vector", make("csr", "vector")),
    ("sell/ref", make("sell", "ref", C=8, sigma=1)),
)


def fallback_op(a, bucket, level: int, *, device) -> tuple[str, SparseOperator]:
    """Build tier ``level`` (1-based) of the chain for one bucket on
    ``device``.

    ``bucket`` is an engine k-bucket (int), or ``("spmspv", B)`` for a
    sparse-RHS bucket — built with ``x_nnz=`` so the dense fallback serves
    through its densify wrapper.  Raises ``IndexError`` past the end of the
    chain.
    """
    name, cand = FALLBACK_TIERS[level - 1]
    if isinstance(bucket, tuple):
        op = SparseOperator.from_candidate(a, cand, x_nnz=int(bucket[1]),
                                           device=device)
    else:
        b = int(bucket)
        op = SparseOperator.from_candidate(a, cand, k=None if b == 1 else b,
                                           device=device)
    return name, op


@dataclasses.dataclass(frozen=True)
class SupervisorEvent:
    """One supervision decision (failure, retry, demote, promote, ...)."""

    kind: str
    t: float
    info: dict[str, Any]


class Supervisor:
    """Retry/backoff/repair policy plus counters and an event log.

    One instance per engine.  ``max_retries`` is the per-tier retry budget;
    backoff is ``base * 2**attempt`` capped at ``cap``;
    ``repair_interval_s`` paces the engine's background probe of a demoted
    bucket's saved tuned executable.
    """

    def __init__(
        self,
        *,
        max_retries: int = 2,
        backoff_base_s: float = 0.005,
        backoff_cap_s: float = 0.25,
        repair_interval_s: float = 0.05,
    ):
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.repair_interval_s = float(repair_interval_s)
        self.retries = 0
        self.failures = 0
        self.demotions = 0
        self.promotions = 0
        self.events: list[SupervisorEvent] = []
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        """Capped exponential backoff for the attempt-th retry (0-based)."""
        return min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))

    def sleep(self, seconds: float) -> None:
        if seconds > 0.0:
            time.sleep(seconds)

    def record(self, kind: str, **info: Any) -> None:
        """Append one event (thread-safe: the serving and repair threads
        both report here)."""
        with self._lock:
            self.events.append(
                SupervisorEvent(kind=kind, t=time.perf_counter(), info=info)
            )

    def events_of(self, kind: str) -> list[SupervisorEvent]:
        with self._lock:
            return [e for e in self.events if e.kind == kind]

    def summary(self) -> dict[str, Any]:
        with self._lock:
            kinds: dict[str, int] = {}
            for e in self.events:
                kinds[e.kind] = kinds.get(e.kind, 0) + 1
        return {
            "retries": self.retries,
            "failures": self.failures,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "events": kinds,
        }

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Supervisor(max_retries={self.max_retries}, "
            f"retries={self.retries}, failures={self.failures}, "
            f"demotions={self.demotions}, promotions={self.promotions})"
        )

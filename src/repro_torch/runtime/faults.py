"""Deterministic fault injection for the serving runtime.

Chaos testing a serving stack needs failures that are *injected on purpose,
at named sites, reproducibly* — a fault that only fires in production is a
fault the test suite never saw.  A :class:`FaultPlan` is a registry of
armed injection sites; runtime components consult it at the places real
faults would surface:

====================  =====================================================
site                  what fires there
====================  =====================================================
``engine.dispatch``   the bucket executable raises at launch
``engine.nan``        a request column is poisoned with NaN before dispatch
                      (the "slab DMA returned garbage" failure mode; caught
                      by the engine's opt-in on-device finite guard)
``engine.overload``   dispatch is SLOWED, not failed: the site's
                      ``delay_s`` option stalls the serving thread before
                      the launch — synthetic overload with a known service
                      cost
``plan_cache.read``   the plan-cache JSON comes back torn (truncated at a
                      seeded offset), as after a kill mid-write
``prepare.oom``       format preparation raises ``MemoryError``
``solver.dispatch``   a fused solve (``runtime.solver``) raises at launch
``fleet.retune``      the fleet's background retune (``runtime.fleet``)
                      raises before its measured search
====================  =====================================================

Activation is explicit: pass ``faults=FaultPlan(...)`` to a component, or
set ``$REPRO_TORCH_FAULTS`` (parsed once per process into the module-global
active plan).  The variable is the port's own, so a plan armed for the JAX
package (``$REPRO_FAULTS``) does not arm the port.  The syntax is
``;``-separated site entries, each with ``:key=value`` options::

    REPRO_TORCH_FAULTS="engine.dispatch:p=0.05;plan_cache.read:n=1;seed=7"
    REPRO_TORCH_FAULTS="engine.dispatch:n=3:engine=bad"
    REPRO_TORCH_FAULTS="solver.dispatch:n=1"

Per site: ``p`` is the fire probability (default 1.0), ``n`` caps how many
times the site fires (default unlimited), ``delay_s`` makes the site a
slow-down instead of a failure (consumed through :meth:`FaultPlan.delay`
by sites that support it, e.g. ``engine.overload``); any other key is a
*context match* — the site only fires when the caller's context carries
that value (``engine=bad`` scopes a storm to one tenant's engine).
``seed=N`` is a plan-wide entry seeding the RNG, so probabilistic plans
replay exactly.  Plan, spec syntax and RNG are the JAX package's, so the
same plan fed the same calls fires at the same calls in both packages.

Every fire is appended to ``plan.log`` (a :class:`FaultEvent` with the
site, sequence number and call context), so tests assert *which* fault
fired, not just that something went wrong.  All methods are thread-safe:
serving threads, retune workers and repair threads share one plan.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any

import numpy as np

__all__ = [
    "FaultPlan",
    "FaultEvent",
    "InjectedFault",
    "active_plan",
    "set_active",
]

_ENV = "REPRO_TORCH_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by an armed injection site (never by real failures)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injection that actually fired."""

    site: str
    seq: int  # plan-wide firing sequence number (0-based)
    ctx: dict[str, Any]


@dataclasses.dataclass
class _Site:
    name: str
    p: float = 1.0
    n: int | None = None  # remaining fires; None = unlimited
    delay_s: float = 0.0  # slow-down sites: stall instead of raising
    match: dict[str, str] = dataclasses.field(default_factory=dict)

    def accepts(self, ctx: dict[str, Any]) -> bool:
        return all(str(ctx.get(k)) == v for k, v in self.match.items())


def _parse_spec(spec: str) -> tuple[dict[str, dict], int | None]:
    """``site[:k=v]*;...`` -> ({site: options}, seed or None)."""
    sites: dict[str, dict] = {}
    seed: int | None = None
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, *opts = entry.split(":")
        if "=" in head:  # plan-wide option, e.g. "seed=7"
            key, _, val = head.partition("=")
            if key.strip() != "seed":
                raise ValueError(
                    f"unknown {_ENV} plan option {head!r} (only 'seed=N' "
                    "is plan-wide; sites are 'name[:p=..][:n=..][:ctx=..]')"
                )
            seed = int(val)
            continue
        d: dict[str, Any] = {}
        for opt in opts:
            key, sep, val = opt.partition("=")
            if not sep:
                raise ValueError(
                    f"malformed {_ENV} option {opt!r} in {entry!r} "
                    "(expected key=value)"
                )
            d[key.strip()] = val.strip()
        sites[head.strip()] = d
    return sites, seed


class FaultPlan:
    """A registry of armed injection sites (see module docstring).

    ``spec`` is the ``$REPRO_TORCH_FAULTS`` string syntax or an equivalent dict
    ``{site: {"p": .., "n": .., <ctx-match>: ..}}``; ``seed`` makes
    probabilistic sites replayable (a ``seed=N`` entry in the spec wins).
    """

    def __init__(self, spec: str | dict | None = None, *, seed: int = 0):
        sites: dict[str, dict]
        if spec is None:
            sites = {}
        elif isinstance(spec, str):
            sites, env_seed = _parse_spec(spec)
            if env_seed is not None:
                seed = env_seed
        else:
            sites = {name: dict(opts or {}) for name, opts in spec.items()}
        self._sites: dict[str, _Site] = {}
        for name, opts in sites.items():
            opts = dict(opts)
            p = float(opts.pop("p", 1.0))
            n = opts.pop("n", None)
            delay_s = float(opts.pop("delay_s", 0.0))
            self._sites[name] = _Site(
                name=name,
                p=p,
                n=None if n is None else int(n),
                delay_s=delay_s,
                match={k: str(v) for k, v in opts.items()},
            )
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self.log: list[FaultEvent] = []

    # -- firing --------------------------------------------------------------
    def should_fire(self, site: str, **ctx: Any) -> bool:
        """True (and consume one armed count, logging the event) when the
        named site fires under this call's context."""
        s = self._sites.get(site)
        if s is None:
            return False
        with self._lock:
            if s.n is not None and s.n <= 0:
                return False
            if not s.accepts(ctx):
                return False
            if s.p < 1.0 and self._rng.random() >= s.p:
                return False
            if s.n is not None:
                s.n -= 1
            self.log.append(FaultEvent(site=site, seq=len(self.log), ctx=ctx))
            return True

    def fire(self, site: str, exc: type[BaseException] = InjectedFault,
             **ctx: Any) -> None:
        """Raise ``exc`` when the site fires; no-op otherwise."""
        if self.should_fire(site, **ctx):
            raise exc(f"injected fault at {site} (ctx={ctx})")

    def delay(self, site: str, **ctx: Any) -> float:
        """Seconds the caller should stall when a slow-down site fires
        (0.0 otherwise).  The caller sleeps OUTSIDE the plan lock — a slow
        dispatch must not serialize other threads' fault checks."""
        s = self._sites.get(site)
        if s is None or s.delay_s <= 0.0:
            return 0.0
        return s.delay_s if self.should_fire(site, **ctx) else 0.0

    def corrupt_text(self, site: str, text: str, **ctx: Any) -> str:
        """Return ``text`` torn at a seeded offset when the site fires —
        the kill-mid-write failure mode for file reads."""
        if not self.should_fire(site, **ctx) or len(text) < 2:
            return text
        with self._lock:
            off = int(self._rng.integers(1, len(text)))
        return text[:off]

    # -- introspection -------------------------------------------------------
    def fired(self, site: str | None = None) -> int:
        """How many injections fired (at one site, or plan-wide)."""
        with self._lock:
            if site is None:
                return len(self.log)
            return sum(1 for e in self.log if e.site == site)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        armed = {
            s.name: {"p": s.p, "n": s.n, **s.match}
            for s in self._sites.values()
        }
        return f"FaultPlan({armed}, seed={self.seed}, fired={len(self.log)})"


# -- process-global plan (the $REPRO_TORCH_FAULTS activation path) -----------
_active: FaultPlan | None = None
_env_checked = False
_global_lock = threading.Lock()


def active_plan() -> FaultPlan | None:
    """The process-wide plan: ``$REPRO_TORCH_FAULTS`` parsed once, or whatever
    :func:`set_active` installed.  None means no faults are armed — the
    runtime's zero-overhead fast path."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _global_lock:
            if not _env_checked:
                spec = os.environ.get(_ENV)
                if spec:
                    _active = FaultPlan(spec)
                _env_checked = True
    return _active


def set_active(plan: FaultPlan | None) -> FaultPlan | None:
    """Install (or clear, with None) the process-wide plan; returns the
    previous one so tests can restore it."""
    global _active, _env_checked
    with _global_lock:
        prev = _active
        _active = plan
        _env_checked = True  # an explicit set always wins over the env
    return prev

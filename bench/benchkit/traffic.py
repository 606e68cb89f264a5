"""The one generator every traffic mix's parameters go through.

A mix is a JSON file under ``bench/traffic/`` with these keys:

``pool``         distinct x vectors made from the seed; request i takes the
                 pool's ``order[i % pool]``-th, ``order`` a permutation
                 drawn from the seed;
``warm``         the batch widths the set-up dispatches before the window
                 (each ``WARM_ROUNDS`` times): the widths this mix's
                 dispatches take;
``rate_per_s``   an open loop: arrivals at this mean rate, each request
                 due at its arrival and timed from it;
``phases``       with ``rate_per_s``, optional: a cycle of ``[seconds,
                 factor]`` pieces, the rate in each being factor x
                 ``rate_per_s`` (on/off bursts: ``[[0.064, 4], [0.192,
                 0]]``); the factors should average 1 over the cycle;
``outstanding``  at most this many requests in the engine; without a rate,
                 a closed loop that replaces each retired request at once.

So a closed loop is ``{"outstanding": 192, ...}``, Poisson arrivals are
``{"rate_per_s": 8000, ...}``, and bursts, or an open loop behind a
client's concurrency limit, are the same keys combined.

Arrivals are a Poisson process through the rate's cycle: one multiset of
exponential gaps, drawn from a fixed seed for the rate and the window,
which each run's seed only reorders, mapped through the cycle's
cumulative rate.  Every seed offers the same number of requests with the
same gaps, so two seeds differ in the order of the arrivals and not in
the amount of work.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

WARM_ROUNDS = 3
KEYS = frozenset({"pool", "warm", "rate_per_s", "phases", "outstanding"})
_GAPS_SEED = 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    order: np.ndarray  # pool index of request i is order[i % len(order)]
    outstanding: float = math.inf  # most requests in the engine at once
    due_s: np.ndarray | None = None  # open loop: offsets from the window's start
    warm: tuple[int, ...] = ()

    @property
    def timed(self) -> bool:
        """Whether requests are due at set times (an open loop), so that
        their latency is timed from when they were due."""
        return self.due_s is not None

    def pool_index(self, i: int) -> int:
        return int(self.order[i % self.order.shape[0]])


def _cycle(phases) -> tuple[np.ndarray, np.ndarray, float, float]:
    """Each piece's start and its cumulative mass (seconds x factor) at its
    start, the cycle's length and its mass."""
    d = np.array([float(p[0]) for p in phases])
    f = np.array([float(p[1]) for p in phases])
    if d.size == 0 or np.any(d <= 0) or np.any(f < 0) or not np.any(f > 0):
        raise ValueError(f"phases {phases!r}: pieces need seconds > 0, factors >= 0, "
                         "and one factor > 0")
    start = np.concatenate([[0.0], np.cumsum(d)[:-1]])
    mass = np.concatenate([[0.0], np.cumsum(d * f)[:-1]])
    return start, mass, float(d.sum()), float((d * f).sum())


def _through_cycle(tau: np.ndarray, phases) -> np.ndarray:
    """Times at which the cycle's cumulative factor reaches ``tau``."""
    start, mass, length, total = _cycle(phases)
    factor = np.array([float(p[1]) for p in phases])
    q, rem = np.divmod(tau, total)
    # the last piece with mass at or below rem and a factor above 0
    live = np.flatnonzero(factor > 0)
    k = live[np.searchsorted(mass[live], rem, side="right") - 1]
    return q * length + start[k] + (rem - mass[k]) / factor[k]


def arrivals(rate_per_s: float, seconds: float, seed: int, phases=None) -> np.ndarray:
    """Arrival offsets in [0, seconds): a fixed multiset of exponential gaps
    at ``rate_per_s``, in an order drawn from ``seed``, through the
    ``phases`` cycle where given."""
    mean = 1.0
    if phases:
        _, _, length, total = _cycle(phases)
        mean = total / length
    n = int(rate_per_s * mean * seconds * 1.2) + 64
    gaps = np.random.default_rng(_GAPS_SEED).exponential(1.0 / rate_per_s, size=n)
    gaps = np.random.default_rng(seed).permutation(gaps)
    t = np.cumsum(gaps) - gaps[0]  # the first request is due at the start
    if phases:
        t = _through_cycle(t, phases)
    return t[t < seconds]


def schedule(traffic: dict, seed: int, seconds: float) -> Schedule:
    unknown = set(traffic) - KEYS
    if unknown:
        raise ValueError(f"traffic keys {sorted(unknown)} are not among {sorted(KEYS)}")
    rate = traffic.get("rate_per_s")
    if rate is None and "outstanding" not in traffic:
        raise ValueError("a traffic mix needs rate_per_s, outstanding, or both")
    if "phases" in traffic and rate is None:
        raise ValueError("phases shape a rate: give rate_per_s too")
    order = np.random.default_rng([seed, 1]).permutation(int(traffic["pool"]))
    due = None if rate is None else arrivals(float(rate), seconds, seed,
                                             traffic.get("phases"))
    return Schedule(order, outstanding=float(traffic.get("outstanding", math.inf)),
                    due_s=due, warm=tuple(int(w) for w in traffic.get("warm", ())))

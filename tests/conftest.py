"""Tier-1 collection shim: a minimal seeded `hypothesis` fallback.

Three test modules use hypothesis property tests.  The CPU container does
not ship the package (and nothing may be pip-installed), so collection used
to die with ModuleNotFoundError before a single test ran.  This conftest
installs a tiny deterministic stand-in into ``sys.modules`` *before* test
modules are imported, implementing exactly the surface those tests use:

  given / settings / assume
  strategies.{composite,integers,floats,sampled_from,tuples,...}

Sampling is fixed-seed numpy (seeded per test from the test name), so the
fallback is reproducible run-to-run.  When the real hypothesis is installed
(see requirements-dev.txt) this file is a no-op and the genuine
property-based machinery takes over.
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import sys
import types

import numpy as np


def _install_hypothesis_shim() -> None:
    class Strategy:
        """A value sampler: ``sample(rng) -> value``."""

        def __init__(self, sample):
            self.sample = sample

        def map(self, f):
            return Strategy(lambda rng: f(self.sample(rng)))

        def filter(self, pred):
            def sample(rng):
                for _ in range(1000):
                    v = self.sample(rng)
                    if pred(v):
                        return v
                raise ValueError("shim filter(): predicate rejected 1000 draws")

            return Strategy(sample)

    def integers(min_value, max_value):
        return Strategy(lambda rng: int(rng.integers(min_value, max_value + 1)))

    def floats(min_value, max_value):
        return Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    def booleans():
        return Strategy(lambda rng: bool(rng.integers(2)))

    def just(value):
        return Strategy(lambda rng: value)

    def sampled_from(seq):
        elems = list(seq)
        return Strategy(lambda rng: elems[int(rng.integers(len(elems)))])

    def lists(elem, min_size=0, max_size=10):
        def sample(rng):
            size = int(rng.integers(min_size, max_size + 1))
            return [elem.sample(rng) for _ in range(size)]

        return Strategy(sample)

    def tuples(*elems):
        return Strategy(lambda rng: tuple(e.sample(rng) for e in elems))

    class _Unsatisfied(Exception):
        """Raised by assume(False); the given() loop skips the example."""

    def assume(condition):
        if not condition:
            raise _Unsatisfied
        return True

    def composite(fn):
        @functools.wraps(fn)
        def build(*args, **kwargs):
            def sample(rng):
                return fn(lambda s: s.sample(rng), *args, **kwargs)

            return Strategy(sample)

        return build

    def given(*gargs, **gkwargs):
        def deco(test):
            @functools.wraps(test)
            def wrapper():
                n = getattr(wrapper, "_shim_max_examples", 20)
                seed = int.from_bytes(
                    hashlib.sha256(test.__name__.encode()).digest()[:4], "little"
                )
                rng = np.random.default_rng(seed)
                for _ in range(n):
                    args = [s.sample(rng) for s in gargs]
                    kw = {k: s.sample(rng) for k, s in gkwargs.items()}
                    try:
                        test(*args, **kw)
                    except _Unsatisfied:
                        continue  # assume() rejected this draw

            wrapper._shim_given = True
            # pytest must see a zero-arg function (the strategies supply the
            # arguments), not the wrapped signature functools.wraps copied.
            wrapper.__signature__ = inspect.Signature()
            if hasattr(wrapper, "__wrapped__"):
                del wrapper.__wrapped__
            return wrapper

        return deco

    def settings(max_examples=20, deadline=None, **_ignored):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn

        return deco

    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.floats = floats
    st.booleans = booleans
    st.just = just
    st.sampled_from = sampled_from
    st.lists = lists
    st.tuples = tuples
    st.composite = composite
    st.Strategy = Strategy

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    hyp.assume = assume
    hyp.strategies = st
    hyp.__shim__ = True

    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skips from a fixture when none is visible",
    )


try:  # real hypothesis wins when available
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - depends on environment
    _install_hypothesis_shim()

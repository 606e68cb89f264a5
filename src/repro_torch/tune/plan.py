"""Plans and the JSON plan cache.

A :class:`Plan` is the durable result of one measured search: which
(format, impl, params) won for one matrix structure, with the bookkeeping
to audit the decision.  The cache key is a *structure fingerprint* — sha256
over shape, dtype and the indptr/indices bytes, equal to the JAX package's
for the same matrix.  Values are excluded: the paper's phenomena depend
only on the pattern.

Plans record where they were measured: the backend (torch device type plus
the card's name) and the problem scale (m, n, nnz).  A plan is a point
measurement, so a backend or scale mismatch is a miss and the caller
re-searches.  The port keeps its own cache file
(``~/.cache/repro_torch_tune/plans.json``, or ``$REPRO_TORCH_TUNE_CACHE``),
so a plan of the JAX package never loads here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Iterable

try:  # POSIX advisory locks for the shared on-disk cache (see PlanCache.put)
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: merge-only
    fcntl = None

import numpy as np

from repro_torch.core.formats import CSRMatrix

from .candidates import Candidate, make

__all__ = ["PLAN_VERSION", "Plan", "PlanCache", "fingerprint", "default_cache"]

PLAN_VERSION = 1

_ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_CACHE = "~/.cache/repro_torch_tune/plans.json"

# Paths that already warned about a corrupt cache in this process: the
# condition is sticky on disk (the file was moved aside).
_QUARANTINE_WARNED: set[str] = set()
_QUARANTINE_LOCK = threading.Lock()


def fingerprint(a: CSRMatrix) -> str:
    """Structure-only fingerprint: shape + dtype + indptr/indices bytes."""
    h = hashlib.sha256()
    h.update(repr((tuple(a.shape), a.nnz, str(a.data.dtype))).encode())
    h.update(np.ascontiguousarray(a.indptr).tobytes())
    h.update(np.ascontiguousarray(a.indices).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class Plan:
    fingerprint: str
    kind: str  # "spmv" | "spmm" | "spmspv"
    fmt: str
    impl: str
    params: dict[str, Any]
    est_cost: float
    measured_s: float
    n_candidates: int  # enumerated
    n_measured: int  # survived pruning and were timed
    k: int = 1  # dense-operand width (1 for spmv); the x-nnz bucket for spmspv
    backend: str = ""  # "cpu" or "cuda:<card name>" ("" = unknown)
    scale: list = dataclasses.field(default_factory=list)  # [m, n, nnz]
    n_raced: int = 0  # survivors abandoned by racing after one rep
    features: dict | None = None  # MatrixFeatures.to_dict() at search time
    version: int = PLAN_VERSION

    def matches(self, backend: str | None, scale: Iterable[int] | None) -> bool:
        """True when this plan's measurement context covers the request."""
        if backend is not None and self.backend != backend:
            return False
        if scale is not None and list(self.scale) != [int(s) for s in scale]:
            return False
        return True

    @property
    def candidate(self) -> Candidate:
        return make(self.fmt, self.impl, **self.params)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Plan":
        return cls(**d)


class PlanCache:
    """In-memory plan store with optional JSON persistence.

    ``PlanCache()`` is memory-only; ``PlanCache(path)`` loads the JSON file
    if present and rewrites it atomically on every put.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path).expanduser() if path else None
        self._plans: dict[str, dict] = self._load_resident()

    def _load_resident(self) -> dict[str, dict]:
        """Load the on-disk table; a corrupt file is QUARANTINED — moved to
        ``<path>.corrupt-<millis>`` with one warning — and the table starts
        empty, so every plan re-searches (slow and correct)."""
        if self.path is None or not self.path.exists():
            return {}
        try:
            return self._current(json.loads(self.path.read_text()))
        except (json.JSONDecodeError, OSError) as exc:
            self._quarantine(exc)
            return {}

    def _quarantine(self, exc: Exception) -> None:
        try:
            dest = f"{self.path}.corrupt-{int(time.time() * 1000)}"
            os.replace(self.path, dest)
        except OSError:  # a racing process already moved it
            dest = None
        with _QUARANTINE_LOCK:
            first = str(self.path) not in _QUARANTINE_WARNED
            _QUARANTINE_WARNED.add(str(self.path))
        if first:
            warnings.warn(
                f"plan cache {self.path} is corrupt ({exc!r}); "
                + (f"quarantined to {dest}" if dest else "quarantine rename failed")
                + " — starting with an empty table (plans will re-search)",
                RuntimeWarning,
                stacklevel=3,
            )

    @staticmethod
    def _current(plans: Any) -> dict[str, dict]:
        """Drop entries of other PLAN_VERSIONs and malformed ones."""
        if not isinstance(plans, dict):
            return {}
        return {
            key: d
            for key, d in plans.items()
            if isinstance(d, dict) and d.get("version") == PLAN_VERSION
        }

    @staticmethod
    def _key(fp: str, kind: str, k: int = 1) -> str:
        return f"{fp}:{kind}:k{k}"

    def __len__(self) -> int:
        return len(self._plans)

    def get(
        self,
        fp: str,
        kind: str,
        k: int = 1,
        *,
        backend: str | None = None,
        scale: Iterable[int] | None = None,
    ) -> Plan | None:
        """Fetch a plan; a backend or scale mismatch is a miss."""
        d = self._plans.get(self._key(fp, kind, k))
        if d is None:
            return None
        try:
            plan = Plan.from_json(d)
        except TypeError:  # entry shape drifted: a miss, never a crash
            return None
        return plan if plan.matches(backend, scale) else None

    @contextlib.contextmanager
    def _write_lock(self):
        """Exclusive advisory lock over the sidecar ``.lock`` file, held
        across read-merge-write-replace so a concurrent writer's plan is
        never clobbered."""
        if fcntl is None or self.path is None:
            yield
            return
        lock_path = self.path.with_name(self.path.name + ".lock")
        with open(lock_path, "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)

    def put(self, plan: Plan) -> None:
        self._plans[self._key(plan.fingerprint, plan.kind, plan.k)] = plan.to_json()
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # Merge-then-replace under the lock (ours win ties); the write is
        # an atomic tmp-file + os.replace, so a reader never sees a torn file.
        with self._write_lock():
            try:
                on_disk = self._current(json.loads(self.path.read_text()))
                self._plans = {**on_disk, **self._plans}
            except FileNotFoundError:
                pass  # first writer
            except (json.JSONDecodeError, OSError) as exc:
                self._quarantine(exc)
            fd, tmp = tempfile.mkstemp(
                dir=self.path.parent, prefix=self.path.name, suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(self._plans, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise


_default: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide cache at $REPRO_TORCH_TUNE_CACHE or the default path."""
    global _default
    if _default is None:
        _default = PlanCache(os.environ.get(_ENV_CACHE, _DEFAULT_CACHE))
    return _default

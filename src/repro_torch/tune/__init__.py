"""Autotuned kernel selection — the paper's per-matrix configuration choice.

Pipeline: :mod:`features` (structural predictors) -> :mod:`candidates`
(format x impl x params enumeration + byte-model pruning) ->
:class:`SparseOperator.build` (measured search with the benchmark timer,
plan-cached by structure fingerprint in :mod:`plan`).
"""
from .candidates import (
    BCSR_BLOCKS,
    DEFAULT_PRUNE_FACTOR,
    SELL_SIGMAS,
    Candidate,
    enumerate_candidates,
    estimate_cost,
    make,
    prune,
)
from .features import MatrixFeatures, extract
from .operator import (
    NoSpMMTier,
    PrepCache,
    SparseOperator,
    prepare,
    prepare_cached,
    runner,
    sparse_rhs_runner,
)
from .plan import PLAN_VERSION, Plan, PlanCache, default_cache, fingerprint
from .timing import time_fn

__all__ = [
    "BCSR_BLOCKS",
    "Candidate",
    "DEFAULT_PRUNE_FACTOR",
    "MatrixFeatures",
    "NoSpMMTier",
    "PLAN_VERSION",
    "Plan",
    "PlanCache",
    "PrepCache",
    "SELL_SIGMAS",
    "SparseOperator",
    "default_cache",
    "enumerate_candidates",
    "estimate_cost",
    "extract",
    "fingerprint",
    "make",
    "prepare",
    "prepare_cached",
    "prune",
    "runner",
    "sparse_rhs_runner",
    "time_fn",
]

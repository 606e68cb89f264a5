"""Autotuned kernel selection — the paper's per-matrix configuration choice.

Pipeline: :mod:`features` (structural predictors) -> :mod:`candidates`
(format x impl x params enumeration + byte-model pruning) ->
:class:`SparseOperator.build` (measured search with the benchmark timer,
plan-cached by structure fingerprint in :mod:`plan`).
:meth:`SparseOperator.build_predicted` serves a new fingerprint without the
search, on a plan :mod:`predict` transfers from the cache.
"""
from .candidates import (
    BCSR_BLOCKS,
    DEFAULT_PRUNE_FACTOR,
    MERGE_CHUNKS,
    REORDER_METHODS,
    SCHEDULES,
    SELL_SIGMAS,
    SOLVER_STEP_AMORTIZE,
    SOLVER_VEC_PASSES,
    Candidate,
    bcsr_block_count,
    enumerate_candidates,
    enumerate_mesh_candidates,
    estimate_cost,
    make,
    prune,
    sell_padded_slots,
    split_reorder,
)
from .features import FEATURE_NAMES, MatrixFeatures, extract, feature_vector
from .operator import (
    InaccurateTier,
    NoSpMMTier,
    PrepCache,
    SparseOperator,
    evict_prepared,
    prep_memo_stats,
    prep_nbytes,
    prepare,
    prepare_cached,
    runner,
    solver_step_probe,
    sparse_rhs_runner,
)
from .plan import PLAN_VERSION, Plan, PlanCache, default_cache, fingerprint
from .predict import PREDICT_RADIUS, Prediction, predict_candidate
from .timing import TIMED, WARMUP, time_fn

__all__ = [
    "BCSR_BLOCKS",
    "Candidate",
    "DEFAULT_PRUNE_FACTOR",
    "FEATURE_NAMES",
    "InaccurateTier",
    "MERGE_CHUNKS",
    "MatrixFeatures",
    "NoSpMMTier",
    "PLAN_VERSION",
    "PREDICT_RADIUS",
    "Plan",
    "PlanCache",
    "Prediction",
    "PrepCache",
    "REORDER_METHODS",
    "SCHEDULES",
    "SELL_SIGMAS",
    "SOLVER_STEP_AMORTIZE",
    "SOLVER_VEC_PASSES",
    "SparseOperator",
    "TIMED",
    "WARMUP",
    "bcsr_block_count",
    "default_cache",
    "enumerate_candidates",
    "enumerate_mesh_candidates",
    "estimate_cost",
    "evict_prepared",
    "extract",
    "feature_vector",
    "fingerprint",
    "make",
    "predict_candidate",
    "prep_memo_stats",
    "prep_nbytes",
    "prepare",
    "prepare_cached",
    "prune",
    "runner",
    "sell_padded_slots",
    "solver_step_probe",
    "sparse_rhs_runner",
    "split_reorder",
    "time_fn",
]

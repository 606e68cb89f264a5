"""Optimizers: AdamW with configurable state dtypes."""
from .adamw import (  # noqa: F401
    OptimConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)

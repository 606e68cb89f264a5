"""Optimizers: AdamW with configurable state dtypes, and the int8
error-feedback gradient reduction (``compress``)."""
from .adamw import (  # noqa: F401
    OptimConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)
from .compress import ef_compressed_psum, quantize_int8  # noqa: F401

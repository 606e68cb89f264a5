"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8, head_dim 120) d_ff=10240 vocab=32000,
SWA window 4096.  [arXiv:2401.16818; unverified]
Sub-quadratic (SWA) -> runs the long_500k cell with a ring KV cache.
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    sliding_window=4096,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    arch_id="h2o-danube-3-4b/reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    sliding_window=16,
    attn_chunk=16,
    remat="none",
)

"""deepseek-67b [dense]: llama-arch. 95L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=102400.  [arXiv:2401.02954; hf]
Pure full attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    arch_id="deepseek-67b/reduced",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=320,
    vocab=512,
    attn_chunk=16,
    remat="none",
)

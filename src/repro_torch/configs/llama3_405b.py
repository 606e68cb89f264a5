"""llama3-405b [dense]: GQA, 128k vocab. 126L d_model=16384 128H (kv=8)
d_ff=53248 vocab=128256.  [arXiv:2407.21783; unverified]
Pure full attention -> long_500k skipped.  Training fits 256 chips only
with bf16 optimizer moments (launch/train.py --moment-dtype bf16).
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
)

REDUCED = ModelConfig(
    arch_id="llama3-405b/reduced",
    family="dense",
    n_layers=3,
    d_model=192,
    n_heads=6,
    n_kv_heads=2,
    d_ff=512,
    vocab=768,
    rope_theta=500000.0,
    attn_chunk=16,
    remat="none",
)

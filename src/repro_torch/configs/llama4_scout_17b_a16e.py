"""llama4-scout-17b-a16e [moe]: 16 experts top-1, early fusion, 202k vocab.
48L d_model=5120 40H (GQA kv=8) d_ff(expert)=8192 vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Pure full attention in this config -> long_500k skipped.
"""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192),
    rope_theta=500000.0,
)

REDUCED = ModelConfig(
    arch_id="llama4-scout-17b-a16e/reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff=128),
    attn_chunk=16,
    remat="none",
)

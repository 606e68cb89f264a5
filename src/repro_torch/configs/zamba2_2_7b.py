"""zamba2-2.7b [hybrid]: Mamba2 backbone + ONE shared attention block applied
every 6 layers with per-invocation LoRA.  54L d_model=2560 32H (kv=32,
head_dim 80) d_ff=10240 ssm_state=64.  [arXiv:2411.15242; hf]
O(1) mamba state + few shared-attn KV caches -> runs long_500k.
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    ssm_kind="mamba2",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    hybrid_period=6,
    lora_rank=128,
)

REDUCED = ModelConfig(
    arch_id="zamba2-2.7b/reduced",
    family="hybrid",
    ssm_kind="mamba2",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=16,
    hybrid_period=2,
    lora_rank=8,
    attn_chunk=16,
    remat="none",
)

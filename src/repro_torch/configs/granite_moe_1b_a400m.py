"""granite-moe-1b-a400m [moe]: 32 experts, top-8, tiny expert FFNs.
24L d_model=1024 16H (GQA kv=8) d_ff(expert)=512 vocab=49155 (padded 49408).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
MoE dispatch-as-SpMM is the paper's kernel verbatim (DESIGN.md §4).
"""
from repro_torch.models.lm import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512),
)

REDUCED = ModelConfig(
    arch_id="granite-moe-1b-a400m/reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
    attn_chunk=16,
    remat="none",
)

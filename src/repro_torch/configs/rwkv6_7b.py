"""rwkv6-7b "Finch" [ssm]: attention-free, data-dependent decay.
32L d_model=4096 d_ff=14336 vocab=65536, heads of 64.
[arXiv:2404.05892; hf]   O(1) decode state -> runs long_500k.
The Xeon-Phi paper's attention-sharding aspects are N/A here (DESIGN.md §5);
channel-mix is sparse-FFN capable.
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    ssm_kind="rwkv6",
    n_layers=32,
    d_model=4096,
    n_heads=64,        # = d_model / ssm_head_dim (bookkeeping only)
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    ssm_head_dim=64,
)

REDUCED = ModelConfig(
    arch_id="rwkv6-7b/reduced",
    family="ssm",
    ssm_kind="rwkv6",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=256,
    vocab=512,
    ssm_head_dim=16,
    remat="none",
)

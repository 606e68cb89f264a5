"""qwen1.5-4b [dense]: QKV bias, MHA (kv == heads), 152k vocab.
40L d_model=2560 20H (kv=20, head_dim 128) d_ff=6912 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B; hf]   Pure full attention -> long_500k skipped.
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    attn_bias=True,
    rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    arch_id="qwen1.5-4b/reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    attn_bias=True,
    attn_chunk=16,
    remat="none",
)

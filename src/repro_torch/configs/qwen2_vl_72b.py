"""qwen2-vl-72b [vlm]: M-RoPE (t/h/w position streams), dynamic resolution.
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
[arXiv:2409.12191; hf]
Vision tower STUBBED per spec: input_specs provides precomputed patch
embeddings for the first 256 positions + (3, b, s) M-RoPE position ids.
Pure full attention -> long_500k skipped.
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    n_vision_tokens=256,
    rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    arch_id="qwen2-vl-72b/reduced",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    mrope_sections=(8, 4, 4),
    n_vision_tokens=8,
    attn_chunk=16,
    remat="none",
)

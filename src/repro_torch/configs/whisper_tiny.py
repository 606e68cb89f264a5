"""whisper-tiny [audio]: encoder-decoder; conv frontend STUBBED per spec
(input_specs provides precomputed frame embeddings (b, 1500, 384)).
4L enc + 4L dec, d_model=384 6H (kv=6) d_ff=1536 vocab=51865 (padded 51968).
[arXiv:2212.04356; unverified]
Has a decoder -> decode shapes run; pure full attention -> long_500k skipped
(and 500k positions are far beyond the architecture's design envelope).
"""
from repro_torch.models.lm import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,       # decoder layers
    enc_layers=4,
    enc_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    act="gelu",
)

REDUCED = ModelConfig(
    arch_id="whisper-tiny/reduced",
    family="audio",
    n_layers=2,
    enc_layers=2,
    enc_frames=24,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    norm="layernorm",
    act="gelu",
    attn_chunk=16,
    remat="none",
)

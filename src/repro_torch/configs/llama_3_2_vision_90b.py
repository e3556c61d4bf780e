"""llama-3.2-vision-90b: a dense decoder with gated cross-attention
blocks over image patches.

[hf:meta-llama/Llama-3.2-11B-Vision, scaled] 100 layers, d_model 8192,
64 heads (8 KV heads), d_ff 28672, vocab 128256, rope theta 500000; a
gated cross-attention block after every 5th layer (20 of them) attends
to 1601 patch embeddings, the ``patches`` input of ``prefill`` (the
vision frontend is a stub).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    encoder_seq=1601,
    rope_theta=500000.0,
    remat="full",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    cross_attn_every=2,
    encoder_seq=16,
)

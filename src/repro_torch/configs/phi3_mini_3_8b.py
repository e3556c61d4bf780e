"""phi3-mini-3.8b: dense transformer, RoPE and SwiGLU, as many KV heads
as query heads (MHA).

[arXiv:2404.14219] 32 layers, d_model 3072, 32 heads of 96 (32 KV
heads), d_ff 8192, vocab 32064 (tables padded to 32256).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    remat="full",
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
)

"""qwen3-14b: dense transformer with qk-RMSNorm and GQA.

[hf:Qwen/Qwen3-8B family] 40 layers, d_model 5120, 40 heads (8 KV
heads, so 5 grouped queries per KV head), d_ff 17408, vocab 151936,
RMSNorm on each head's q and k before RoPE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
)

"""kimi-k2-1t-a32b: a trillion-parameter MoE, 384 experts, top-8.

61 layers, d_model 7168, 64 heads (8 KV heads), d_ff 2048 per expert,
vocab 163840, 384 experts of which each token takes 8; about 1.0 T
weights in all, about 32 B of them active per token.  Full attention.
At full size it does not fit one card even packed (about 1 TB in
base3); the port serves it at SMOKE size.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
)

SMOKE = ModelConfig(
    name="kimi-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
)

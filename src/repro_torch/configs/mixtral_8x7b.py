"""mixtral-8x7b: 8 experts, top-2, with sliding-window attention.

[arXiv:2401.04088] 32 layers, d_model 4096, 32 heads (8 KV heads),
d_ff 14336 per expert, vocab 32000, 8 experts of which each token takes
2, attention over a window of 4096 positions.  A cache of capacity at
least the window rolls (slot = position % window), so its KV bytes stay
bounded by the window.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    remat="full",
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    num_experts=4,
    experts_per_token=2,
    sliding_window=16,
)

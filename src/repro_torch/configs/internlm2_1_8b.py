"""internlm2-1.8b: dense transformer with GQA.

[arXiv:2403.17297] 24 layers, d_model 2048, 16 heads (8 KV heads),
d_ff 8192, vocab 92544 (tables padded to 92672).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
)

"""glm4-9b: dense transformer with extreme GQA (2 KV heads).

[hf:THUDM/glm-4-9b] 40 layers, d_model 4096, 32 heads (2 KV heads, so
16 grouped queries per KV head), d_ff 13696 (107 x 128), vocab 151552.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="glm4-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
)

"""zamba2-7b: a Mamba2 backbone with one shared (weight-tied) attention
and MLP block.

[arXiv:2411.15242] 81 Mamba2 layers, d_model 3584, 32 heads (32 KV
heads), d_ff 14336, vocab 32000, SSM state 64.  The shared transformer
block runs after every 6 Mamba2 layers (13 invocations, then a tail of
3 Mamba2 layers), its weights tied across invocations, each invocation
with a KV cache of its own.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_kind="mamba2",
    attn_every=6,
    remat="full",
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=6,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_kind="mamba2",
    attn_every=3,
)

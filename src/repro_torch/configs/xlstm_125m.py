"""xlstm-125m: alternating mLSTM and sLSTM blocks.

[arXiv:2405.04517] 12 layers (6 (mLSTM, sLSTM) pairs), d_model 768, 4
heads, d_ff 0 (the projections are inside the blocks), vocab 50304.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_kind="xlstm",
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=96,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    ssm_kind="xlstm",
)

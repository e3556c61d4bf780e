"""whisper-large-v3: an encoder-decoder transformer over audio frames.

[arXiv:2212.04356] 32 decoder and 32 encoder layers, d_model 1280, 20
heads (20 KV heads), d_ff 5120, vocab 51866.  The conv frontend is a
stub: the encoder takes 1500 frame embeddings (30 s of audio at 50 Hz
after the conv stem) as the ``frames`` input of ``prefill``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder_layers=2,
    encoder_seq=32,
)

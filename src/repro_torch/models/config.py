"""Model configuration and the parameter initialization rule."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio
                                   # | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # RMSNorm of each head's q and k
    sliding_window: int = 0        # 0 = full attention; else a window,
                                   # decoded against a rolling cache
    # MoE (family "moe"): experts routed top-k with per-group capacity
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid (families "ssm" and "hybrid")
    ssm_state: int = 0
    ssm_kind: str = ""             # mamba2 | xlstm
    ssm_heads: int = 0             # mamba2 value heads (0 -> d_model // 64)
    attn_every: int = 0            # hybrid: the shared block after every k
                                   # Mamba2 layers
    slstm_every: int = 0           # xlstm: sLSTM block interval
    # encoder-decoder (family "audio") and cross-attending (family "vlm")
    encoder_layers: int = 0        # whisper: the encoder's blocks
    encoder_seq: int = 0           # positions of the stub frontend's
                                   # frames (audio) or patches (vlm)
    cross_attn_every: int = 0      # vlm: a gated cross-attention block
                                   # after every k self-attention layers
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: str = "none"            # none | full: each layer's activations
                                   # recomputed in the backward pass
    kv_cache_dtype: str = ""       # "" (= dtype) | "int8" (codes + f32
                                   # per-(position, KV head) scales)

    @property
    def sub_quadratic(self) -> bool:
        """Recurrent state or a rolling window: the cache stays bounded
        however long the sequence."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; the embedding and
        unembedding tables use this width."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_model // 64)

    def param_count(self) -> int:
        """Total parameters (the roofline's 6ND bookkeeping)."""
        from . import registry
        return registry.build(self).param_count()

    def active_param_count(self) -> int:
        """Parameters a token runs through (MoE: only its routed
        experts count)."""
        from . import registry
        model = registry.build(self)
        total = model.param_count()
        if not self.num_experts:
            return total
        expert = sum(math.prod(spec.shape) for _, spec in
                     registry._walk(model.param_specs)
                     if "expert" in spec.axes)
        frac = self.experts_per_token / self.num_experts
        return int(total - expert + expert * frac)


class ParamSpec(NamedTuple):
    """A parameter's shape, init style (normal | zeros | ones | embed),
    dtype (None: the model's; the MoE router and the recurrent states
    are f32) and logical axes (one name per dim, those of the
    reference's ``ParamDef``), which ``dist.sharding`` resolves to a
    placement on a mesh."""
    shape: tuple
    init: str = "normal"
    dtype: Any = None
    axes: tuple = ()

    def initialize(self, generator: torch.Generator, device, dtype
                   ) -> torch.Tensor:
        """std 1/sqrt(shape[-2]) (shape[-1] for 1-D), std 1 for the
        embedding table, ones for norms, zeros for biases."""
        dtype = self.dtype or dtype
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        if self.init == "embed":
            fan_in = 1.0
        std = 1.0 / math.sqrt(fan_in)
        draw = torch.randn(self.shape, generator=generator,
                           dtype=torch.float32, device=device)
        # scaled in place: a full-width leaf is held once, not twice
        return draw.mul_(std).to(dtype)

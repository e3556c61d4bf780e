"""Model configuration and the parameter initialization rule."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; the embedding and
        unembedding tables use this width."""
        return -(-self.vocab_size // 256) * 256


class ParamSpec(NamedTuple):
    """A parameter's shape and init style (normal | ones | embed)."""
    shape: tuple
    init: str = "normal"

    def initialize(self, generator: torch.Generator, device, dtype
                   ) -> torch.Tensor:
        """std 1/sqrt(shape[-2]) (shape[-1] for 1-D), std 1 for the
        embedding table, ones for norms."""
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        if self.init == "embed":
            fan_in = 1.0
        std = 1.0 / math.sqrt(fan_in)
        draw = torch.randn(self.shape, generator=generator,
                           dtype=torch.float32, device=device)
        return (draw * std).to(dtype)

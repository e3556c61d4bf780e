"""Shared building blocks, as functions on tensors."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import cim_linear
from ..kernels.ops import PackedTernary


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """rsqrt of the f32 mean square, cast to x's dtype, then multiply."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def dense(x: torch.Tensor, w, cim_cfg: Optional[cim_linear.CIMConfig] = None
          ) -> torch.Tensor:
    """Linear layer through the CIM modes when configured or when `w` is
    packed.  Under a ternary config a float weight is packed on every
    call (the reference's behaviour)."""
    if isinstance(w, PackedTernary):
        cfg = cim_cfg or cim_linear.CIMConfig(mode="ternary")
        return cim_linear.linear(x, w, cfg).to(x.dtype)
    if cim_cfg is not None and cim_cfg.mode != "float":
        return cim_linear.linear(x, w, cim_cfg).to(x.dtype)
    return x @ w


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x: torch.Tensor, w1, w3, w2, cim_cfg=None) -> torch.Tensor:
    """(silu(x @ w1) * (x @ w3)) @ w2."""
    return dense(silu(dense(x, w1, cim_cfg)) * dense(x, w3, cim_cfg), w2,
                 cim_cfg)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,).  Rotates split halves
    (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

"""Shared building blocks, as functions on tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import cim_linear
from ..dist.sharding import constrain_act
from ..kernels.ops import PackedTernary


EMBED_GRAD_ROWS = 1024   # distinct tokens per one-hot product in backward


class _Embed(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each token's rows without
    atomics (:func:`embed_grad`), so a training step is bitwise
    repeatable on the card."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = tuple(table.shape)
        ctx.table_dtype = table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        return embed_grad(grad, tokens, ctx.table_shape,
                          ctx.table_dtype), None


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (any shape) -> tokens.shape + (d,).
    Its gradient is deterministic (:func:`embed_grad`)."""
    return constrain_act(_Embed.apply(table, tokens.long()))


def embed_grad(grad: torch.Tensor, tokens: torch.Tensor, table_shape: tuple,
               dtype) -> torch.Tensor:
    """The embedding table's gradient: for each distinct token (sorted by
    ``torch.unique``), the f32 sum of its positions' output gradients, as
    one-hot products of ``EMBED_GRAD_ROWS`` tokens at a time, cast once to
    the table's dtype; rows of absent tokens are zero.  Neither
    indexing's own backward nor ``index_add_`` promises a repeatable sum
    on the card (``index_add_`` adds with atomics, in an order that
    changes from run to run)."""
    flat = tokens.reshape(-1)
    g = grad.reshape(flat.numel(), -1).to(torch.float32)
    uniq, inverse = torch.unique(flat, sorted=True, return_inverse=True)
    out = torch.zeros(table_shape, dtype=dtype, device=grad.device)
    for s in range(0, uniq.numel(), EMBED_GRAD_ROWS):
        rows = torch.arange(s, min(s + EMBED_GRAD_ROWS, uniq.numel()),
                            device=grad.device)
        onehot = (inverse[None, :] == rows[:, None]).to(torch.float32)
        out[uniq[s:s + EMBED_GRAD_ROWS]] = (onehot @ g).to(dtype)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """rsqrt of the f32 mean square, cast to x's dtype, then multiply."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def dense(x: torch.Tensor, w, cim_cfg: Optional[cim_linear.CIMConfig] = None
          ) -> torch.Tensor:
    """Linear layer through the CIM modes when configured or when `w` is
    packed.  Under a ternary config a float weight is packed on every
    call (the reference's behaviour).  A 3-D input is re-anchored to the
    residual layout (``constrain_act``) first, as in the reference."""
    if x.dim() == 3:
        x = constrain_act(x)
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


def gelu_mlp(x: torch.Tensor, w1, w2, cim_cfg=None) -> torch.Tensor:
    """gelu(x @ w1) @ w2, gelu in its tanh form (``jax.nn.gelu``'s
    default)."""
    return dense(F.gelu(dense(x, w1, cim_cfg), approximate="tanh"), w2,
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


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) f32 table: sin at the even columns, cos at the odd,
    position p at frequency exp(-2i ln(10000) / dim)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe

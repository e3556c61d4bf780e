"""Balanced-ternary codec and the paper's truncating quantization.

Each weight is stored as ``q`` balanced-ternary trits; 5 trits cover
+/-121, slightly less than int8's +/-127, hence "quantize to 8-bit, then
truncate to 5-trit", which clips the rare |w| > 121 codes.

Arithmetic runs in the input's dtype, as the reference does: for a bf16
weight the ``amax / 127`` and ``x / scale`` steps are bf16 operations,
and the packed bytes depend on that.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TRITS_DEFAULT = 5


def trit_range(num_trits: int) -> int:
    """Max magnitude representable by `num_trits` balanced trits."""
    return (3**num_trits - 1) // 2


def to_balanced_ternary(x: torch.Tensor,
                        num_trits: int = TRITS_DEFAULT) -> torch.Tensor:
    """Integer tensor -> (num_trits,) + x.shape int8 trit planes in
    {-1, 0, +1}, least significant first.  Values outside the trit range
    are clipped first (the paper's truncation)."""
    lim = trit_range(num_trits)
    v = torch.clamp(x.to(torch.int32), -lim, lim)
    planes = []
    for _ in range(num_trits):
        d = torch.remainder(v, 3)
        d = torch.where(d == 2, -1, d)
        planes.append(d.to(torch.int8))
        v = torch.div(v - d, 3, rounding_mode="floor")
    return torch.stack(planes, dim=0)


def from_balanced_ternary(trits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_balanced_ternary`; trits (num_trits, ...)."""
    out = torch.zeros(trits.shape[1:], dtype=torch.int32,
                      device=trits.device)
    for i in range(trits.shape[0]):
        out = out + trits[i].to(torch.int32) * (3**i)
    return out


class QuantResult(NamedTuple):
    values: torch.Tensor   # int32 codes
    scale: torch.Tensor    # x ~= values * scale


def quantize_symmetric(x: torch.Tensor, bound: int,
                       axis=None) -> QuantResult:
    """Symmetric linear quantization of float x to [-bound, bound], in
    x's dtype."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / bound
    q = torch.clamp(torch.round(x / scale), -bound, bound).to(torch.int32)
    return QuantResult(q, scale)


def quantize_8b(x: torch.Tensor, axis=None) -> QuantResult:
    return quantize_symmetric(x, 127, axis=axis)


def quantize_8b_truncate_5t(x: torch.Tensor, num_trits: int = TRITS_DEFAULT,
                            axis=None) -> QuantResult:
    """Quantize to 8-bit, then clip the codes into the trit range."""
    q8 = quantize_8b(x, axis=axis)
    lim = trit_range(num_trits)
    return QuantResult(torch.clamp(q8.values, -lim, lim), q8.scale)


class TernaryTensor(NamedTuple):
    trits: torch.Tensor    # int8 (num_trits,) + shape
    scale: torch.Tensor


def ternarize(x: torch.Tensor, num_trits: int = TRITS_DEFAULT,
              axis=None) -> TernaryTensor:
    """Float tensor -> TernaryTensor with the paper's truncating flow."""
    q = quantize_8b_truncate_5t(x, num_trits, axis=axis)
    return TernaryTensor(to_balanced_ternary(q.values, num_trits), q.scale)

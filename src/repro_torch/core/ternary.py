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


def symmetric_scale(x: torch.Tensor, bound: int, axis=None,
                    amax=None) -> torch.Tensor:
    """The scale of :func:`quantize_symmetric`: max(amax |x|, 1e-12) /
    bound, in x's dtype.  ``amax`` (per-tensor only) replaces x's own:
    the whole call's, where x holds one mesh rank's rows of it."""
    if amax is not None:
        if axis is not None:
            raise ValueError("a given amax is per tensor (axis None)")
    elif axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, 1e-12) / bound


def quantize_symmetric(x: torch.Tensor, bound: int,
                       axis=None, amax=None) -> QuantResult:
    """Symmetric linear quantization of float x to [-bound, bound], in
    x's dtype."""
    scale = symmetric_scale(x, bound, axis, amax)
    q = torch.clamp(torch.round(x / scale), -bound, bound).to(torch.int32)
    return QuantResult(q, scale)


def quantize_8b(x: torch.Tensor, axis=None, amax=None) -> QuantResult:
    return quantize_symmetric(x, 127, axis=axis, amax=amax)


def quantize_5t_direct(x: torch.Tensor, num_trits: int = TRITS_DEFAULT,
                       axis=None) -> QuantResult:
    """Scale straight into the +/-121 trit range (Table 3 row 3)."""
    return quantize_symmetric(x, trit_range(num_trits), axis=axis)


def quantize_8b_truncate_5t(x: torch.Tensor, num_trits: int = TRITS_DEFAULT,
                            axis=None, amax=None) -> QuantResult:
    """Quantize to 8-bit, then clip the codes into the trit range."""
    q8 = quantize_8b(x, axis=axis, amax=amax)
    lim = trit_range(num_trits)
    return QuantResult(torch.clamp(q8.values, -lim, lim), q8.scale)


class TernaryTensor(NamedTuple):
    trits: torch.Tensor    # int8 (num_trits,) + shape
    scale: torch.Tensor

    @property
    def num_trits(self) -> int:
        return self.trits.shape[0]

    def dequantize(self) -> torch.Tensor:
        return (from_balanced_ternary(self.trits).to(torch.float32)
                * self.scale)


def ternarize(x: torch.Tensor, num_trits: int = TRITS_DEFAULT, axis=None,
              method: str = "truncate") -> TernaryTensor:
    """Float tensor -> TernaryTensor: 'truncate' (8-bit, then clip; the
    paper's choice) or 'direct' (straight into the trit range)."""
    if method == "truncate":
        q = quantize_8b_truncate_5t(x, num_trits, axis=axis)
    elif method == "direct":
        q = quantize_5t_direct(x, num_trits, axis=axis)
    else:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"['direct', 'truncate']")
    return TernaryTensor(to_balanced_ternary(q.values, num_trits), q.scale)


def encode_inputs(x: torch.Tensor, num_trits: int = TRITS_DEFAULT,
                  axis=None, amax=None) -> TernaryTensor:
    """The macro's ternary input encoding: float activations -> 5-trit
    codes with the truncating flow, in x's dtype."""
    q = quantize_8b_truncate_5t(x, num_trits, axis=axis, amax=amax)
    return TernaryTensor(to_balanced_ternary(q.values, num_trits), q.scale)


# Table 1 signal encodings (used by the macro model):
#   input trit  +1 -> IN1/IN2 = 1/1, 0 -> 1/0, -1 -> 0/0
#   weight trit +1 -> Q1Q2 = 00 (LRS), 0 -> 10 (MRS), -1 -> 11 (HRS)

def input_signals(trit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """trit in {-1, 0, 1} -> (IN1, IN2) int8."""
    return (trit >= 0).to(torch.int8), (trit > 0).to(torch.int8)


def weight_signals(trit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """trit in {-1, 0, 1} -> (Q1, Q2) int8 (00 = +1, 10 = 0, 11 = -1)."""
    return (trit <= 0).to(torch.int8), (trit < 0).to(torch.int8)


def signals_to_weight_trit(q1: torch.Tensor, q2: torch.Tensor
                           ) -> torch.Tensor:
    """(Q1, Q2) -> trit; the inverse of :func:`weight_signals`."""
    return (1 - q1.to(torch.int8) - q2.to(torch.int8)).to(torch.int8)

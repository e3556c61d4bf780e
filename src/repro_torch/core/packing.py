"""Dense trit packing, along the FIRST axis (the contraction axis K).

* ``trit2``: one trit per weight, 2-bit codes, 4 trits per byte,
  little-endian along K.  Codes: 0 -> 0, 1 -> +1, 2 -> -1 (3 unused,
  decodes to 0).
* ``base3``: a whole 5-trit value v in [-121, 121] in one byte as v+121.
"""
from __future__ import annotations

import math

import torch

from .ternary import from_balanced_ternary, to_balanced_ternary, trit_range

TRIT2_PER_BYTE = 4


def pack_trits2(trits: torch.Tensor) -> torch.Tensor:
    """(K, ...) int8 trits -> (K//4, ...) uint8.  K must be a multiple of
    4 (pad upstream)."""
    k = trits.shape[0]
    if k % TRIT2_PER_BYTE:
        raise ValueError(f"K={k} not a multiple of {TRIT2_PER_BYTE}")
    t = trits.to(torch.int32)
    codes = torch.where(t < 0, 2, t)                     # -1 -> 2
    g = codes.reshape((k // TRIT2_PER_BYTE, TRIT2_PER_BYTE)
                      + tuple(trits.shape[1:]))
    out = torch.zeros(g[:, 0].shape, dtype=torch.int32, device=trits.device)
    for i in range(TRIT2_PER_BYTE):
        out = out | (g[:, i] << (2 * i))
    return out.to(torch.uint8)


def unpack_trits2(packed: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Inverse of pack_trits2 -> (K, ...) int8 in {-1, 0, +1}."""
    p = packed.to(torch.int32)
    fields = [(p >> (2 * i)) & 0x3 for i in range(TRIT2_PER_BYTE)]
    codes = torch.stack(fields, dim=1).reshape(
        (packed.shape[0] * TRIT2_PER_BYTE,) + tuple(packed.shape[1:]))
    vals = (codes == 1).to(torch.int8) - (codes == 2).to(torch.int8)
    return vals[:k] if k is not None else vals


def pack_base3(values: torch.Tensor, num_trits: int = 5) -> torch.Tensor:
    """Integer values in [-trit_range, trit_range] -> uint8 value+offset."""
    if 3**num_trits > 256:
        raise ValueError("base3 packing needs 3^q <= 256 (q <= 5)")
    lim = trit_range(num_trits)
    v = torch.clamp(values.to(torch.int32), -lim, lim)
    return (v + lim).to(torch.uint8)


def unpack_base3(packed: torch.Tensor, num_trits: int = 5) -> torch.Tensor:
    """uint8 -> int32 values in [-121, 121]."""
    return packed.to(torch.int32) - trit_range(num_trits)


def pack_trit_planes_base3(trits: torch.Tensor) -> torch.Tensor:
    """(q, K, ...) trit planes -> (K, ...) uint8 base3-packed values."""
    return pack_base3(from_balanced_ternary(trits), trits.shape[0])


def unpack_base3_to_planes(packed: torch.Tensor,
                           num_trits: int = 5) -> torch.Tensor:
    """uint8 base3 -> (q, K, ...) int8 trit planes (the exact CIM path)."""
    return to_balanced_ternary(unpack_base3(packed, num_trits), num_trits)


def packed_bytes(shape: tuple, mode: str, num_trits: int = 5) -> int:
    """Device-memory bytes for a weight of `shape` in a packed mode."""
    n = math.prod(shape)
    if mode == "trit2":
        return n * num_trits // TRIT2_PER_BYTE
    if mode == "base3":
        return n
    if mode == "bf16":
        return 2 * n
    raise ValueError(f"unknown packing mode {mode!r}; expected one of "
                     f"['base3', 'bf16', 'trit2']")

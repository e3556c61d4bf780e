"""Counter-based random draws, bit for bit as ``jax.random`` makes them.

The fault campaigns of the reference draw every channel from
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on, the
default of jax 0.9).  A campaign can be held to the reference only if
the port draws the same numbers, so this module reproduces them:

  key(seed)        -> (seed >> 32, seed & 0xffffffff)
  fold_in(k, d)    -> threefry2x32(k, (0, d))
  split(k, n)[i]   -> threefry2x32(k, (0, i))
  bits(k, shape)   -> y0 ^ y1 of threefry2x32(k, (hi, lo)), where
                      (hi, lo) is each element's 64-bit flat index

so an element's value depends on its flat index only, and a leaf can be
drawn in pieces (:class:`Block`) that equal the same elements of the
whole draw.  ``uniform``, ``bernoulli``, ``randint`` and ``normal``
follow ``jax/_src/random.py`` on those bits: uniform sets the 23
mantissa bits of a float in [1, 2) and subtracts 1; bernoulli is
``uniform < p`` in f32; ``randint`` takes two draws (one per half of
``split(k)``) and combines their remainders, not the modulus of one;
``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
``[nextafter(-1, 0), 1)``; ``normal_bf16`` is the same in bfloat16, which
draws from the 7 bits above each word's lowest (see its docstring).
Only the spans the port draws are
implemented (``uniform`` over 1 or 2, ``randint`` below 2^15); others
raise.

Keys are pairs of Python ints (:class:`Key`), hashed on the host.  The
bulk bits run as torch ops in int32, which wraps on addition like
uint32; right shifts are arithmetic in int32, so every right shift is
masked to a logical one.  On a CUDA device they come from the
``threefry`` kernel instead (``kernels/threefry.py``); these torch ops
are its oracle.

``erfinv`` is XLA's f32 polynomial (the chlo expansion of ``erf_inv``:
``w = -log1p(-x^2)``, a degree-8 polynomial in ``w - 2.5`` or
``sqrt(w) - 3``).  XLA's own ``log1p`` is not torch's, so ``normal``
agrees with ``jax.random.normal`` to a few ulp, not bitwise
(``tests/test_torch_prng.py`` states the bar); every other draw is
bitwise, ``normal_bf16`` too: each of its 128 values, ``erfinv_xla``
rounded to bf16, is jax's (the tests draw all 128).

Every draw runs on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# elements per piece of a CPU draw: the temporaries stay cache-sized
_CPU_PIECE = 1 << 18
# XLA's erf_inv coefficients (f32), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_ERFINV_LT5 = tuple(float(np.float32(c)) for c in _ERFINV_LT5)
_ERFINV_GE5 = tuple(float(np.float32(c)) for c in _ERFINV_GE5)


class Key(NamedTuple):
    """A threefry key: two uint32 words, as Python ints."""
    hi: int
    lo: int


class Block(NamedTuple):
    """Elements of a draw by flat index: ``rows`` runs of ``cols``
    consecutive indices, run ``r`` starting at ``base + r * row_stride``.
    A draw over a block returns a (rows, cols) tensor."""
    base: int
    rows: int
    row_stride: int
    cols: int


def flat_range(start: int, count: int) -> Block:
    """The ``count`` elements from flat index ``start``."""
    return Block(start, 1, 0, count)


# ------------------------------------------------------------- key ops

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k: Key, x0: int, x1: int) -> tuple[int, int]:
    """One threefry2x32 block (20 rounds) of the count pair (x0, x1)."""
    ks = (k.hi, k.lo, k.hi ^ k.lo ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2^64)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2^64); got {seed}")
    return Key(seed >> 32, seed & MASK32)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``, data a uint32."""
    return Key(*threefry2x32(k, 0, int(data) & MASK32))


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``."""
    return [Key(*threefry2x32(k, 0, i)) for i in range(num)]


# ---------------------------------------------------------------- bits

def _i32(v: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    # (x >> (32 - r)) is arithmetic in int32: keep its low r bits only
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry_bits_torch(k: Key, hi: torch.Tensor, lo: torch.Tensor
                        ) -> torch.Tensor:
    """y0 ^ y1 of threefry2x32(k, (hi, lo)) elementwise, int32 in and
    out (the bit patterns of uint32 words): the plain version of the
    ``threefry`` kernel."""
    ks = (_i32(k.hi), _i32(k.lo), _i32(k.hi ^ k.lo ^ _PARITY))
    x0 = hi + ks[0]
    x1 = lo + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl_t(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + _i32((ks[(i + 2) % 3] + i + 1) & MASK32)
    return x0 ^ x1


def _block_indices(blk: Block, device) -> torch.Tensor:
    idx = torch.arange(blk.cols, dtype=torch.int64, device=device)
    if blk.rows > 1:
        starts = blk.base + blk.row_stride * torch.arange(
            blk.rows, dtype=torch.int64, device=device)
        return (starts[:, None] + idx[None, :]).reshape(-1)
    return idx + blk.base


def bits_torch(k: Key, blk: Block, device="cuda") -> torch.Tensor:
    """The plain version of a block's bits: (rows, cols) int32, drawn in
    cache-sized pieces."""
    device = resolve_device(device)
    idx = _block_indices(blk, device)
    out = torch.empty(idx.shape, dtype=torch.int32, device=device)
    piece = _CPU_PIECE if device.type == "cpu" else 1 << 26
    for s in range(0, idx.numel(), piece):
        part = idx[s:s + piece]
        hi = (part >> 32).to(torch.int32)
        lo = (part & MASK32).to(torch.int32)    # wraps past 2^31, as uint32
        out[s:s + piece] = threefry_bits_torch(k, hi, lo)
    return out.reshape(blk.rows, blk.cols)


def _resolve_block(shape, blk: Optional[Block]) -> tuple[Block, tuple]:
    """The block to draw and the shape to return it in."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if blk is None:
        return flat_range(0, n), shape
    last = blk.base + (blk.rows - 1) * blk.row_stride + blk.cols
    if blk.base < 0 or blk.cols < 0 or blk.rows < 1 or last > n:
        raise ValueError(f"block {blk} outside a draw of shape {shape}")
    return blk, (blk.rows, blk.cols) if blk.rows > 1 else (blk.cols,)


def bits(k: Key, shape, device="cuda", block: Optional[Block] = None
         ) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int32 bit patterns, or
    the elements of ``block`` of that draw.  A CUDA device launches the
    ``threefry`` kernel; the CPU runs :func:`bits_torch`."""
    blk, out_shape = _resolve_block(shape, block)
    device = resolve_device(device)
    if device.type == "cuda":
        from ..kernels import threefry
        out = threefry.random_bits(k, blk, device)
    else:
        out = bits_torch(k, blk, device)
    return out.reshape(out_shape)


# --------------------------------------------------------------- draws
# Scalars enter the draws as Python floats that are exact f32 values, so
# every comparison and product is the f32 operation jax does, and no
# scalar is copied to the device (a host-to-device copy waits for the
# stream).

def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1."""
    mant = (b >> 9) & 0x7FFFFF
    return (mant | 0x3F800000).view(torch.float32) - 1.0


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cuda", block: Optional[Block] = None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` for a
    span of 1 or 2 (the port's draws: [0, 1) and ``normal``'s range).
    XLA fuses ``u * span + minval`` into one multiply-add, rounded once;
    at these spans the product is exact in f32, so f32 arithmetic gives
    the same bits.  Another span would need the multiply-add emulated,
    and raises."""
    lo = f32(minval)
    span = f32(np.float32(maxval) - np.float32(minval))
    if span not in (1.0, 2.0):
        raise ValueError(f"uniform draws spans of 1 or 2; got [{minval}, "
                         f"{maxval})")
    u = bits_to_unit(bits(k, shape, device, block))
    return torch.clamp_min(u * span + lo, lo)


def bernoulli(k: Key, p: float, shape, device="cuda",
              block: Optional[Block] = None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: uniform < p in f32."""
    return uniform(k, shape, device=device, block=block) < f32(p)


def _mod_u32(b: torch.Tensor, span: int) -> torch.Tensor:
    """(uint32 bits) % span for span < 2^15, in int32: the word's 16-bit
    halves, hi * (2^16 % span) + lo, stay below 2^31."""
    hi = (b >> 16) & 0xFFFF
    lo = b & 0xFFFF
    return (hi * ((1 << 16) % span) + lo) % span


def randint(k: Key, shape, minval: int, maxval: int, device="cuda",
            block: Optional[Block] = None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, int32)`` for a span
    below 2^15 (the port draws ``randint(-1, 2)``): two draws from
    ``split(k)``, ``(hi % span * m + lo % span) % span`` with ``m = 2^32
    % span``; at such spans every term stays below 2^31 in int32."""
    span = maxval - minval
    if not 0 < span < 1 << 15:
        raise ValueError(f"randint draws spans in [1, 2^15); got "
                         f"[{minval}, {maxval})")
    mult = ((1 << 16) % span) ** 2 % span
    k1, k2 = split(k)
    higher = bits(k1, shape, device, block)
    lower = bits(k2, shape, device, block)
    off = (_mod_u32(higher, span) * mult + _mod_u32(lower, span)) % span
    return off + minval


def _sqrt_rn(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt, as XLA's.  torch's f32 sqrt on the CPU
    is 1 ulp off ``np.sqrt`` at times, and on some hosts a process's first
    vector sqrt came back with a relative error of ~4e-4: two Newton steps
    in f64 from torch's f64 sqrt make the result exact to well under half
    an f32 ulp before the one rounding."""
    wd = w.double()
    s = torch.sqrt(wd)
    for _ in range(2):
        s = 0.5 * (s + wd / s)
    return torch.where(wd > 0, s, torch.sqrt(wd)).float()


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (see the module docstring), +/-inf at
    +/-1.  Each polynomial step ``c + p * w`` is rounded once, as the
    fused multiply-add XLA emits: f64 holds the product of two f32
    exactly."""
    x = x.to(torch.float32)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    tail = ~lt                  # |x| > ~0.9966: a few elements in 1000
    w_tail = w[tail]
    w = w - 2.5
    w[tail] = _sqrt_rn(w_tail) - 3.0
    w = w.double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).double()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, c_lt, c_ge).double()
        p = torch.addcmul(c, p, w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = f32(math.sqrt(2))


def normal(k: Key, shape, device="cuda", block: Optional[Block] = None
           ) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` to a few ulp."""
    u = uniform(k, shape, _NORMAL_LO, 1.0, device, block)
    return _SQRT2 * erfinv_xla(u)


_BF16_LO = -0.99609375          # bf16 nextafter(-1, 0)
_BF16_TABLES: dict = {}


def _normal_bf16_table(device) -> torch.Tensor:
    """The 128 values of ``jax.random.normal(..., bfloat16)``, indexed by
    the 7 bits the draw reads, on ``device``: made once on the host and
    copied, so the card and the CPU read the same values."""
    device = resolve_device(device)
    if device not in _BF16_TABLES:
        bf = torch.bfloat16
        u = (torch.arange(128, dtype=torch.int16) | 0x3F80).view(bf) - 1.0
        lo = torch.tensor(_BF16_LO, dtype=bf)
        u = torch.maximum(lo, u * (torch.tensor(1.0, dtype=bf) - lo) + lo)
        e = erfinv_xla(u.float()).to(bf)
        table = e * torch.tensor(math.sqrt(2), dtype=torch.float64).to(bf)
        _BF16_TABLES[device] = table.to(device)
    return _BF16_TABLES[device]


def normal_bf16(k: Key, shape, device="cuda", block: Optional[Block] = None
                ) -> torch.Tensor:
    """``jax.random.normal(k, shape, bfloat16)``, bitwise.  jax's bf16
    uniform draws 8 random bits (bf16 has 7 mantissa bits): the low byte
    of each element's ``bits`` word; ``(byte >> 1) | 0x3F80`` as a bf16
    in [1, 2), minus 1, mapped to ``[lo, 1)`` in bf16 with ``lo = bf16
    nextafter(-1, 0)`` and held at ``lo`` or above; then ``erf_inv`` in
    f32, rounded to bf16, times bf16 ``sqrt(2)``, rounded again.  The
    result is a function of those 7 bits alone, so it is read from a
    table of its 128 values made by that recipe.  On a CUDA device the
    bits come from the ``threefry`` kernel."""
    b = bits(k, shape, device, block)
    idx = (b & 0xFF) >> 1
    table = _normal_bf16_table(b.device)
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(b.shape)

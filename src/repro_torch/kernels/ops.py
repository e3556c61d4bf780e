"""Packed-weight container, quantizers, and the plain matmul versions.

``ternary_matmul_torch`` and ``ternary_matmul_int8_torch`` are the plain
PyTorch versions of the two CUDA kernels (``kernels/ternary_matmul.py``):
they dequantize the packed weight in device memory and call
``torch.matmul``.  The CPU tests hold them against the reference; on the
card they run only when the ``torch`` backend is named explicitly.
"""
from __future__ import annotations

import torch

from ..core.packing import (TRIT2_PER_BYTE, pack_trit_planes_base3,
                            pack_trits2, unpack_base3, unpack_trits2)
from ..core.ternary import ternarize

PACKINGS = ("base3", "trit2")

# Column sums in pack_weights follow the reference's f32 summation order
# (a sequential sum inside windows of 32 rows, the window sums reduced
# the same way, the row axis zero-padded evenly on both ends), so that
# trit2 scales come out bit-identical and not merely within round-off.
_SUM_WINDOW = 32


class PackedTernary:
    """A weight packed for the ternary matmul kernels.

    data : uint8 (..., K, N) [base3] or (..., ceil(K/4), N) [trit2]
    scale: f32 (..., N), per output column
    mode : 'base3' | 'trit2'
    """

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 mode: str = "base3"):
        self.data = data
        self.scale = scale
        self.mode = mode

    @property
    def kdim(self) -> int:
        k = self.data.shape[-2]
        return k * TRIT2_PER_BYTE if self.mode == "trit2" else k

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape[:-2]) + (self.kdim, self.data.shape[-1])

    def __getitem__(self, i) -> "PackedTernary":
        """Slice the leading (layer) axis of a stacked weight."""
        return PackedTernary(self.data[i], self.scale[i], self.mode)

    def __repr__(self):
        return (f"PackedTernary(mode={self.mode!r}, "
                f"data={tuple(self.data.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def _ordered_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over axis -2 in the reference's order (see _SUM_WINDOW)."""
    x = x.float()
    k = x.shape[-2]
    if k <= _SUM_WINDOW:
        acc = torch.zeros_like(x[..., 0, :])
        for i in range(k):
            acc = acc + x[..., i, :]
        return acc
    nw = -(-k // _SUM_WINDOW)
    pad = nw * _SUM_WINDOW - k
    front = pad // 2
    xp = torch.nn.functional.pad(x, (0, 0, front, pad - front))
    xw = xp.reshape(xp.shape[:-2] + (nw, _SUM_WINDOW, xp.shape[-1]))
    acc = torch.zeros_like(xw[..., 0, :])
    for i in range(_SUM_WINDOW):
        acc = acc + xw[..., i, :]
    return _ordered_sum_rows(acc)


def pack_weights(w: torch.Tensor, mode: str = "base3",
                 num_trits: int = 5) -> PackedTernary:
    """Quantize a float (..., K, N) weight with the paper's truncating
    flow (``num_trits`` trits for base3) and pack it, with per-output-
    column scales.  A base3 byte holds ``v + trit_range(num_trits)``, as
    the reference packs it, while the kernels decode ``byte - 121``: at
    ``num_trits < 5`` the values served are the reference's too.
    Leading (layer stack) axes are kept.  A stacked weight is packed one
    (K, N) matrix at a time into the stacked result: every step is
    per column, so the bytes and scales are those of packing it whole,
    while the temporaries (f32 and int32 copies, five trit planes) stay
    the size of one matrix (qwen3-14b's w1 is 3.6 G weights)."""
    if mode not in PACKINGS:
        raise ValueError(f"unknown packing mode {mode!r}; expected one of "
                         f"{sorted(PACKINGS)}")
    if w.dim() == 2:
        return _pack_matrix(w, mode, num_trits)
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    for i, matrix in enumerate(flat):
        one = _pack_matrix(matrix, mode, num_trits)
        if i == 0:
            data = one.data.new_empty((len(flat),) + tuple(one.data.shape))
            scale = one.scale.new_empty((len(flat),) + tuple(one.scale.shape))
        data[i], scale[i] = one.data, one.scale
    lead = tuple(w.shape[:-2])
    return PackedTernary(data.reshape(lead + tuple(data.shape[1:])),
                         scale.reshape(lead + tuple(scale.shape[1:])), mode)


def _pack_matrix(w: torch.Tensor, mode: str, num_trits: int = 5
                 ) -> PackedTernary:
    """:func:`pack_weights` of one (K, N) matrix."""
    if mode == "base3":
        tt = ternarize(w, num_trits, axis=-2)
        data = pack_trit_planes_base3(tt.trits)          # (..., K, N)
        scale = tt.scale.squeeze(-2)
    else:
        # single-trit weights: w ~ scale * t, threshold 0.75 * mean|w|
        absw = w.abs()
        k = w.shape[-2]
        mean = (_ordered_sum_rows(absw) / k).to(w.dtype).unsqueeze(-2)
        thr = 0.75 * mean
        t = torch.sign(w) * (absw > thr)
        nonzero = torch.clamp_min(
            _ordered_sum_rows(t.abs()).to(w.dtype), 1.0)
        scale = _ordered_sum_rows(absw * t.abs()).to(w.dtype) / nonzero
        kpad = -k % TRIT2_PER_BYTE
        if kpad:
            t = torch.nn.functional.pad(t, (0, 0, 0, kpad))
        tk = torch.movedim(t.to(torch.int8), -2, 0)      # (K, ..., N)
        data = torch.movedim(pack_trits2(tk), 0, -2).contiguous()
    return PackedTernary(data.contiguous(), scale.float().contiguous(), mode)


def quantize_acts_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of activations (..., K):
    x ~ x_int8 * x_scale[..., None].  ``amax / 127`` in f32 (1.0 where
    amax is 0), round half to even, clip to +/-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    x_scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    xi = torch.clamp(torch.round(xf / x_scale[..., None]), -127, 127)
    return xi.to(torch.int8), x_scale


# ------------------------------------------------------ plain versions

def decode_weight(w: PackedTernary, dtype) -> torch.Tensor:
    """Packed weight -> (..., K', N) integer values in `dtype`, no scale
    (K' is the packed K: trit2 rounds K up to a multiple of 4)."""
    if w.mode == "base3":
        return unpack_base3(w.data).to(dtype)
    k_first = unpack_trits2(torch.movedim(w.data, -2, 0))
    return torch.movedim(k_first, 0, -2).to(dtype)


def ternary_matmul_torch(x: torch.Tensor, w: PackedTernary) -> torch.Tensor:
    """x (..., K) @ packed w -> (..., N) f32: dequantize (values times
    the column scale) in f32, then a full-f32 matmul."""
    wd = decode_weight(w, torch.float32) * w.scale.float()[..., None, :]
    wd = wd[..., : x.shape[-1], :]
    return torch.matmul(x.float(), wd)


def ternary_matmul_int8_torch(x_int: torch.Tensor, x_scale: torch.Tensor,
                              w: PackedTernary) -> torch.Tensor:
    """Int domain: exact integer dot, then ``acc * x_scale * scale`` in
    f32, in that order.  The dot runs in f64, where every partial sum of
    int8 x int8 products over K < 2^37 is an exact integer, so any
    summation order gives the same int32 accumulator on any device."""
    wd = decode_weight(w, torch.float64)[..., : x_int.shape[-1], :]
    acc = torch.matmul(x_int.to(torch.float64), wd).to(torch.int32)
    return (acc.float() * x_scale.float()[..., None]
            * w.scale.float()[..., None, :])

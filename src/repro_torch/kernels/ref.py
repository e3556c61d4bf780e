"""Oracles of the kernels: unpack, then matmul; the macro model for
``cim_mac``."""
from __future__ import annotations

import torch

from ..core import cim as cim_core
from ..core.packing import unpack_base3, unpack_trits2


def _unpack(w_packed: torch.Tensor, mode: str, k=None) -> torch.Tensor:
    if mode == "base3":
        return unpack_base3(w_packed)
    if mode == "trit2":
        return unpack_trits2(w_packed, k=k).to(torch.int32)
    raise ValueError(f"unknown packing mode {mode!r}; expected one of "
                     f"['base3', 'trit2']")


def ternary_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor, mode: str = "base3"
                       ) -> torch.Tensor:
    """Oracle for the float-domain kernel: f32 unpack-then-matmul, the
    column scale applied after the full K."""
    w = _unpack(w_packed, mode).float()
    return (x.float() @ w) * torch.as_tensor(scale, dtype=torch.float32,
                                             device=w.device)


def ternary_matmul_int8_ref(x_int: torch.Tensor, x_scale: torch.Tensor,
                            w_packed: torch.Tensor, scale: torch.Tensor,
                            mode: str = "trit2") -> torch.Tensor:
    """Oracle for the int-domain kernel: exact integer accumulation of
    int8 activations against the unpacked weight (int64 on the CPU), then
    ``acc * x_scale * scale`` in f32."""
    w = _unpack(w_packed, mode, k=x_int.shape[-1]).to(torch.int64)
    acc = (x_int.to(torch.int64).cpu() @ w.cpu()).to(x_int.device)
    n = w.shape[-1]
    return (acc.to(torch.int32).float()
            * torch.as_tensor(x_scale, dtype=torch.float32,
                              device=x_int.device)[..., None]
            * torch.as_tensor(scale, dtype=torch.float32,
                              device=x_int.device).expand(n)[None, :])


def cim_mac_ref(x_trits: torch.Tensor, w_trits: torch.Tensor,
                adc_bits: int = 5) -> torch.Tensor:
    """Oracle for the cim_mac kernel: the functional macro model,
    (qi, M, K) x (qw, K, N) trit planes -> (M, N) int32."""
    cfg = cim_core.MacroConfig(adc_bits=adc_bits)
    return cim_core.cim_matmul_int(x_trits, w_trits, cfg)

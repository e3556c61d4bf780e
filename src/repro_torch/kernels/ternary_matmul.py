"""Wrappers of the two hand-written CUDA kernels (``csrc/ternary_matmul.cu``).

* :func:`matmul_float` replaces the Pallas kernel ``_kernel`` of
  ``src/repro/kernels/ternary_matmul.py`` (``ternary_matmul``):
  ``y = (x @ decode(w)) * scale`` with f32 accumulation, x f32 or bf16.
* :func:`matmul_int8` replaces ``_kernel_int8`` (``ternary_matmul_int8``):
  exact int32 accumulation of int8 activations, then
  ``acc * x_scale[m] * scale[n]`` in f32; bitwise equal to the plain
  version.

Bound on an H100: at decode (M <= 8) the packed weight bytes at
3.35 TB/s; at prefill the multiply-adds.  Decode takes a weight-streaming
kernel that reads each packed byte once per call; larger M takes a tiled
kernel that reads it once per 8-row tile.  Both decode bytes in
registers, and K is split across blocks when the output tiles alone
cannot fill the SMs (see the source note in the .cu file).

On a CPU tensor a wrapper computes its plain version (``kernels/ops.py``);
on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches per wrapper, so a run can show that it went through them.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.packing import TRIT2_PER_BYTE
from . import ops

BLOCK_N = 128            # output columns per block (kBN in the source)
BLOCK_M = 8              # rows per block (kBM)
K_CHUNK = 64             # packed rows per split unit (kKC K rows)
MODE_CODE = {"base3": 0, "trit2": 1}
SOURCE = "ternary_matmul.cu"      # under src/repro_torch/csrc/

LAUNCHES = {"ternary_matmul": 0, "ternary_matmul_int8": 0}

_SM_COUNT: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def split_k(m: int, k: int, n: int, mode: str,
            sm_count: int) -> tuple[int, int]:
    """(splits, k_per_split): split K across blocks until the grid holds
    about as many blocks as the SMs hold at once (three per SM for the
    decode kernel of M <= 8, two for the tiled one).  A split is a whole
    number of chunks of 64 packed rows (64 K rows of base3, 256 of
    trit2), so a block streams the same bytes in either packing."""
    tiles = -(-n // BLOCK_N) * -(-m // BLOCK_M)
    unit = K_CHUNK * (TRIT2_PER_BYTE if mode == "trit2" else 1)
    chunks = max(1, -(-k // unit))
    per_sm = 3 if m <= BLOCK_M else 2
    want = max(1, -(-per_sm * sm_count // tiles))
    splits = min(chunks, want)
    per = -(-chunks // splits)
    return -(-chunks // per), per * unit


def _check(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
           mode: str, x_dtypes: tuple) -> tuple[int, int, int]:
    if mode not in MODE_CODE:
        raise ValueError(f"unknown packing mode {mode!r}; expected one of "
                         f"{sorted(MODE_CODE)}")
    if x.dim() != 2 or data.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"need x (M, K), packed w (K', N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(data.shape)}, "
                         f"{tuple(scale.shape)}")
    m, k = x.shape
    kw, n = data.shape
    kwant = k // TRIT2_PER_BYTE if mode == "trit2" else k
    if (mode == "trit2" and k % TRIT2_PER_BYTE) or kw != kwant:
        raise ValueError(f"x K={k} does not match {mode} weight rows {kw} "
                         f"(trit2 needs x zero-padded to a multiple of 4)")
    if scale.shape[0] != n:
        raise ValueError(f"scale has {scale.shape[0]} entries, N={n}")
    if x.dtype not in x_dtypes:
        raise TypeError(f"x dtype {x.dtype} not in {x_dtypes}")
    if data.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"need uint8 weight and f32 scale, got {data.dtype}, "
                        f"{scale.dtype}")
    return m, k, n


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _vec(data: torch.Tensor, n: int) -> int:
    """32-bit weight loads need 4-byte aligned rows."""
    return int(n % 4 == 0 and data.data_ptr() % 4 == 0)


def _lib():
    """The kernels' library, built at first use, with its C signatures."""
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tm_float_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i,
                                        i, p]
        lib.tm_float_launch.restype = i
        lib.tm_int8_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       i, p]
        lib.tm_int8_launch.restype = i
        lib._typed = True
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def matmul_float(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """(M, K) f32/bf16 @ packed (K | K/4, N) -> (M, N) f32."""
    m, k, n = _check(x, data, scale, mode, (torch.float32, torch.bfloat16))
    if x.device.type == "cpu":
        return ops.ternary_matmul_torch(x, ops.PackedTernary(data, scale,
                                                             mode))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, data, scale)
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits, per = split_k(m, k, n, mode, _sm_count(x.device))
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tm_float_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), data.data_ptr(),
        scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, MODE_CODE[mode], splits, per, _vec(data, n), stream)
    _raise_on(err, "ternary_matmul")
    LAUNCHES["ternary_matmul"] += 1
    return out


def matmul_int8(x_int: torch.Tensor, x_scale: torch.Tensor,
                data: torch.Tensor, scale: torch.Tensor,
                mode: str) -> torch.Tensor:
    """(M, K) int8 with (M,) f32 row scales @ packed weight -> (M, N) f32."""
    m, k, n = _check(x_int, data, scale, mode, (torch.int8,))
    if x_scale.shape != (m,) or x_scale.dtype != torch.float32:
        raise ValueError(f"x_scale must be ({m},) f32, got "
                         f"{tuple(x_scale.shape)} {x_scale.dtype}")
    if x_int.device.type == "cpu":
        return ops.ternary_matmul_int8_torch(
            x_int, x_scale, ops.PackedTernary(data, scale, mode))
    if x_int.device.type != "cuda":
        raise ValueError(f"unsupported device {x_int.device}")
    _check_cuda(x_int, x_scale, data, scale)
    lib = _lib()
    out = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    splits, per = split_k(m, k, n, mode, _sm_count(x_int.device))
    partial = (torch.empty((splits, m, n), dtype=torch.int32,
                           device=x_int.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x_int.device).cuda_stream
    err = lib.tm_int8_launch(
        x_int.data_ptr(), x_scale.data_ptr(), data.data_ptr(),
        scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, MODE_CODE[mode], splits, per, _vec(data, n), stream)
    _raise_on(err, "ternary_matmul_int8")
    LAUNCHES["ternary_matmul_int8"] += 1
    return out

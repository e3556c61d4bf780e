"""Random bits for the fault campaigns: ``csrc/threefry.cu``.

:func:`random_bits` writes the threefry2x32 bits that ``jax.random``
draws (``core/prng.py`` documents the layout) for a key and a
:class:`~repro_torch.core.prng.Block` of flat indices.  It is not a port
of a Pallas kernel but of XLA's lowering of ``jax.random``'s threefry,
which the reference's fault channels draw from; one full-tree draw of
internlm2-1.8b's packed weights is 8.5e9 evaluations, a chunk's drift
three of them.  Bound on an H100 by its integer operations (~73 a word;
see the source).  Uniform, Bernoulli and randint stay torch ops on its
bits (``core/prng.py``).

On a CPU device the wrapper computes the plain version,
``prng.bits_torch``; on a CUDA device it launches the kernel or raises.
``LAUNCHES`` counts launches, so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "threefry.cu"            # under src/repro_torch/csrc/
OPS_PER_WORD = 73                 # int32 operations the kernel does a word

LAUNCHES = {"threefry": 0}


def reset_launches() -> None:
    LAUNCHES["threefry"] = 0


def _lib():
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        u32, i64, p = ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p
        lib.threefry_bits_launch.argtypes = [u32, u32, ctypes.c_uint64, i64,
                                             i64, i64, p, p]
        lib.threefry_bits_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def random_bits(key, blk, device) -> torch.Tensor:
    """(rows, cols) int32 bit patterns of threefry2x32(key, flat index)
    over the block ``blk`` (``core.prng.Block``)."""
    device = torch.device(device)
    if device.type == "cpu":
        from ..core.prng import bits_torch
        return bits_torch(key, blk, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((blk.rows, blk.cols), dtype=torch.int32,
                      device=device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _lib().threefry_bits_launch(
            key.hi, key.lo, blk.base, blk.rows, blk.row_stride, blk.cols,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry CUDA launch failed: error {err} "
                           f"({torch.cuda.get_device_name(device)})")
    LAUNCHES["threefry"] += 1
    return out

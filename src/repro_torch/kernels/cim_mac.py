"""The macro-exact ternary CIM MAC (``csrc/cim_mac.cu``).

:func:`cim_mac` replaces the Pallas kernel ``_kernel`` of
``src/repro/kernels/cim_mac.py`` (``cim_mac``)::

    (qi, M, K) int8 x (qw, K, N) int8 trit planes -> (M, N) int32
    out = sum_ij 3^(i+j) sum_g (r_g - clamp(r_g - mac_ij[g], 0, 2^b - 1))

where K is cut into groups of 16 rows, ``r_g`` is the number of real rows
of group g and ``mac_ij[g]`` the group's MAC of input plane i against
weight plane j: the 16-row CBL sense and the b-bit ADC of the
TL-nvSRAM-CIM array, then the shift-and-add.  Its semantics are those of
the macro model ``core.cim.cim_matmul_int`` (the kernel's oracle), which
equals the Pallas kernel at b = 5; for b <= 4 with K not a multiple of 16
the Pallas kernel's padded groups do not (``ROADMAP.md``, queue 3).

Bound on an H100: at decode (M = 8) the 5 weight-plane bytes per weight
at 3.35 TB/s; at prefill the 25 plane-pair MACs (the int8 tensor-core
rate; this kernel runs them as dp4a on the CUDA cores).

:func:`cim_mac_torch` is the plain version, the oracle itself.  On a CPU
tensor the wrapper computes it; on a CUDA tensor it launches the kernel
or raises.  ``LAUNCHES`` counts kernel launches, so a run can show that
it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

ROWS_PER_GROUP = 16
MAX_PLANES = 5           # kMaxPlanes in the source
STAGE_GROUPS = 2         # kStage: groups a block stages per step
DECODE_TILE = (8, 256)   # (BM, BN) for M <= 8
PREFILL_TILE = (64, 64)  # (BM, BN) otherwise
BLOCKS_PER_SM = 4        # split K until the grid holds about this many
SOURCE = "cim_mac.cu"    # under src/repro_torch/csrc/

LAUNCHES = {"cim_mac": 0}

_SM_COUNT: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def cim_mac_torch(x_trits: torch.Tensor, w_trits: torch.Tensor,
                  adc_bits: int = 5) -> torch.Tensor:
    """The plain version: the oracle, the macro model ``cim_matmul_int``."""
    return ref.cim_mac_ref(x_trits, w_trits, adc_bits)


def split_groups(m: int, k: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits, groups per split): split K's 16-row groups across blocks
    until the grid holds about ``BLOCKS_PER_SM`` blocks per SM; a split
    is a whole number of staged steps."""
    bm, bn = DECODE_TILE if m <= DECODE_TILE[0] else PREFILL_TILE
    tiles = -(-n // bn) * -(-m // bm)
    groups = -(-k // ROWS_PER_GROUP)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // tiles))
    per = -(-groups // min(groups, want))
    per = -(-per // STAGE_GROUPS) * STAGE_GROUPS
    return -(-groups // per), per


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _lib():
    """The kernel's library, built at first use, with its C signature."""
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cim_mac_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                       i, p]
        lib.cim_mac_launch.restype = i
        lib._typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, adc_bits: int
           ) -> tuple[int, int, int, int, int]:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (qi, M, K) and w (qw, K, N) trit planes; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    qi, m, k = (int(d) for d in x.shape)
    qw, k2, n = (int(d) for d in w.shape)
    if k != k2:
        raise ValueError(f"x has K={k} rows of trits, w has {k2}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"trit planes must be int8, got {x.dtype}, "
                        f"{w.dtype}")
    if not (1 <= qi <= MAX_PLANES and 1 <= qw <= MAX_PLANES):
        raise ValueError(f"{qi} x {qw} trit planes; the kernel takes 1 to "
                         f"{MAX_PLANES} of each")
    if not 1 <= adc_bits <= 30:
        raise ValueError(f"adc_bits={adc_bits} outside [1, 30]")
    return qi, m, k, qw, n


def cim_mac(x_trits: torch.Tensor, w_trits: torch.Tensor,
            adc_bits: int = 5) -> torch.Tensor:
    """(qi, M, K) int8 x (qw, K, N) int8 trit planes -> (M, N) int32."""
    qi, m, k, qw, n = _check(x_trits, w_trits, adc_bits)
    if x_trits.device.type == "cpu":
        return cim_mac_torch(x_trits, w_trits, adc_bits)
    if x_trits.device.type != "cuda":
        raise ValueError(f"unsupported device {x_trits.device}")
    if w_trits.device != x_trits.device:
        raise ValueError(f"operands on {w_trits.device} and "
                         f"{x_trits.device}")
    if not (x_trits.is_contiguous() and w_trits.is_contiguous()):
        raise ValueError("cim_mac operands must be contiguous")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x_trits.device)
    lib = _lib()
    splits, per = split_groups(m, k, n, _sm_count(x_trits.device))
    # split blocks add their partial sums into a zeroed output
    out = (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=x_trits.device)
    xvec = int(k % 4 == 0 and x_trits.data_ptr() % 4 == 0)
    wvec = int(n % 4 == 0 and w_trits.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(x_trits.device).cuda_stream
    err = lib.cim_mac_launch(x_trits.data_ptr(), w_trits.data_ptr(),
                             out.data_ptr(), qi, qw, m, k, n, adc_bits,
                             splits, per, xvec, wvec, stream)
    if err != 0:
        raise RuntimeError(f"cim_mac CUDA launch failed: error {err} "
                           f"({torch.cuda.get_device_name(x_trits.device)})")
    LAUNCHES["cim_mac"] += 1
    return out

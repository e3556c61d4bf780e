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

Two routes, chosen by :func:`route` from the ADC width b:

* ``codes`` (b >= 5).  Since ``mac <= r_g``, each group adds
  ``mac + relu(r_g - C - mac)`` with ``C = 2^b - 1``, and summed with the
  powers of 3 the mac part is one product ``X @ W`` of the 5-trit codes
  ``X = sum_i 3^i x_i`` and ``W = sum_j 3^j w_j`` in [-121, 121]: the
  int8 routes of ``ternary_matmul_int8`` with an int32 epilogue
  (``ternary_matmul.launch_int32``) on base3 bytes ``W + 121``.  The
  correction is 0 for b >= 6; at b = 5 it is ``3^(i+j)`` for each full
  group whose 16 products are all -1 (x_i's digits all non-zero, w_j's
  their negation), which ``cim_correct_kernel`` adds from the weight's
  :func:`full_groups` lists.  Bound: one int8 product, 1 byte per weight.
* ``groups`` (b <= 4, where the clip bites almost everywhere): the dense
  per-group kernel ``cim_mac_kernel`` on the trit planes.  Bound: the 5
  plane bytes per weight at decode, the 25 plane-pair MACs at prefill.

Two entry points, one function: :func:`cim_mac` keeps the Pallas
kernel's interface (trit planes; at b >= 5 it folds them into codes and
base3 bytes, one small pass, and takes the code route), and
:func:`cim_mac_codes` takes what the exact path holds: (M, K) int8 codes
against a :class:`CodeWeight` (base3 bytes and the full-group lists,
made once per weight by the cuda backend's cache).

:func:`cim_mac_torch` is the plain version, the oracle itself, and
:func:`cim_mac_codes_torch` the oracle on the codes' planes.  On a CPU
tensor the wrappers compute them; on a CUDA tensor they launch their
route's kernels or raise.  ``LAUNCHES`` counts calls that launched,
``ROUTES`` the route each took, so a run can show that it went through
the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.ternary import (from_balanced_ternary, to_balanced_ternary,
                            trit_range)
from . import ref
from . import ternary_matmul as tm

ROWS_PER_GROUP = 16
MAX_PLANES = 5           # kMaxPlanes in the source
TRIT_RANGE = trit_range(MAX_PLANES)   # 121: codes in [-121, 121]
CODES_MIN_BITS = 5       # the code route serves b >= 5 ...
CORRECTED_BITS = 5       # ... and adds the saturation correction at 5
STAGE_GROUPS = 2         # kStage: groups a block stages per step
DECODE_TILE = (8, 256)   # (BM, BN) of the groups route for M <= 8
PREFILL_TILE = (64, 64)  # (BM, BN) otherwise
BLOCKS_PER_SM = 4        # split K until the grid holds about this many
SOURCE = "cim_mac.cu"    # under src/repro_torch/csrc/

LAUNCHES = {"cim_mac": 0}
ROUTES = {"codes": 0, "groups": 0}

_SM_COUNT: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def route(adc_bits: int) -> str:
    """The kernel route of a b-bit ADC on the card."""
    return "codes" if adc_bits >= CODES_MIN_BITS else "groups"


class FullGroups(NamedTuple):
    """Per full 16-row group g of a weight, the columns with a weight
    plane whose 16 trits are all non-zero: ``entries[offsets[g]:
    offsets[g + 1]]``, each row ``(n, p0 | p1 << 16, p2 | p3 << 16,
    p4 | planes << 16)`` in int32, where bit j of ``planes`` says plane j
    is full and ``pj`` is then its 16 rows' negative mask (bit r: row r
    is -1), else 0."""
    offsets: torch.Tensor      # (K // 16 + 1,) int32
    entries: torch.Tensor      # (E, 4) int32


class CodeWeight(NamedTuple):
    """What the code route reads of a weight: its base3 bytes (5-trit
    code + 121) and its :class:`FullGroups`."""
    data: torch.Tensor         # (K, N) uint8
    groups: FullGroups


def _pack16(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo | hi << 16 of 16-bit values, as the int32 of those 32 bits."""
    v = lo.to(torch.int64) | (hi.to(torch.int64) << 16)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def full_groups(w_trits: torch.Tensor) -> FullGroups:
    """The :class:`FullGroups` lists of (qw, K, N) trit planes."""
    qw, k, n = (int(d) for d in w_trits.shape)
    g = k // ROWS_PER_GROUP
    dev = w_trits.device
    t = w_trits[:, :g * ROWS_PER_GROUP].reshape(qw, g, ROWS_PER_GROUP, n)
    planes = torch.zeros((g, n), dtype=torch.int32, device=dev)
    pats = []
    for j in range(MAX_PLANES):
        pat = torch.zeros((g, n), dtype=torch.int32, device=dev)
        if j < qw:
            full = (t[j] != 0).all(dim=1)
            for r in range(ROWS_PER_GROUP):
                pat |= (t[j, :, r] < 0).to(torch.int32) << r
            pat = torch.where(full, pat, 0)
            planes |= full.to(torch.int32) << j
        pats.append(pat)
    gi, ni = torch.nonzero(planes, as_tuple=True)
    entries = torch.stack(
        [ni.to(torch.int32),
         _pack16(pats[0][gi, ni], pats[1][gi, ni]),
         _pack16(pats[2][gi, ni], pats[3][gi, ni]),
         _pack16(pats[4][gi, ni], planes[gi, ni])], dim=1).contiguous()
    offsets = torch.zeros(g + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(gi, minlength=g), 0)
    return FullGroups(offsets, entries)


def code_weight(w_trits: torch.Tensor) -> CodeWeight:
    """(qw, K, N) trit planes -> the code route's :class:`CodeWeight`."""
    data = (from_balanced_ternary(w_trits) + TRIT_RANGE).to(torch.uint8)
    return CodeWeight(data, full_groups(w_trits))


def cim_mac_torch(x_trits: torch.Tensor, w_trits: torch.Tensor,
                  adc_bits: int = 5) -> torch.Tensor:
    """The plain version: the oracle, the macro model ``cim_matmul_int``."""
    return ref.cim_mac_ref(x_trits, w_trits, adc_bits)


def cim_mac_codes_torch(x_codes: torch.Tensor, w: CodeWeight,
                        adc_bits: int = 5) -> torch.Tensor:
    """The plain version of the code entry: the oracle on the 5 trit
    planes of the codes and of the base3 bytes (b >= 5, where the planes
    past a value's own add nothing)."""
    w_codes = w.data.to(torch.int32) - TRIT_RANGE
    return cim_mac_torch(to_balanced_ternary(x_codes, MAX_PLANES),
                         to_balanced_ternary(w_codes, MAX_PLANES), adc_bits)


def correction_torch(x_trits: torch.Tensor, w_trits: torch.Tensor,
                     adc_bits: int) -> torch.Tensor:
    """What the clip adds to the product of the codes, in plain torch:
    ``sum_ij 3^(i+j) sum_g relu(r_g - C - mac_ij[g])`` -> (M, N) int64.
    0 for b >= 6; at b = 5 one ``3^(i+j)`` per saturated full group."""
    qi, m, k = x_trits.shape
    qw, _, n = w_trits.shape
    g = -(-k // ROWS_PER_GROUP)
    pad = g * ROWS_PER_GROUP - k
    xg = torch.nn.functional.pad(x_trits, (0, pad)).reshape(
        qi, m, g, ROWS_PER_GROUP).to(torch.float32)
    wg = torch.nn.functional.pad(w_trits, (0, 0, 0, pad)).reshape(
        qw, g, ROWS_PER_GROUP, n).to(torch.float32)
    rows = torch.clamp(k - torch.arange(g, device=x_trits.device)
                       * ROWS_PER_GROUP, 0, ROWS_PER_GROUP)
    lo = (rows - (2**adc_bits - 1)).to(torch.float32)[:, None, None]
    out = torch.zeros((m, n), dtype=torch.int64, device=x_trits.device)
    for i in range(qi):
        for j in range(qw):
            mac = torch.einsum("mgr,grn->gmn", xg[i], wg[j])   # exact
            out += 3**(i + j) * torch.relu(lo - mac).sum(0).to(torch.int64)
    return out


def split_groups(m: int, k: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits, groups per split) of the groups route: split K's 16-row
    groups across blocks until the grid holds about ``BLOCKS_PER_SM``
    blocks per SM; a split is a whole number of staged steps."""
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
    """The kernels' library, built at first use, with its C signatures."""
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cim_mac_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                       i, p]
        lib.cim_mac_launch.restype = i
        lib.cim_correct_launch.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.cim_correct_launch.restype = i
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


def _check_device(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("cim_mac operands must be contiguous")


def _raise_on(err: int, what: str, dev: torch.device) -> None:
    if err != 0:
        raise RuntimeError(f"cim_mac {what} CUDA launch failed: error {err} "
                           f"({torch.cuda.get_device_name(dev)})")


def _launch_groups(x: torch.Tensor, w: torch.Tensor, adc_bits: int
                   ) -> torch.Tensor:
    qi, m, k = x.shape
    qw, _, n = w.shape
    splits, per = split_groups(m, k, n, _sm_count(x.device))
    # split blocks add their partial sums into a zeroed output
    out = (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=x.device)
    xvec = int(k % 4 == 0 and x.data_ptr() % 4 == 0)
    wvec = int(n % 4 == 0 and w.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(_lib().cim_mac_launch(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), qi, qw, m, k, n,
                                    adc_bits, splits, per, xvec, wvec,
                                    stream), "groups", x.device)
    return out


def _launch_codes(x: torch.Tensor, w: CodeWeight, adc_bits: int
                  ) -> torch.Tensor:
    m, k = x.shape
    n = w.data.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _raise_on(tm.launch_int32(x, w.data, "base3", out), "product",
              x.device)
    offsets, entries = w.groups
    if adc_bits == CORRECTED_BITS and entries.shape[0] > 0:
        xvec = int(k % 16 == 0 and x.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(_lib().cim_correct_launch(
            x.data_ptr(), offsets.data_ptr(), entries.data_ptr(),
            out.data_ptr(), m, k, n, xvec, stream), "correction", x.device)
    return out


def _count(path: str) -> None:
    LAUNCHES["cim_mac"] += 1
    ROUTES[path] += 1


def cim_mac(x_trits: torch.Tensor, w_trits: torch.Tensor,
            adc_bits: int = 5) -> torch.Tensor:
    """(qi, M, K) int8 x (qw, K, N) int8 trit planes -> (M, N) int32."""
    qi, m, k, qw, n = _check(x_trits, w_trits, adc_bits)
    if x_trits.device.type == "cpu":
        return cim_mac_torch(x_trits, w_trits, adc_bits)
    _check_device(x_trits, w_trits)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x_trits.device)
    path = route(adc_bits)
    if path == "codes":
        x_codes = from_balanced_ternary(x_trits).to(torch.int8)
        out = _launch_codes(x_codes, code_weight(w_trits), adc_bits)
    else:
        out = _launch_groups(x_trits, w_trits, adc_bits)
    _count(path)
    return out


def cim_mac_codes(x_codes: torch.Tensor, w: CodeWeight,
                  adc_bits: int = 5) -> torch.Tensor:
    """(M, K) int8 codes in [-121, 121] x a :class:`CodeWeight` of K x N
    -> (M, N) int32, at b >= 5 (the code route)."""
    if x_codes.dim() != 2 or w.data.dim() != 2:
        raise ValueError(f"need x codes (M, K) and base3 bytes (K, N); got "
                         f"{tuple(x_codes.shape)}, {tuple(w.data.shape)}")
    m, k = (int(d) for d in x_codes.shape)
    k2, n = (int(d) for d in w.data.shape)
    if k != k2:
        raise ValueError(f"x has K={k} codes a row, w has {k2} rows")
    if x_codes.dtype != torch.int8 or w.data.dtype != torch.uint8:
        raise TypeError(f"need int8 codes and uint8 base3 bytes, got "
                        f"{x_codes.dtype}, {w.data.dtype}")
    if not CODES_MIN_BITS <= adc_bits <= 30:
        raise ValueError(f"adc_bits={adc_bits}: the code entry takes "
                         f"{CODES_MIN_BITS} to 30 bits")
    if x_codes.device.type == "cpu":
        return cim_mac_codes_torch(x_codes, w, adc_bits)
    _check_device(x_codes, w.data, *w.groups)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x_codes.device)
    out = _launch_codes(x_codes, w, adc_bits)
    _count("codes")
    return out

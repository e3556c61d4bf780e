"""Wrappers of the hand-written CUDA kernels of ``csrc/ternary_matmul.cu``.

* :func:`matmul_float` replaces the Pallas kernel ``_kernel`` of
  ``src/repro/kernels/ternary_matmul.py`` (``ternary_matmul``):
  ``y = (x @ decode(w)) * scale`` with f32 accumulation, x f32 or bf16.
* :func:`matmul_int8` replaces ``_kernel_int8`` (``ternary_matmul_int8``):
  exact int32 accumulation of int8 activations, then
  ``acc * x_scale[m] * scale[n]`` in f32; bitwise equal to the plain
  version.  :func:`launch_int32` runs the same two routes with an int32
  epilogue (the exact sums, no scales): the product term of the
  macro-exact ``cim_mac``'s code route (``kernels/cim_mac.py``).

Three routes, chosen by :func:`route` from M and the dtype of x:

* ``gemv`` (M <= 8, bf16 or int8 x; decode): one weight-streaming
  tensor-core template, bound by the packed bytes at 3.35 TB/s on an
  H100.  The decoded weight, transposed, is ``mma.sync``'s A operand and
  x's (at most 8) rows its B operand (m16n8k16 bf16 -> f32, m16n8k32 s8
  -> s32), so the CUDA cores only decode.  The raw packed weight and x
  stream through a ring in shared memory, each stage two TMA boxes from
  2-D tensor maps (rows past M or K arrive as 0).  :func:`gemv_plan` picks
  the column tile and a thread-block cluster of 1-8 blocks that split K;
  rank r of the cluster adds every rank's sums through distributed
  shared memory in rank order (deterministic; int8 exact), so a call is
  one launch, with no partial sums in device memory and no second
  kernel.
* ``mma`` (M > 8, bf16 or int8 x; prefill): one tensor-core template,
  ``mma.sync`` m16n8k16 bf16 -> f32 or m16n8k32 s8 -> s32 on output
  tiles of 128 or 256 rows by 128 columns, bound by the multiply-adds
  at the tensor-core rate.  x and the raw packed weight are staged with
  ``cp.async``; each stage's weight is decoded in shared memory into the
  mma's type (no dequantized weight in device memory).  K is split by
  :func:`mma_plan` when the tiles alone cannot fill the SMs, and in the
  float domain also where K passes ``MMA_FLOAT_CHAIN`` rows (the tensor
  cores' truncating f32 accumulation drifts with the chain's length).
* ``cuda_core`` (f32 x, any M): the CUDA-core kernels (a weight-streaming
  one for M <= 8, a tiled one above), K split by :func:`split_k`.  f32
  activations are off the serving path (the full-width model is bf16),
  and rounding them to bf16 for the tensor cores would break the float
  domain's f32 bar, so they keep these.

The mma and cuda_core routes add their K splits in a second kernel, in
split order.

The gemv and mma plans come from :func:`gemv_plan` and :func:`mma_plan`
unless the caller passes one (``tiles``): the cuda backend passes the
plan resolved from the measured autotune table (``kernels/autotune.py``).
:func:`plan_violations` states what a plan must keep of the kernel's
contract; a wrapper refuses a given plan that breaks it.

On a CPU tensor a wrapper computes its plain version (``kernels/ops.py``);
on a CUDA tensor it launches its route's kernel or raises.  ``LAUNCHES``
counts launches per wrapper and ``ROUTES`` per route, so a run can show
which kernels it went through.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.packing import TRIT2_PER_BYTE
from . import ops

BLOCK_N = 128            # output columns per block (kBN in the source)
BLOCK_M = 8              # rows per block of the CUDA-core routes (kBM)
K_CHUNK = 64             # packed rows per split unit (kKC K rows)
GEMV_MAX_M = 8           # rows the gemv route takes (the mma's n8)
GEMV_BLOCK_NS = (128, 64, 32)    # gemv column tiles, widest first
GEMV_CLUSTERS = (1, 2, 4, 8)     # blocks per cluster (portable sizes)
GEMV_STAGE_ROWS = 64     # packed rows per gemv stage (kGvRows)
MMA_BLOCK_N = 128        # output columns per mma block (kMBN)
MMA_K_CHUNK = 64         # K rows per mma stage and split unit (kMBK)
# The most K rows one bf16 mma accumulator chain takes.  The tensor cores
# add each m16n8k16 product into the f32 accumulator with truncation, so
# the chain's error against an exact sum grows about linearly with its
# length, where the f32 plain version's grows far slower; up to 8192
# rows it stays within the card tests' bar (chip_smoke.py measures both
# against an f64 sum at glm4-9b's K = 13696).  Longer K is split, and the
# splits are added in IEEE f32, in split order; int8 sums exactly.
MMA_FLOAT_CHAIN = 8192
MODE_CODE = {"base3": 0, "trit2": 1}
# x dtype codes of tm_gemv_launch (which refuses f32)
X_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SOURCE = "ternary_matmul.cu"      # under src/repro_torch/csrc/

LAUNCHES = {"ternary_matmul": 0, "ternary_matmul_int8": 0}
ROUTES = {"gemv": 0, "cuda_core": 0, "mma": 0}

_SM_COUNT: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def route(m: int, dtype: torch.dtype) -> str:
    """The kernel that serves M rows of x in ``dtype`` on the card."""
    if dtype == torch.float32:
        return "cuda_core"
    if dtype in (torch.bfloat16, torch.int8):
        return "gemv" if m <= GEMV_MAX_M else "mma"
    raise TypeError(f"no kernel route for x dtype {dtype}")


def split_k(m: int, k: int, n: int, mode: str,
            sm_count: int) -> tuple[int, int]:
    """(splits, k_per_split) of the CUDA-core route: split K across
    blocks until the grid holds about as many blocks as the SMs hold at
    once (three per SM for the kernel of M <= 8, two for the tiled one).
    A split is a whole number of chunks of 64 packed rows (64 K rows of
    base3, 256 of trit2), so a block streams the same bytes in either
    packing."""
    tiles = -(-n // BLOCK_N) * -(-m // BLOCK_M)
    unit = K_CHUNK * (TRIT2_PER_BYTE if mode == "trit2" else 1)
    chunks = max(1, -(-k // unit))
    per_sm = 3 if m <= BLOCK_M else 2
    want = max(1, -(-per_sm * sm_count // tiles))
    splits = min(chunks, want)
    per = -(-chunks // splits)
    return -(-chunks // per), per * unit


def gemv_plan(m: int, k: int, n: int, mode: str,
              sm_count: int) -> tuple[int, int, int]:
    """(block_n, cluster, k_per_split) of the gemv route.  K is cut into
    stages of 64 packed rows (64 K rows of base3, 256 of trit2) and a
    cluster of `cluster` blocks splits them, each a whole number of
    stages and none empty.  The widest column tile (128, 64 or 32) whose
    smallest such cluster puts a block on every SM wins: a wider tile
    reads longer row segments (128 bytes or more are whole lines), a
    narrower one makes more blocks.  Where nothing fills the SMs, the
    narrowest tile and the largest cluster."""
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"the gemv route takes 1 to {GEMV_MAX_M} rows, "
                         f"got {m}")
    unit = GEMV_STAGE_ROWS * (TRIT2_PER_BYTE if mode == "trit2" else 1)
    stages = max(1, -(-k // unit))
    clusters = [c for c in GEMV_CLUSTERS
                if (c - 1) * -(-stages // c) < stages]
    for bn in GEMV_BLOCK_NS:
        tiles = -(-n // bn)
        for c in clusters:
            if tiles * c >= sm_count:
                return bn, c, -(-stages // c) * unit
    c = clusters[-1]
    return GEMV_BLOCK_NS[-1], c, -(-stages // c) * unit


def mma_tile_plan(m: int, k: int, n: int, sm_count: int, bm: int,
                  chain: int | None = None) -> tuple[int, int, int]:
    """(bm, splits, k_per_split) of the mma route with `bm`-row tiles: K
    is split when the output tiles alone leave half the SMs idle, so
    that the grid holds at most about one block per SM, and, given a
    `chain`, until no split covers more than `chain` K rows; splits are
    whole stages of 64 K rows (either packing)."""
    tiles = -(-n // MMA_BLOCK_N) * -(-m // bm)
    chunks = max(1, -(-k // MMA_K_CHUNK))
    splits = min(chunks, max(1, sm_count // tiles))
    if chain is not None:
        splits = max(splits, -(-k // chain))
    per = -(-chunks // splits)
    return bm, -(-chunks // per), per * MMA_K_CHUNK


def mma_plan(m: int, k: int, n: int, sm_count: int,
             chain: int | None = None) -> tuple[int, int, int]:
    """(block_m, splits, k_per_split) of the mma route: 256-row tiles (16
    warps) for M > 128, else 128-row tiles (8 warps) with the rows past M
    masked; :func:`mma_tile_plan` splits K (the float domain passes
    ``chain=MMA_FLOAT_CHAIN``).  Where the autotune table holds a cell
    (``kernels/autotune.py``), plan resolution hands the wrapper the
    measured plan instead."""
    return mma_tile_plan(m, k, n, sm_count, 256 if m > 128 else 128, chain)


# mirrors of the shared-memory reckoning of csrc/ternary_matmul.cu
MAX_SMEM = 227 * 1024    # kMaxSmem: opt-in dynamic shared memory a block
GEMV_SMEM_LIMIT = 48 * 1024      # GemvShape's static limit (no opt-in)
MMA_BLOCK_MS = (128, 256)        # tm_mma_kernel's tile heights
_MMA_AHEAD, _MMA_PAD = 2, 16     # kAhead, kPad
_GEMV_RING_BYTES = 32 * 1024     # kGvRingBytes


def _elem(domain: str) -> int:
    """Bytes of one x element on the tensor-core routes (bf16 or int8)."""
    return 1 if domain == "int8" else 2


def mma_smem_bytes(mode: str, domain: str, bm: int) -> int:
    """``MmaShape<MODE, T, BM>::kSmem``: the x ring, the raw weight ring
    and the double-buffered decoded tile."""
    row = MMA_K_CHUNK * _elem(domain) + _MMA_PAD
    raw_rows = MMA_K_CHUNK // (TRIT2_PER_BYTE if mode == "trit2" else 1)
    return ((_MMA_AHEAD + 1) * bm * row + _MMA_AHEAD * raw_rows * MMA_BLOCK_N
            + 2 * MMA_BLOCK_N * row)


def gemv_smem_bytes(mode: str, domain: str, block_n: int) -> int:
    """``GemvShape<MODE, T, BN>::kSmem``: the TMA ring, the cluster's
    inbox of sums and the ring's barriers, plus 1 KB to align."""
    ks = GEMV_STAGE_ROWS * (TRIT2_PER_BYTE if mode == "trit2" else 1)
    stage = -(-(GEMV_STAGE_ROWS * block_n + GEMV_MAX_M * ks * _elem(domain))
              // 1024) * 1024
    ring = min(8, max(3, _GEMV_RING_BYTES // stage))
    return (ring * stage + GEMV_MAX_M * (block_n + 4) * 4 + 8 * ring
            + 1024)


def _cover(k: int, splits: int, per: int, unit: int, what: str) -> list:
    out = []
    if splits < 1 or per < 1:
        return [("coverage", f"{what}: splits={splits}, k_per_split={per} "
                             f"must be positive")]
    if per % unit:
        out.append(("coverage", f"{what}: k_per_split={per} is not whole "
                                f"stages of {unit} K rows"))
    if splits * per < k:
        out.append(("coverage", f"{what}: {splits} x {per} K rows leave K="
                                f"{k} uncovered"))
    elif (splits - 1) * per >= k:
        out.append(("coverage", f"{what}: {splits} x {per} K rows leave a "
                                f"split empty at K={k}"))
    return out


@functools.lru_cache(maxsize=4096)
def plan_violations(route_name: str, m: int, k: int, n: int, mode: str,
                    domain: str, tiles: tuple) -> tuple:
    """What a route plan breaks of the kernel's contract, as ``(kind,
    message)`` pairs (empty: the kernel takes it).  ``kind`` is ``tile``
    (a size the kernel has no instance of), ``coverage`` (the splits do
    not cover K exactly, in whole stages, none empty), ``chain`` (a float
    mma split longer than ``MMA_FLOAT_CHAIN``) or ``smem`` (the shared
    memory the source reckons passes its limit).  K is the extent the
    kernel sees (trit2: a multiple of 4).  The wrappers refuse a given
    plan that breaks any of it, the autotune table's check (AT002) and
    the ``blockmap`` analysis pass read the same list."""
    if mode not in MODE_CODE:
        return (("tile", f"unknown packing mode {mode!r}"),)
    if mode == "trit2" and k % TRIT2_PER_BYTE:
        return (("coverage", f"trit2 K={k} is not a multiple of "
                             f"{TRIT2_PER_BYTE}"),)
    if len(tiles) != (3 if route_name in ("gemv", "mma") else 2):
        return (("tile", f"{route_name} plan {tiles} has the wrong arity"),)
    out = []
    if route_name == "gemv":
        block_n, cluster, per = tiles
        if not 1 <= m <= GEMV_MAX_M:
            out.append(("tile", f"gemv takes 1 to {GEMV_MAX_M} rows, got "
                                f"M={m}"))
        if block_n not in GEMV_BLOCK_NS:
            out.append(("tile", f"block_n={block_n} not in {GEMV_BLOCK_NS}"))
        if cluster not in GEMV_CLUSTERS:
            out.append(("tile", f"cluster={cluster} not in {GEMV_CLUSTERS}"))
        unit = GEMV_STAGE_ROWS * (TRIT2_PER_BYTE if mode == "trit2" else 1)
        out += _cover(k, cluster, per, unit, "gemv cluster")
        if block_n in GEMV_BLOCK_NS:
            smem = gemv_smem_bytes(mode, domain, block_n)
            if smem > min(GEMV_SMEM_LIMIT, MAX_SMEM):
                out.append(("smem", f"gemv block_n={block_n} needs {smem} "
                                    f"B of shared memory"))
    elif route_name == "mma":
        bm, splits, per = tiles
        if m <= GEMV_MAX_M:
            out.append(("tile", f"mma takes M > {GEMV_MAX_M}, got M={m}"))
        if bm not in MMA_BLOCK_MS:
            out.append(("tile", f"block_m={bm} not in {MMA_BLOCK_MS}"))
        out += _cover(k, splits, per, MMA_K_CHUNK, "mma split")
        if domain == "float" and per > MMA_FLOAT_CHAIN:
            out.append(("chain", f"a float split chains {per} K rows, past "
                                 f"MMA_FLOAT_CHAIN={MMA_FLOAT_CHAIN}"))
        if bm in MMA_BLOCK_MS and mma_smem_bytes(mode, domain, bm) > MAX_SMEM:
            out.append(("smem", f"mma block_m={bm} needs "
                                f"{mma_smem_bytes(mode, domain, bm)} B"))
    elif route_name == "cuda_core":
        splits, per = tiles
        unit = K_CHUNK * (TRIT2_PER_BYTE if mode == "trit2" else 1)
        out += _cover(k, splits, per, unit, "cuda_core split")
    else:
        out.append(("tile", f"unknown route {route_name!r}"))
    return tuple(out)


def _given(route_name: str, m: int, k: int, n: int, mode: str, domain: str,
           tiles) -> tuple:
    """A caller's route plan, refused loudly if the kernel cannot take
    it (never replaced by the heuristic)."""
    tiles = tuple(int(t) for t in tiles)
    bad = plan_violations(route_name, m, k, n, mode, domain, tiles)
    if bad:
        raise ValueError(f"{route_name} plan {tiles} at {(m, k, n)} {mode}/"
                         f"{domain}: " + "; ".join(msg for _, msg in bad))
    return tiles


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
    from .plan import is_abstract
    dev = tensors[0].device
    for t in tensors:
        if is_abstract(t):
            raise ValueError("a fake or meta tensor holds no storage for "
                             "the kernel to read; the abstract backend "
                             "serves it")
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _vec(data: torch.Tensor, n: int) -> int:
    """32-bit weight loads need 4-byte aligned rows."""
    return int(n % 4 == 0 and data.data_ptr() % 4 == 0)


def _mma_vec(x: torch.Tensor, data: torch.Tensor) -> int:
    """16-byte cp.async staging needs every x row and packed weight row
    to start 16-byte aligned; otherwise the kernel stages byte by byte."""
    row_bytes = x.shape[1] * x.element_size()
    return int(row_bytes % 16 == 0 and x.data_ptr() % 16 == 0
               and data.shape[1] % 16 == 0 and data.data_ptr() % 16 == 0)


def _lib():
    """The kernels' library, built at first use, with its C signatures."""
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tm_float_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                        i, p]
        lib.tm_float_launch.restype = i
        lib.tm_gemv_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i,
                                       i, i, p]
        lib.tm_gemv_launch.restype = i
        lib.tm_mma_launch.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i,
                                      i, i, i, p]
        lib.tm_mma_launch.restype = i
        lib.tm_gemv_int32_launch.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                             i, p]
        lib.tm_gemv_int32_launch.restype = i
        lib.tm_mma_int32_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                            i, i, p]
        lib.tm_mma_int32_launch.restype = i
        lib._typed = True
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: error {err} "
                           f"({torch.cuda.get_device_name()})")


def launch_mma(x: torch.Tensor, x_scale, data: torch.Tensor,
               scale: torch.Tensor, mode: str, out: torch.Tensor,
               plan: tuple[int, int, int]) -> int:
    """The tensor-core route for bf16 (float domain; ``x_scale`` None) or
    int8 x, on checked CUDA operands, with ``plan`` = (block_m, splits,
    k_per_split) as :func:`mma_plan` gives it; returns the C launcher's
    error code.  Counts nothing: the wrappers count their launches."""
    m, k = x.shape
    n = data.shape[1]
    bm, splits, per = plan
    acc_dtype = torch.int32 if x.dtype == torch.int8 else torch.float32
    partial = (torch.empty((splits, m, n), dtype=acc_dtype, device=x.device)
               if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return _lib().tm_mma_launch(
        x.data_ptr(), int(x.dtype == torch.int8),
        x_scale.data_ptr() if x_scale is not None else None,
        data.data_ptr(), scale.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        m, k, n, MODE_CODE[mode], bm, splits, per, _mma_vec(x, data), stream)


def launch_gemv(x: torch.Tensor, x_scale, data: torch.Tensor,
                scale: torch.Tensor, mode: str, out: torch.Tensor,
                plan: tuple[int, int, int]) -> int:
    """The decode route for bf16 (float domain; ``x_scale`` None) or int8
    x on checked CUDA operands, with ``plan`` = (block_n, cluster,
    k_per_split) as :func:`gemv_plan` gives it; returns the C launcher's
    error code, which refuses f32 x, M above 8 and a plan the kernel
    does not take.  Counts nothing: the wrappers count their launches."""
    if x.dtype not in X_TYPE:
        raise TypeError(f"no gemv kernel for x dtype {x.dtype}")
    m, k = x.shape
    n = data.shape[1]
    block_n, cluster, per = plan
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return _lib().tm_gemv_launch(
        x.data_ptr(), X_TYPE[x.dtype],
        x_scale.data_ptr() if x_scale is not None else None,
        data.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        MODE_CODE[mode], block_n, cluster, per, _mma_vec(x, data), stream)


def launch_int32(x: torch.Tensor, data: torch.Tensor, mode: str,
                 out: torch.Tensor) -> int:
    """The int32 epilogue of the int8 routes, on checked CUDA operands:
    (M, K) int8 x times the packed weight, the exact sums written into
    ``out`` (M, N) int32 as they are, with no scales, through ``gemv``
    (M <= 8) or ``mma`` and their plans.  Returns the C launcher's error
    code.  Counts nothing: ``cim_mac``'s code route calls it and counts
    its own launches."""
    m, k = x.shape
    n = data.shape[1]
    sms = _sm_count(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vec = _mma_vec(x, data)
    if route(m, x.dtype) == "gemv":
        block_n, cluster, per = gemv_plan(m, k, n, mode, sms)
        return _lib().tm_gemv_int32_launch(
            x.data_ptr(), data.data_ptr(), out.data_ptr(), m, k, n,
            MODE_CODE[mode], block_n, cluster, per, vec, stream)
    bm, splits, per = mma_plan(m, k, n, sms)
    partial = (torch.empty((splits, m, n), dtype=torch.int32,
                           device=x.device) if splits > 1 else None)
    return _lib().tm_mma_int32_launch(
        x.data_ptr(), data.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None, m, k, n,
        MODE_CODE[mode], bm, splits, per, vec, stream)


def matmul_float(x: torch.Tensor, data: torch.Tensor, scale: torch.Tensor,
                 mode: str, tiles=None) -> torch.Tensor:
    """(M, K) f32/bf16 @ packed (K | K/4, N) -> (M, N) f32.  ``tiles`` is
    the plan of the route M and the dtype pick (gemv: (block_n, cluster,
    k_per_split); mma: (block_m, splits, k_per_split)), None for the
    route's rule; the cuda_core route (f32 x) takes none.  A plan the
    kernel cannot take raises."""
    m, k, n = _check(x, data, scale, mode, (torch.float32, torch.bfloat16))
    path = route(m, x.dtype)
    if tiles is not None:
        if path == "cuda_core":
            raise ValueError("the cuda_core route (f32 x) takes no tiles")
        tiles = _given(path, m, k, n, mode, "float", tiles)
    if x.device.type == "cpu":
        return ops.ternary_matmul_torch(x, ops.PackedTernary(data, scale,
                                                             mode))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda(x, data, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    sms = _sm_count(x.device)
    if path == "mma":
        err = launch_mma(x, None, data, scale, mode, out,
                         tiles or mma_plan(m, k, n, sms, MMA_FLOAT_CHAIN))
    elif path == "gemv":
        err = launch_gemv(x, None, data, scale, mode, out,
                          tiles or gemv_plan(m, k, n, mode, sms))
    else:
        splits, per = split_k(m, k, n, mode, sms)
        partial = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device) if splits > 1 else None)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().tm_float_launch(
            x.data_ptr(), data.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            m, k, n, MODE_CODE[mode], splits, per, _vec(data, n), stream)
    _raise_on(err, f"ternary_matmul ({path})")
    LAUNCHES["ternary_matmul"] += 1
    ROUTES[path] += 1
    return out


def matmul_int8(x_int: torch.Tensor, x_scale: torch.Tensor,
                data: torch.Tensor, scale: torch.Tensor,
                mode: str, tiles=None) -> torch.Tensor:
    """(M, K) int8 with (M,) f32 row scales @ packed weight -> (M, N) f32;
    ``tiles`` as :func:`matmul_float`'s."""
    m, k, n = _check(x_int, data, scale, mode, (torch.int8,))
    if x_scale.shape != (m,) or x_scale.dtype != torch.float32:
        raise ValueError(f"x_scale must be ({m},) f32, got "
                         f"{tuple(x_scale.shape)} {x_scale.dtype}")
    path = route(m, x_int.dtype)
    if tiles is not None:
        tiles = _given(path, m, k, n, mode, "int8", tiles)
    if x_int.device.type == "cpu":
        return ops.ternary_matmul_int8_torch(
            x_int, x_scale, ops.PackedTernary(data, scale, mode))
    if x_int.device.type != "cuda":
        raise ValueError(f"unsupported device {x_int.device}")
    _check_cuda(x_int, x_scale, data, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    sms = _sm_count(x_int.device)
    if path == "mma":
        err = launch_mma(x_int, x_scale, data, scale, mode, out,
                         tiles or mma_plan(m, k, n, sms))
    else:
        err = launch_gemv(x_int, x_scale, data, scale, mode, out,
                          tiles or gemv_plan(m, k, n, mode, sms))
    _raise_on(err, f"ternary_matmul_int8 ({path})")
    LAUNCHES["ternary_matmul_int8"] += 1
    ROUTES[path] += 1
    return out


def matmul_int32(x_int: torch.Tensor, data: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """(M, K) int8 @ packed (K | K/4, N) -> (M, N) int32: the int8
    routes' exact sums with no epilogue, for a row shard whose partial
    sums are added over the model axis before the scales apply
    (``dist.runtime.ShardedPacked``).  On the card it launches the int32
    epilogue of the route M picks (``launch_int32``, on the rule's plan)
    and counts one ``ternary_matmul_int8`` launch, as the unsplit
    product would; on the CPU it is the plain version's integer dot."""
    if x_int.dtype != torch.int8 or x_int.dim() != 2 or data.dim() != 2:
        raise ValueError(f"need int8 x (M, K) and packed w (K', N); got "
                         f"{x_int.dtype} {tuple(x_int.shape)}, "
                         f"{tuple(data.shape)}")
    m, k, n = _check(x_int, data, torch.empty(data.shape[1]), mode,
                     (torch.int8,))
    if x_int.device.type == "cpu":
        wd = ops.decode_weight(ops.PackedTernary(data, None, mode),
                               torch.float64)[:k]
        return torch.matmul(x_int.to(torch.float64), wd).to(torch.int32)
    if x_int.device.type != "cuda":
        raise ValueError(f"unsupported device {x_int.device}")
    _check_cuda(x_int, data)
    out = torch.empty((m, n), dtype=torch.int32, device=x_int.device)
    _raise_on(launch_int32(x_int, data, mode, out),
              f"ternary_matmul_int8 ({route(m, x_int.dtype)}, int32)")
    LAUNCHES["ternary_matmul_int8"] += 1
    ROUTES[route(m, x_int.dtype)] += 1
    return out

"""The paged-attention decode read: flash statistics straight off the page
pool (``csrc/paged_attention.cu``).

:func:`paged_attention` replaces the Pallas kernel ``_fused_kernel`` of
``src/repro/kernels/paged_attention.py``.  For every slot it computes the
unnormalised flash statistics of that slot's grouped queries against its
paged context::

    s[t] = q . k[t]  (f32),  masked to -1e30 where t >= pos[slot]
    m = max_t s,  l = sum_t exp(s - m),  acc = sum_t exp(s - m) v[t]

reading each page ``page_table[slot, w]`` of the ``(P, page_size, KV, hd)``
pool directly, so the gathered dense copy of the ``slot_view`` path never
exists.  The caller merges the fresh token's own k/v into ``(acc, m, l)``
(``models.attention.paged_decode_attention_read``).  Page 0 is the pool's
null page: unused table entries point at it, and the positional mask
makes its contents contribute exactly 0 to any slot that has a live key.
A slot with ``pos = 0`` reports ``m = -1e30``, ``l = W * page_size`` and
``acc`` = the sum of every V row its table names, as the oracle does; the
caller's merge weighs that block by ``exp(-1e30 - s_new) = 0``.

The kernel, bound on an H100 by the live K/V bytes, runs one thread-block
cluster per (slot, KV head); :func:`paged_plan` gives its shape.  The
cluster's ranks split the page-table windows into contiguous ranges.  In
a rank, each warp carries up to 8 grouped queries over every
``warps_per_chunk``-th step of 8 // rows positions of a window, with its
own running softmax; the warps' partials are merged in warp order, then
each rank then merges a slice of the lanes over the ranks' partials, read
in rank order through distributed shared memory, so a call is one launch
and two calls agree bitwise.  With ``pos > 0`` a window at or past
``pos`` is never loaded.  Pages reach shared memory through a ring of TMA
loads where rows are 16-byte aligned (route ``tma``), else through plain
loads (route ``loads``); ``ROUTES`` counts the two.

:func:`paged_attention_torch` is the plain version, the gather oracle of
the reference (``paged_attention_ref``).  On a CPU tensor the wrapper
computes it; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

NEG_INF = -1e30          # the dense read's masking constant (attention.py)
SOURCE = "paged_attention.cu"     # under src/repro_torch/csrc/
MAX_HEAD_DIM = 256       # a lane holds 8 elements of a row (d = lane + 32 j)
MAX_ROWS_PER_WARP = 8    # grouped queries one warp carries
STEP_SCORES = 8          # scores a warp step reduces: rows x positions
MAX_WARPS = 8            # a block has at most 256 threads
MAX_GROUPED = MAX_ROWS_PER_WARP * MAX_WARPS      # rep <= 64
CLUSTERS = (1, 2, 4, 8)  # cluster sizes a plan takes (8: the portable most)
MAX_STAGES = 4           # depth of the page ring
MAX_BOX = 256            # a TMA box's largest extent (rows of a page)
RING_BUDGET = 32 * 1024  # ring bytes a plan aims for (4 blocks an SM)
SMEM_LIMIT = 227 * 1024  # shared bytes a block may take after opting in
H100_SMS = 132
BLOCKS_PER_SM = 4        # the grid a plan aims to fill, per SM

LAUNCHES = {"paged_attention": 0}
ROUTES = {"tma": 0, "loads": 0}     # how a call fed its pages


def reset_launches() -> None:
    for d in (LAUNCHES, ROUTES):
        for k in d:
            d[k] = 0


class PagedAttentionKV(NamedTuple):
    """One layer's raw page pool plus the routing state.  Its ``shape``
    makes it an ``execute()`` operand: the plan shape is
    ``(S*KV*rep, hd, W*page_size)``.

    k_pages, v_pages : (num_pages, page_size, KV, hd)
    page_table       : (S, W) int32, pool page id per slot x window
    pos              : (S,) int32, live context length per slot
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    pos: torch.Tensor

    @property
    def shape(self) -> tuple:
        return (int(self.k_pages.shape[-1]),
                int(self.page_table.shape[-1])
                * int(self.k_pages.shape[-3]))


class PagedPlan(NamedTuple):
    """The kernel's launch shape for one call (``csrc/paged_attention.cu``).

    splits          : ranks of a cluster, each over `per_rank` windows
    per_rank        : windows of a rank's range (the last may hold fewer)
    rows            : grouped queries a warp carries (1, 2, 4 or 8)
    step            : positions a warp step scores, 8 // rows
    chunks          : warps' row groups, ceil(rep / rows)
    warps_per_chunk : warps sharing a row group, each taking every
                      warps_per_chunk-th step of a window
    threads         : 32 * chunks * warps_per_chunk
    stages          : depth of the ring of pages in shared memory
    smem            : dynamic shared bytes of a block
    """
    splits: int
    per_rank: int
    rows: int
    step: int
    chunks: int
    warps_per_chunk: int
    threads: int
    stages: int
    smem: int


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def smem_bytes(rep: int, hd: int, page_size: int, per_rank: int,
               rows: int, warps: int, stages: int, elem_bytes: int) -> int:
    """A block's dynamic shared bytes; ``pa_smem_bytes`` in the source
    computes the same.  The ring of `stages` K and V tiles (page_size x
    hd each, 128-byte aligned) is reused, once the windows are done, for
    the warps' partials and the rank's partial; then the rank's page ids,
    one mbarrier per stage, and 128 bytes to align the base."""
    tile = _up(page_size * hd * elem_bytes, 128)
    ring = stages * 2 * tile
    parts = (_up(warps * rows * (hd + 2) * 4, 128)
             + _up((rep * hd + 2 * rep) * 4, 128))
    return max(ring, parts) + _up(per_rank * 4, 128) + 8 * stages + 128


def paged_plan(slots: int, kvh: int, rep: int, hd: int, page_size: int,
               windows: int, elem_bytes: int,
               sm_count: int = H100_SMS) -> PagedPlan:
    """The launch shape of one call.

    - A warp carries ``rows`` = the power of two >= rep, at most 8, of the
      grouped queries, and scores ``step`` = 8 // rows positions at a time
      (8 scores a step); ``chunks`` row groups cover rep.  Up to 4 warps
      share a row group (at most a window's steps, 8 warps in all), each
      taking every warps_per_chunk-th step of a window.
    - ``splits``: the smallest cluster whose grid (slots x KV x splits)
      puts BLOCKS_PER_SM blocks on every SM, else the largest; only sizes
      whose ranks all get a window.
    - ``stages``: as deep as the rank's windows (2 to 4) while the ring
      stays within RING_BUDGET; 2 at least, and the whole block within
      SMEM_LIMIT.

    Raises ValueError for what the kernel cannot take: hd > 256, rep >
    64, or two stages of pages beyond SMEM_LIMIT."""
    if min(slots, kvh, rep, hd, page_size, windows) < 1:
        raise ValueError(f"empty paged read: slots {slots}, KV {kvh}, rep "
                         f"{rep}, hd {hd}, {windows} windows of "
                         f"{page_size}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if rep > MAX_GROUPED:
        raise ValueError(f"{rep} grouped queries per KV head > "
                         f"{MAX_GROUPED} (8 warps of 8 rows)")
    rows = min(MAX_ROWS_PER_WARP, 1 << (rep - 1).bit_length())
    step = STEP_SCORES // rows
    chunks = -(-rep // rows)
    wpc = max(1, min(-(-page_size // step), 4, MAX_WARPS // chunks))
    warps = chunks * wpc
    fits = [c for c in CLUSTERS if c <= windows
            and (c - 1) * -(-windows // c) < windows]
    splits = next((c for c in fits
                   if slots * kvh * c >= BLOCKS_PER_SM * sm_count),
                  fits[-1])
    per_rank = -(-windows // splits)
    tile = _up(page_size * hd * elem_bytes, 128)
    stages = next((s for s in range(min(MAX_STAGES, max(2, per_rank)), 1,
                                    -1) if s * 2 * tile <= RING_BUDGET), 2)
    smem = smem_bytes(rep, hd, page_size, per_rank, rows, warps, stages,
                      elem_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"page size {page_size} x head dim {hd} needs "
                         f"{smem} B of shared memory per block (limit "
                         f"{SMEM_LIMIT})")
    return PagedPlan(splits, per_rank, rows, step, chunks, wpc, 32 * warps,
                     stages, smem)


def _dims(q: torch.Tensor, kv: PagedAttentionKV) -> tuple:
    if q.dim() != 4:
        raise ValueError(f"paged attention takes q (slots, KV, rep, hd); "
                         f"got ndim={q.dim()}")
    s, kvh, rep, hd = (int(d) for d in q.shape)
    num_pages, ps, kvh_p, hd_p = (int(d) for d in kv.k_pages.shape)
    w = int(kv.page_table.shape[-1])
    if (kvh_p, hd_p) != (kvh, hd) or kv.v_pages.shape != kv.k_pages.shape:
        raise ValueError(f"page pool {tuple(kv.k_pages.shape)}/"
                         f"{tuple(kv.v_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if int(kv.page_table.shape[0]) != s or int(kv.pos.shape[0]) != s:
        raise ValueError(f"page table {tuple(kv.page_table.shape)} / pos "
                         f"{tuple(kv.pos.shape)} do not cover {s} slots")
    return s, kvh, rep, hd, num_pages, ps, w


def paged_attention_torch(q: torch.Tensor, kv: PagedAttentionKV) -> tuple:
    """The plain version: gather each slot's pages into a dense copy and
    take the statistics with one global softmax.  Returns ``(acc (S, KV,
    rep, hd), m (S, KV, rep), l (S, KV, rep))``, all f32."""
    s, kvh, rep, hd, _, ps, w = _dims(q, kv)
    table = kv.page_table.long()
    kg = kv.k_pages[table].reshape(s, w * ps, kvh, hd)
    vg = kv.v_pages[table].reshape(s, w * ps, kvh, hd)
    sc = torch.einsum("skrd,stkd->skrt", q.float(), kg.float())
    valid = (torch.arange(w * ps, device=q.device)[None, :]
             < kv.pos[:, None])
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("skrt,stkd->skrd", p, vg.float())
    return acc, m, l


def _lib():
    """The kernel's library, built at first use, with its C signatures."""
    from .build import library
    lib = library(SOURCE)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pa_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                  i, i, i, i, i, i, i, p]
        lib.pa_launch.restype = i
        lib.pa_smem_bytes.argtypes = [i, i, i, i, i, i, i, i]
        lib.pa_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check_cuda(q: torch.Tensor, kv: PagedAttentionKV) -> None:
    tensors = (q, *kv)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype} is not bf16 or f32")
    if kv.k_pages.dtype != q.dtype or kv.v_pages.dtype != q.dtype:
        raise TypeError(f"pages {kv.k_pages.dtype}/{kv.v_pages.dtype} and "
                        f"q {q.dtype} differ")
    if kv.page_table.dtype != torch.int32 or kv.pos.dtype != torch.int32:
        raise TypeError(f"page table and pos must be int32, got "
                        f"{kv.page_table.dtype}, {kv.pos.dtype}")


def load_route(kv: PagedAttentionKV) -> str:
    """``tma`` where a page's rows of one head are 16-byte aligned and a
    page fits a TMA box, else ``loads``."""
    hd, elem = int(kv.k_pages.shape[-1]), kv.k_pages.element_size()
    ok = ((hd * elem) % 16 == 0 and int(kv.k_pages.shape[1]) <= MAX_BOX
          and kv.k_pages.data_ptr() % 16 == 0
          and kv.v_pages.data_ptr() % 16 == 0)
    return "tma" if ok else "loads"


def paged_attention(q: torch.Tensor, kv: PagedAttentionKV) -> tuple:
    """Flash statistics of ``q (S, KV, rep, hd)`` (pre-scaled by
    ``1/sqrt(hd)``) against the paged context: ``(acc, m, l)``, f32."""
    s, kvh, rep, hd, num_pages, ps, w = _dims(q, kv)
    if q.device.type == "cpu":
        return paged_attention_torch(q, kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, kv)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = paged_plan(s, kvh, rep, hd, ps, w, q.element_size(), sms)
    route = load_route(kv)
    lib = _lib()
    acc = torch.empty((s, kvh, rep, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((s, kvh, rep), dtype=torch.float32, device=q.device)
    l = torch.empty((s, kvh, rep), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pa_launch(
        q.data_ptr(), kv.k_pages.data_ptr(), kv.v_pages.data_ptr(),
        kv.page_table.data_ptr(), kv.pos.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), s, num_pages, kvh, rep, hd, ps, w,
        plan.splits, plan.per_rank, plan.warps_per_chunk, plan.stages,
        int(q.dtype == torch.bfloat16), int(route == "tma"), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention CUDA launch failed: error "
                           f"{err} ({torch.cuda.get_device_name(q.device)})")
    LAUNCHES["paged_attention"] += 1
    ROUTES[route] += 1
    return acc, m, l

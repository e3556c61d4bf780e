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

Bound on an H100: the K/V bytes read (about one multiply-add per byte).

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
THREADS = 512            # kThreads in the source
ACC_PER_THREAD = 2       # kAccPerThread: rep * hd <= 1024
MAX_HEAD_DIM = 256
MAX_GROUP = 4            # windows whose pages a block holds at once
SMEM_LIMIT = 48 * 1024   # shared bytes a block takes without opting in

LAUNCHES = {"paged_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
                                  i, i, i, i, p]
        lib.pa_launch.restype = i
        lib.pa_smem_bytes.argtypes = [i, i, i, i, i, i]
        lib.pa_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _check_cuda(q: torch.Tensor, kv: PagedAttentionKV, rep: int, hd: int
                ) -> None:
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if rep * hd > THREADS * ACC_PER_THREAD:
        raise ValueError(f"rep * hd = {rep * hd} exceeds the block's "
                         f"{THREADS * ACC_PER_THREAD} accumulator lanes")


def paged_attention(q: torch.Tensor, kv: PagedAttentionKV) -> tuple:
    """Flash statistics of ``q (S, KV, rep, hd)`` (pre-scaled by
    ``1/sqrt(hd)``) against the paged context: ``(acc, m, l)``, f32."""
    s, kvh, rep, hd, num_pages, ps, w = _dims(q, kv)
    if q.device.type == "cpu":
        return paged_attention_torch(q, kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, kv, rep, hd)
    if w < 1 or ps < 1:
        raise ValueError(f"empty page table ({w} windows of {ps})")
    lib = _lib()
    elem = q.element_size()
    # the most windows (up to MAX_GROUP) whose pages fit in shared memory
    group = next((g for g in range(min(MAX_GROUP, w), 0, -1)
                  if lib.pa_smem_bytes(rep, hd, ps, w, g, elem)
                  <= SMEM_LIMIT), 0)
    if group == 0:
        smem = lib.pa_smem_bytes(rep, hd, ps, w, 1, elem)
        raise ValueError(f"page size {ps} x head dim {hd} needs {smem} B of "
                         f"shared memory per block (limit {SMEM_LIMIT})")
    vec = int((hd * elem) % 16 == 0 and kv.k_pages.data_ptr() % 16 == 0
              and kv.v_pages.data_ptr() % 16 == 0)
    acc = torch.empty((s, kvh, rep, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((s, kvh, rep), dtype=torch.float32, device=q.device)
    l = torch.empty((s, kvh, rep), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pa_launch(
        q.data_ptr(), kv.k_pages.data_ptr(), kv.v_pages.data_ptr(),
        kv.page_table.data_ptr(), kv.pos.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), s, num_pages, kvh, rep, hd, ps, w,
        group, int(q.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention CUDA launch failed: error "
                           f"{err} ({torch.cuda.get_device_name(q.device)})")
    LAUNCHES["paged_attention"] += 1
    return acc, m, l

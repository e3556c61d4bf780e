"""Paged, prefix-shared KV storage for the serving slot pool.

The dense slot pool gives every slot a ``(capacity, KV, hd)`` cache
padded to full capacity, so resident KV scales as ``slots x capacity``
and identical prompt prefixes are held once per slot.  This module keeps
KV in a pool of fixed-size pages instead:

  * :class:`PagedKVCache`: pages on a leading page axis, ``k_pages (L, P,
    page_size, KV, hd)``.  Page 0 is the reserved null page: never
    allocated, the target of dead slots' writes and of unused page-table
    entries.  Its contents are garbage by design; every read of it is
    masked by position.
  * :func:`slot_view`: the gather of slots' page-table rows back into the
    dense ``(L, B, capacity, KV, hd)`` layout the dense decode read takes.
  * :func:`raw_pool_view`: the raw page arrays, for the attention kernel
    that reads the page table itself.
  * :func:`append_tokens`: the per-step scatter of every slot's new K/V
    token into its current page (dead slots go to the null page).
  * :func:`write_prompt_pages`: the admission-time scatter of a prefill's
    KV into freshly allocated pages.
  * :class:`PageAllocator`: the host-side free list with refcounted
    prefix sharing, and :func:`prefix_key`.
  * :class:`PagedKV` and :func:`materialize`: a paged K or V operand of
    ``attention.attend`` / ``flash_attention``, gathered into the dense
    layout before they compute.

The reference's functions return an updated copy of the pool; these
update the pool's tensors in place (no second pool is ever allocated)
and return the same pool, so call sites read alike.  An int8 pool
(``kv_cache_dtype="int8"``) holds int8 code pages with f32 scale pages
``(L, P, page_size, KV)`` beside them, paged alike; the attention
kernel reads float pools only (:func:`raw_pool_view`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import ModelConfig


class PagedKVCache(NamedTuple):
    """The device page pool shared by every slot of a scheduler:
    k_pages/v_pages (L, P, page_size, KV, hd) in the cache dtype, and
    for an int8 pool k_scale_pages/v_scale_pages (L, P, page_size, KV)
    f32."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale_pages: Optional[torch.Tensor] = None
    v_scale_pages: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_bytes(self) -> int:
        """Device bytes one page occupies across k and v (and scales)."""
        return sum(leaf.numel() * leaf.element_size() // leaf.shape[1]
                   for leaf in self if leaf is not None)

    @property
    def nbytes(self) -> int:
        return sum(leaf.numel() * leaf.element_size() for leaf in self
                   if leaf is not None)


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                   device) -> PagedKVCache:
    """Allocate the page pool on `device`.  Page 0 is the reserved null
    page: never allocated, the landing zone of dead slots' writes."""
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                         f"reserved null page), got {num_pages}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.hd)
    if cfg.kv_cache_dtype != "int8":
        return PagedKVCache(
            torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
    return PagedKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def slot_view(pool: PagedKVCache, page_table: torch.Tensor,
              pos) -> dict:
    """Gather slots' pages into the dense decode-state layout.

    ``page_table`` (W,) for one slot or (S, W) for S slots; ``pos`` the
    slots' next write positions.  Returns ``{"k", "v", "pos"}`` with k/v
    (L, B, W * page_size, KV, hd), B = 1 for a single row, and for an
    int8 pool ``k_scale``/``v_scale`` (L, B, W * page_size, KV).
    Positions at or past ``pos`` are masked by the dense read."""
    table = page_table.reshape(-1, page_table.shape[-1]).long()

    def gather(pages):
        g = pages[:, table]                      # (L, B, W, ps, ...)
        return g.reshape((g.shape[0], g.shape[1], g.shape[2] * g.shape[3])
                         + tuple(g.shape[4:]))
    view = {"k": gather(pool.k_pages), "v": gather(pool.v_pages),
            "pos": pos}
    if pool.k_scale_pages is not None:
        view["k_scale"] = gather(pool.k_scale_pages)
        view["v_scale"] = gather(pool.v_scale_pages)
    return view


def raw_pool_view(pool: PagedKVCache) -> tuple:
    """The raw ``(L, P, page_size, KV, hd)`` page arrays, for the
    attention kernel that reads the page table itself.  Float pools
    only: the kernel does not read scale pages."""
    if pool.k_scale_pages is not None:
        raise ValueError(
            "raw pool view is float-KV only: int8 page pools carry "
            "scale pages the fused attention read does not consume; "
            "use the slot_view gather path")
    return pool.k_pages, pool.v_pages


def append_tokens(pool: PagedKVCache, kts: torch.Tensor, vts: torch.Tensor,
                  page_table: torch.Tensor, pos: torch.Tensor,
                  live: torch.Tensor) -> PagedKVCache:
    """Scatter every slot's new K/V token into its current page, in
    place.  kts/vts (slots, L, KV, hd); page_table (slots, W); pos and
    live (slots,).  Dead slots (retired, or decoding scratch past their
    budget) write to the null page, so they never clobber a page freed
    and handed to another slot; the page index is clamped at the table
    width for scratch decodes past capacity.  An int8 pool stores the
    codes and scales of the compute-dtype tokens."""
    ps = pool.page_size
    rows = torch.arange(kts.shape[0], device=kts.device)
    pidx = torch.clamp(pos // ps, max=page_table.shape[1] - 1).long()
    zero = torch.zeros((), dtype=page_table.dtype, device=kts.device)
    pid = torch.where(live, page_table[rows, pidx], zero).long()
    off = torch.where(live, pos % ps, torch.zeros_like(pos)).long()
    k_t, v_t = kts.transpose(0, 1), vts.transpose(0, 1)
    if pool.k_scale_pages is not None:
        from .attention import quantize_kv
        kq, ksc = quantize_kv(k_t)
        vq, vsc = quantize_kv(v_t)
        pool.k_pages[:, pid, off] = kq
        pool.v_pages[:, pid, off] = vq
        pool.k_scale_pages[:, pid, off] = ksc
        pool.v_scale_pages[:, pid, off] = vsc
        return pool
    pool.k_pages[:, pid, off] = k_t.to(pool.k_pages.dtype)
    pool.v_pages[:, pid, off] = v_t.to(pool.v_pages.dtype)
    return pool


def write_prompt_pages(pool: PagedKVCache, state: dict,
                       pool_ids: torch.Tensor,
                       src_pages: torch.Tensor) -> PagedKVCache:
    """Admission: copy a batch-1 prefill state's KV into the pool, in
    place.  ``state["k"]`` is (L, 1, cap, KV, hd) with ``cap`` a page
    multiple (scales included for an int8 pool); ``src_pages[i]`` names
    the page-sized chunk of it that lands in pool page ``pool_ids[i]``.
    Prefix-shared pages are absent from both: their contents already
    reside in the pool."""
    ps = pool.page_size
    ids = pool_ids.long()
    src = src_pages.long()

    def put(pages, slab):
        view = slab.reshape((slab.shape[0], slab.shape[1] // ps, ps)
                            + tuple(slab.shape[2:]))
        pages[:, ids] = view[:, src].to(pages.dtype)

    put(pool.k_pages, state["k"][:, 0])
    put(pool.v_pages, state["v"][:, 0])
    if pool.k_scale_pages is not None:
        put(pool.k_scale_pages, state["k_scale"][:, 0])
        put(pool.v_scale_pages, state["v_scale"][:, 0])
    return pool


class PageAllocator:
    """Free list plus refcounted prefix registry for one page pool.

    Host bookkeeping only: page contents never leave the device.
    ``alloc`` is all-or-nothing, so admission can be deferred whole when
    the pool is exhausted."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        # page 0 reserved as the null page; hand out ascending ids
        self._free = list(range(num_pages - 1, 0, -1))
        self._refcount: dict = {}          # page id -> live references
        self._prefix: dict = {}            # prefix key -> page id
        self._key_of: dict = {}            # page id -> prefix key
        self.prefix_hits = 0
        self.prefix_lookups = 0
        self.peak_in_use = 0

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def _note_peak(self):
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)

    def alloc(self, n: int):
        """n fresh private pages (refcount 1), or None if the pool
        cannot satisfy all of them."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self._refcount[pid] = 1
        self._note_peak()
        return ids

    def lookup_prefix(self, key):
        """Map a shared page if its prefix key resides in the pool
        (refcount + 1); returns the page id or None."""
        self.prefix_lookups += 1
        pid = self._prefix.get(key)
        if pid is None:
            return None
        self._refcount[pid] += 1
        self.prefix_hits += 1
        return pid

    def register_prefix(self, key, pid: int) -> None:
        """Publish a freshly written prompt page for later sharing."""
        self._prefix[key] = pid
        self._key_of[pid] = key

    def release(self, pids) -> None:
        """Drop one reference per page; a page reaching refcount 0
        returns to the free list and leaves the prefix registry."""
        for pid in pids:
            self._refcount[pid] -= 1
            if self._refcount[pid] == 0:
                del self._refcount[pid]
                key = self._key_of.pop(pid, None)
                if key is not None:
                    del self._prefix[key]
                self._free.append(pid)

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prefix_lookups:
            return 0.0
        return self.prefix_hits / self.prefix_lookups


def prefix_key(prompt_np, page: int, page_size: int):
    """Hashable identity of prompt page ``page``: the token prefix that
    (causally) determines the page's KV contents."""
    return (page, prompt_np[: (page + 1) * page_size].tobytes())


class PagedKV(NamedTuple):
    """A paged K or V operand of ``attention.attend`` /
    ``flash_attention``: per-row page tables over a shared page pool.
    ``pages (P, page_size, KV, hd)``; ``page_table (B, n)``.  The
    attention functions gather it (:func:`materialize`) before they
    compute, so the paged layout needs no second attention and gives
    what dense operands give, bit for bit."""
    pages: torch.Tensor
    page_table: torch.Tensor


def materialize(x):
    """Gather a :class:`PagedKV` view into a dense (B, n * page_size, KV,
    hd) tensor (anything else is returned as it is)."""
    if not isinstance(x, PagedKV):
        return x
    b, n = x.page_table.shape
    g = x.pages[x.page_table.long()]             # (B, n, ps, KV, hd)
    return g.reshape((b, n * g.shape[2]) + tuple(g.shape[3:]))

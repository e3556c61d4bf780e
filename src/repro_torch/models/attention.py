"""Grouped-query attention, dense KV cache: prefill and the decode read;
the encoder's uncached self-attention and cross-attention.

Layout: q (B, S, H, hd), k/v (B, T, KV, hd).  GQA is computed with
grouped einsums, no repeated heads.  ``attend`` runs the direct (masked)
attention up to ``FLASH_THRESHOLD`` positions and the flash recurrence
over KV chunks above it, as the reference does; both take k/v as dense
tensors or as ``paged_kv.PagedKV`` gather-views.  The decode reads take
the cache position as a host int (the bucket engine: every row at one
position) or as a ``(B,)`` device tensor (the slot pools: each row at
its own), and never copy a device position to the host.

An int8 cache (``kv_cache_dtype="int8"``) holds int8 codes with f32
scales per (row, position, KV head) (:func:`quantize_kv`); its decode
read factors the scales out of the dots, so no dequantized copy of the
cache is made.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from .. import resolve_device
from . import paged_kv
from ..dist.sharding import constrain_act
from .config import ModelConfig
from .layers import apply_rope, dense, rms_norm

FLASH_THRESHOLD = 2048   # direct attention up to here, flash above
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, KV, hd)
    v: torch.Tensor
    index: Any            # next write position: a host int, or (B,) int
    # int8 cache: k/v are int8 codes, scales (B, C, KV) f32
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (int8 codes, (...) f32 scales): the f32 amax over
    hd, ``max(amax, 1e-6) / 127``, round half to even, clip to +/-127.
    Both divisions are true divisions on either device (a Python-scalar
    divisor would become a multiply by its reciprocal on the card)."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_cache(batch: int, capacity: int, kv_heads: int, hd: int,
               dtype=torch.bfloat16, kv_cache_dtype: str = "",
               device="cuda") -> KVCache:
    """A zeroed cache; ``kv_cache_dtype='int8'`` allocates the int8 code
    buffers and their per-(B, C, KV) f32 scale buffers up front."""
    device = resolve_device(device)
    shape = (batch, capacity, kv_heads, hd)
    if kv_cache_dtype == "int8":
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       0,
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def _project_qkv(x, w, cfg: ModelConfig, positions=None, cim_cfg=None,
                 x_kv=None, rope: bool = True):
    """q from x; k and v from ``x_kv`` where given (cross-attention),
    else from x.  Rope at ``positions`` unless ``rope`` is False or no
    positions are given; k from ``x_kv`` takes positions 0..T-1."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    src = x if x_kv is None else x_kv
    t = src.shape[1]
    q = dense(x, w["wq"], cim_cfg).reshape(b, s, h, hd)
    k = dense(src, w["wk"], cim_cfg).reshape(b, t, kv, hd)
    v = dense(src, w["wv"], cim_cfg).reshape(b, t, kv, hd)
    if cfg.qk_norm and "q_norm" in w:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        kpos = (positions if x_kv is None
                else torch.arange(t, device=x.device))
        k = apply_rope(k, kpos, cfg.rope_theta)
    # anchor the operands: batch over DP, q-heads over TP where they
    # divide, the kv positions per mode
    q = constrain_act(q, ("batch", "seq", "head_count", "none"))
    k = constrain_act(k, ("batch", "kv_seq", "none", "none"))
    v = constrain_act(v, ("batch", "kv_seq", "none", "none"))
    return q, k, v


def _gqa_attend(q, k, v, mask):
    """q (B,S,H,hd) x k/v (B,T,KV,hd); additive mask (1,1,1,S,T) or None.
    Scores in f32, probabilities cast to q's dtype before the PV product,
    which accumulates in f32 and rounds once to q's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, s, h * hd)


def causal_mask(s: int, t: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """Additive (1, 1, 1, s, t) mask; query i sits at position offset + i
    and sees keys 0..offset + i (the last `window` of them when a window
    is set)."""
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok = ok & (kpos > qpos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)[None, None, None]


def flash_attention(q, k, v, cfg: ModelConfig, causal: bool = True,
                    q_offset=0, chunk: int = 512) -> torch.Tensor:
    """Memory-bounded attention: a loop over KV chunks carrying the
    running (max, denominator, accumulator), the flash recurrence in
    plain torch ops.  The (S, T) score matrix never exists, only one
    chunk's (S, chunk) scores.

    q (B,S,H,hd); k/v (B,T,KV,hd) or ``paged_kv.PagedKV`` views, which
    are gathered into dense K/V first.  q goes to f32 and is divided by
    sqrt(hd) in f32; K/V are zero-padded to a multiple of `chunk`; the
    mask (causal or ``kpos < T``, always ``kpos < T`` for the padding,
    and the sliding window when the config sets one) is rebuilt per
    chunk from positions, with query i at position q_offset + i.
    Masked scores are -1e30.  Returns (B, S, H*hd) in q's dtype."""
    k = paged_kv.materialize(k)
    v = paged_kv.materialize(v)
    b, s, h, hd = q.shape
    t = k.shape[1]
    kv = k.shape[2]
    rep = h // kv
    window = cfg.sliding_window
    pad = -t % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nc = k.shape[1] // chunk
    qg = (q.reshape(b, s, kv, rep, hd).float()
          / _root(hd, torch.float32))
    qpos = (torch.arange(s, device=q.device) + q_offset)[:, None]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    m = torch.full((b, s, kv, rep), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s, kv, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, kv, rep, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(nc):
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        sc = torch.einsum("bskrd,bukd->bskru", qg, kb)
        kpos = (c * chunk + torch.arange(chunk, device=q.device))[None, :]
        ok = kpos <= qpos if causal else kpos < t
        ok = ok & (kpos < t)                     # mask the padding
        if window:
            ok = ok & (kpos > qpos - window)
        sc = torch.where(ok[None, :, None, None, :], sc, neg)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskru,bukd->bskrd",
                                                   p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, s, h * hd).to(q.dtype)


def attend(q, k, v, cfg: ModelConfig, causal: bool = True, q_offset=0):
    """Dispatch: direct masked attention up to FLASH_THRESHOLD positions,
    flash above.  ``k``/``v`` may be ``paged_kv.PagedKV`` gather-views,
    gathered into dense (B, T, KV, hd) here, so both branches give what
    dense K/V give.  As in the reference, the direct branch offsets the
    mask by `q_offset` only when S != T, while flash always takes it."""
    k = paged_kv.materialize(k)
    v = paged_kv.materialize(v)
    s, t = q.shape[1], k.shape[1]
    if max(s, t) <= FLASH_THRESHOLD:
        off = q_offset if s != t else 0
        mask = (causal_mask(s, t, cfg.sliding_window, off, q.device)
                if causal else None)
        return _gqa_attend(q, k, v, mask)
    return flash_attention(q, k, v, cfg, causal=causal, q_offset=q_offset)


def self_attention(x, w, cfg: ModelConfig, positions=None, causal=True,
                   cim_cfg=None) -> torch.Tensor:
    """Attention of a whole sequence over itself, no cache: the
    encoder's (``causal=False``), roped at ``positions`` (0..S-1 by
    default, as in the reference, whose encoder ropes them too)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    return dense(attend(q, k, v, cfg, causal=causal), w["wo"], cim_cfg)


def cross_attention(x, x_kv, w, cfg: ModelConfig, cim_cfg=None
                    ) -> torch.Tensor:
    """Queries from x over keys and values projected from ``x_kv`` (the
    encoder's output, or patch embeddings): no rope, no mask."""
    q, k, v = _project_qkv(x, w, cfg, x_kv=x_kv, rope=False,
                           cim_cfg=cim_cfg)
    return dense(attend(q, k, v, cfg, causal=False), w["wo"], cim_cfg)


def rolling(cfg: ModelConfig, cap: int) -> bool:
    """Whether a cache of `cap` slots rolls: a windowed model's cache
    whose capacity is its window (the model caps it there), where the
    token at position p lives in slot p % window."""
    return bool(cfg.sliding_window) and cap == cfg.sliding_window


def prefill_attention(x, w, cfg: ModelConfig, cache: KVCache,
                      cim_cfg=None) -> tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; writes k/v into the cache in
    place (the reference returns an updated copy).  A rolling cache keeps
    the last min(S, window) positions, each at slot position % window,
    and zeros elsewhere (the cache comes in zeroed)."""
    b, s, _ = x.shape
    cap = cache.k.shape[1]
    roll = rolling(cfg, cap)
    if s > cap and not roll:
        raise ValueError(f"prompt of {s} tokens exceeds cache capacity "
                         f"{cap}")
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    out = attend(q, k, v, cfg, causal=True)
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if s <= cap:
        cache.k[:, :s] = k
        cache.v[:, :s] = v
    else:
        # positions s-cap .. s-1: slots r .. cap-1, then 0 .. r-1
        start = s - cap
        r = start % cap
        cache.k[:, r:] = k[:, start:start + cap - r]
        cache.v[:, r:] = v[:, start:start + cap - r]
        cache.k[:, :r] = k[:, start + cap - r:]
        cache.v[:, :r] = v[:, start + cap - r:]
    return dense(out, w["wo"], cim_cfg), KVCache(cache.k, cache.v, s)


def _root(hd: int, dtype) -> float:
    """sqrt(hd) rounded to the queries' dtype: the reference divides q by
    it BEFORE the dot.  Computed on the host, so no copy to the device
    (and no sync) happens per layer."""
    return float(torch.tensor(float(hd), dtype=dtype).sqrt())


def decode_attention_read(x, w, cfg: ModelConfig, cache: KVCache,
                          cim_cfg=None):
    """One-token decode that does not write the cache: attends over the
    cache's first `index` slots plus the fresh token's own k/v, merged
    with the flash two-block rule.  ``cache.index`` is a host int or a
    ``(B,)`` device tensor of per-row positions.  A rolling cache
    (:func:`rolling`) attends over its first min(index, cap) slots but
    the slot ``index % cap`` that the fresh token will overwrite (it
    holds the position that just left the window).  Returns (out, k_new
    (B,1,KV,hd), v_new)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("decode_attention_read is single-token")
    pos = cache.index
    ck, cv = cache.k, cache.v
    cap = ck.shape[1]
    roll = rolling(cfg, cap)
    kpos = torch.arange(cap, device=x.device)
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(b, 1)
        p = pos[:, None]
        valid = ((kpos < torch.clamp(p, max=cap)) & (kpos != p % cap)
                 if roll else kpos < p)[:, None, None, None, :]
    else:
        positions = torch.full((1, 1), pos, dtype=torch.int64,
                               device=x.device)
        valid = ((kpos < min(pos, cap)) & (kpos != pos % cap)
                 if roll else kpos < pos)
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    h, hd = q.shape[2], q.shape[3]
    kv = ck.shape[2]
    rep = h // kv
    qg = (q / _root(hd, q.dtype)).reshape(b, 1, kv, rep, hd)
    int8_kv = cache.k_scale is not None
    sc = torch.einsum("bskrd,btkd->bkrst", qg.float(), ck.float())
    if int8_kv:
        # s = k_scale * (q . k8): the scales factor out of the dot
        sc = sc * cache.k_scale.permute(0, 2, 1)[:, :, None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sc = sc + torch.where(valid, zero, NEG_INF)
    m_c = sc.amax(dim=-1)                                  # (b,kv,rep,1)
    p_c = torch.exp(sc - m_c[..., None])
    l_c = p_c.sum(dim=-1)
    if int8_kv:
        # acc = sum (p * v_scale) v8, the weights rounded to q's dtype
        p_eff = (p_c * cache.v_scale.permute(0, 2, 1)[:, :, None, None, :]
                 ).to(q.dtype)
        acc_c = torch.einsum("bkrst,btkd->bkrsd", p_eff.float(),
                             cv.float())
    else:
        acc_c = torch.einsum("bkrst,btkd->bkrsd", p_c.to(ck.dtype).float(),
                             cv.float())
    s_n = torch.einsum("bskrd,bukd->bkrs", qg.float(), k.float())
    v_n = v.float()[:, 0]                                  # (b, kv, hd)
    m = torch.maximum(m_c, s_n)
    w_c = torch.exp(m_c - m)
    w_n = torch.exp(s_n - m)
    acc = acc_c * w_c[..., None] + w_n[..., None] * v_n[:, :, None, None, :]
    l = l_c * w_c + w_n
    out = (acc / l[..., None]).to(q.dtype)                 # (b,kv,rep,1,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * hd)
    if int8_kv:
        # the caller quantizes the fresh k/v into the cache
        return dense(out, w["wo"], cim_cfg), k, v
    return (dense(out, w["wo"], cim_cfg), k.to(ck.dtype), v.to(cv.dtype))


def decode_attention(x, w, cfg: ModelConfig, cache: KVCache, cim_cfg=None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode that writes the fresh k/v into the cache first
    (in place) and then attends over the written slots, as the
    reference's ``decode_attention`` does (the hybrid family's shared
    block).  ``cache.index`` is a host int or a ``(B,)`` device tensor
    of per-row positions; a rolling cache writes slot pos % cap, any
    other clamps the slot at cap - 1.  Returns (out, the cache at
    index + 1)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("decode_attention is single-token")
    pos = cache.index
    cap = cache.k.shape[1]
    roll = rolling(cfg, cap)
    kpos = torch.arange(cap, device=x.device)
    if isinstance(pos, torch.Tensor):
        positions = pos.reshape(b, 1)
        p = pos[:, None].long()
        slot = (pos % cap if roll else torch.clamp(pos, max=cap - 1)).long()
        valid = (kpos < torch.clamp(p + 1, max=cap) if roll
                 else kpos <= p)[:, None, None, None, :]
    else:
        positions = torch.full((1, 1), pos, dtype=torch.int64,
                               device=x.device)
        slot = pos % cap if roll else min(pos, cap - 1)
        valid = kpos < min(pos + 1, cap) if roll else kpos <= pos
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    if isinstance(slot, torch.Tensor):
        rows = torch.arange(b, device=x.device)
        cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    else:
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    out = _gqa_attend(q, cache.k, cache.v, torch.where(valid, zero, NEG_INF))
    return (dense(out, w["wo"], cim_cfg),
            KVCache(cache.k, cache.v, pos + 1))


def paged_decode_attention_read(x, w, cfg: ModelConfig, k_pages, v_pages,
                                page_table, pos, plan, cim_cfg=None):
    """Batched one-token decode read straight off one layer's page pool:
    the planned ``attention`` executor (``kernels.paged_attention``)
    consumes the page table itself, so the gathered dense copy of the
    ``slot_view`` path never exists.  The executor returns the flash
    statistics over the pooled context; the fresh token's own k/v merge
    in with the two-block rule of ``decode_attention_read`` and the same
    masking constant.

    ``x`` is (S, 1, d): all S slots in one call; ``pos`` (S,) int32.
    Returns (out (S, 1, d), k_new (S, KV, hd), v_new)."""
    from ..kernels import execute
    from ..kernels.paged_attention import PagedAttentionKV
    s_dim, s1, _ = x.shape
    if s1 != 1:
        raise ValueError("paged decode read is single-token")
    q, k, v = _project_qkv(x, w, cfg, pos[:, None], cim_cfg)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rep = h // kvh
    qg = (q / _root(hd, q.dtype)).reshape(s_dim, kvh, rep, hd)
    acc_c, m_c, l_c = execute(
        plan, qg, PagedAttentionKV(k_pages, v_pages, page_table, pos))
    # the fresh token's block, then the two-block merge: a slot with no
    # live context comes back with m_c = -1e30 and is weighed by
    # exp(-1e30 - s_n) = 0, leaving the fresh token alone
    s_n = torch.einsum("skrd,skd->skr", qg.float(), k[:, 0].float())
    v_n = v.float()[:, 0]                                  # (S, KV, hd)
    m = torch.maximum(m_c, s_n)
    w_c = torch.exp(m_c - m)
    w_n = torch.exp(s_n - m)
    acc = acc_c * w_c[..., None] + w_n[..., None] * v_n[:, :, None, :]
    l = l_c * w_c + w_n
    out = (acc / l[..., None]).to(q.dtype).reshape(s_dim, 1, h * hd)
    return dense(out, w["wo"], cim_cfg), k[:, 0], v[:, 0]

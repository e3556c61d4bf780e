"""Grouped-query attention, dense KV cache: prefill and the decode read.

Layout: q (B, S, H, hd), k/v (B, T, KV, hd).  GQA is computed with
grouped einsums, no repeated heads.  Only the direct (masked) attention
is ported: above ``FLASH_THRESHOLD`` positions the reference switches to
a flash recurrence, which is not ported yet, and ``attend`` raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import ModelConfig
from .layers import apply_rope, dense

FLASH_THRESHOLD = 2048
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, KV, hd)
    v: torch.Tensor
    index: int            # next write position (absolute), host-known


def _project_qkv(x, w, cfg: ModelConfig, positions, cim_cfg=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = dense(x, w["wq"], cim_cfg).reshape(b, s, h, hd)
    k = dense(x, w["wk"], cim_cfg).reshape(b, s, kv, hd)
    v = dense(x, w["wv"], cim_cfg).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_attend(q, k, v, mask):
    """q (B,S,H,hd) x k/v (B,T,KV,hd); additive mask (1,1,1,S,T).
    Scores in f32, probabilities cast to q's dtype before the PV product,
    which accumulates in f32 and rounds once to q's dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    qg = q.reshape(b, s, kv, rep, hd)
    scores = torch.einsum("bskrd,btkd->bkrst", qg.float(), k.float())
    scores = scores / math.sqrt(hd) + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, s, h * hd)


def causal_mask(s: int, t: int, device=None) -> torch.Tensor:
    """Additive (1, 1, 1, s, t) mask: query i sees keys 0..i."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kpos <= qpos, zero, NEG_INF)[None, None, None]


def attend(q, k, v):
    """Direct causal attention of a prompt over itself, up to
    FLASH_THRESHOLD positions."""
    s, t = q.shape[1], k.shape[1]
    if max(s, t) > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"attention over {max(s, t)} positions needs flash_attention "
            f"(the reference's path above {FLASH_THRESHOLD} positions), "
            f"which is not ported yet")
    return _gqa_attend(q, k, v, causal_mask(s, t, q.device))


def prefill_attention(x, w, cfg: ModelConfig, cache: KVCache,
                      cim_cfg=None) -> tuple[torch.Tensor, KVCache]:
    """Causal attention over the prompt; writes k/v into the cache in
    place (the reference returns an updated copy)."""
    b, s, _ = x.shape
    if s > cache.k.shape[1]:
        raise ValueError(f"prompt of {s} tokens exceeds cache capacity "
                         f"{cache.k.shape[1]}")
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    out = attend(q, k, v)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    return dense(out, w["wo"], cim_cfg), KVCache(cache.k, cache.v, s)


def decode_attention_read(x, w, cfg: ModelConfig, cache: KVCache,
                          cim_cfg=None):
    """One-token decode that does not write the cache: attends over the
    cache's first `index` slots plus the fresh token's own k/v, merged
    with the flash two-block rule.  Returns (out, k_new (B,1,KV,hd),
    v_new)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("decode_attention_read is single-token")
    pos = cache.index
    positions = torch.full((1, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(x, w, cfg, positions, cim_cfg)
    ck, cv = cache.k, cache.v
    cap = ck.shape[1]
    valid = torch.arange(cap, device=x.device) < pos
    h, hd = q.shape[2], q.shape[3]
    kv = ck.shape[2]
    rep = h // kv
    # divide by sqrt(hd) rounded to q's dtype BEFORE the dot, as the
    # reference does; the divisor is computed on the host, so no copy to
    # the device (and no sync) happens per layer
    root = float(torch.tensor(float(hd), dtype=q.dtype).sqrt())
    qg = (q / root).reshape(b, 1, kv, rep, hd)
    sc = torch.einsum("bskrd,btkd->bkrst", qg.float(), ck.float())
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sc = sc + torch.where(valid, zero, NEG_INF)
    m_c = sc.amax(dim=-1)                                  # (b,kv,rep,1)
    p_c = torch.exp(sc - m_c[..., None])
    l_c = p_c.sum(dim=-1)
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
    return (dense(out, w["wo"], cim_cfg), k.to(ck.dtype), v.to(cv.dtype))

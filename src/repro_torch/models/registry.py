"""Decoder-only transformer (dense and MoE families) over a params dict.

Params mirror the reference's tree: ``embed`` (V, d), ``unembed``
(d, V), ``final_norm`` (d,), and ``blocks`` whose leaves carry a leading
layer axis (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``w1``,
``w2``, ``w3``, and ``q_norm`` / ``k_norm`` (L, hd) where the config
sets ``qk_norm``).  An MoE model's ``w1``/``w3`` are (L, E, d, f), its
``w2`` (L, E, f, d), and it has an f32 ``router`` (L, d, E)
(``models/moe.py``).  Packed weights are ``PackedTernary`` with the same
leading axes; the layer loop slices them.  Every attention and
unembedding matmul goes through ``layers.dense`` and so through the CIM
modes; the experts through ``moe.expert_product``.

A windowed model (``sliding_window > 0``) caps its cache at the window;
a cache of the window's capacity rolls (``attention.rolling``: position
p in slot p % window).

Decode comes in three forms: ``decode`` over a dense cache whose position
is a host int (the bucket engine) or a ``(B,)`` device tensor (the
continuous ``Scheduler``'s slot pool, each row at its own position);
``decode_paged``, which gathers every slot's pages into that dense layout
(``paged_kv.slot_view``); and ``decode_paged_fused``, whose attention
read takes the page table itself (``kernels.paged_attention``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .. import resolve_device
from . import attention as attn
from . import moe
from .config import ModelConfig, ParamSpec
from .layers import dense, rms_norm, swiglu


FAMILIES = ("dense", "moe")


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


class TransformerLM:
    """Decoder-only transformer, dense or MoE: init, prefill, decode."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ported: "
                f"{FAMILIES})")
        if cfg.kv_cache_dtype == "int8":
            raise NotImplementedError("int8 KV caches are not ported yet")
        self.cfg = cfg
        self.param_specs = self._param_specs()

    def _param_specs(self) -> dict:
        cfg = self.cfg
        d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.hd, cfg.d_ff)
        v, L = cfg.padded_vocab, (cfg.num_layers,)
        blocks = {"ln1": ParamSpec(L + (d,), "ones"),
                  "ln2": ParamSpec(L + (d,), "ones"),
                  "wq": ParamSpec(L + (d, h * hd)),
                  "wk": ParamSpec(L + (d, kv * hd)),
                  "wv": ParamSpec(L + (d, kv * hd)),
                  "wo": ParamSpec(L + (h * hd, d))}
        if cfg.num_experts:
            blocks.update(moe.moe_defs(cfg, cfg.num_layers))
        else:
            blocks.update(w1=ParamSpec(L + (d, f)), w2=ParamSpec(L + (f, d)),
                          w3=ParamSpec(L + (d, f)))
        if cfg.qk_norm:
            blocks["q_norm"] = ParamSpec(L + (hd,), "ones")
            blocks["k_norm"] = ParamSpec(L + (hd,), "ones")
        return {"embed": ParamSpec((v, d), "embed"),
                "unembed": ParamSpec((d, v)),
                "final_norm": ParamSpec((d,), "ones"),
                "blocks": blocks}

    def init(self, generator: torch.Generator, device="cuda",
             dtype=None) -> dict:
        """Random parameters from a seeded generator (on `device`)."""
        device = resolve_device(device)
        dtype = dtype or self.cfg.dtype

        def mk(tree):
            return {k: (mk(v) if isinstance(v, dict)
                        else v.initialize(generator, device, dtype))
                    for k, v in tree.items()}
        return mk(self.param_specs)

    def init_packed(self, generator: torch.Generator, cim, device="cuda",
                    dtype=None) -> dict:
        """Random parameters packed as ``ternarize_params(init(...),
        cim)`` packs them, but drawn and packed one layer at a time:
        leaf by leaf in the order of ``param_specs``, a leaf that would
        be packed is drawn one layer at a time (a 2-D one whole), each
        layer's draw packed into the stacked result and freed before the
        next, so the float tree never exists (mixtral-8x7b's is 93 GB in
        bf16); the other leaves are drawn whole.  The values are not
        ``init``'s: one stacked draw and L per-layer draws take
        different runs of the generator."""
        from ..core.cim_linear import _packable
        from ..kernels.ops import PackedTernary, pack_weights
        device = resolve_device(device)
        dtype = dtype or self.cfg.dtype

        def leaf(name, spec):
            probe = torch.empty(spec.shape, dtype=spec.dtype or dtype,
                                device="meta")
            if not _packable(name, probe):
                return spec.initialize(generator, device, dtype)
            if len(spec.shape) == 2:
                return pack_weights(spec.initialize(generator, device,
                                                    dtype),
                                    cim.packing, cim.num_trits)
            data = scale = None
            for i in range(spec.shape[0]):
                one = pack_weights(
                    spec._replace(shape=spec.shape[1:]).initialize(
                        generator, device, dtype),
                    cim.packing, cim.num_trits)
                if data is None:
                    data = one.data.new_empty((spec.shape[0],)
                                              + tuple(one.data.shape))
                    scale = one.scale.new_empty((spec.shape[0],)
                                                + tuple(one.scale.shape))
                data[i], scale[i] = one.data, one.scale
                del one
            return PackedTernary(data, scale, cim.packing)

        def mk(tree):
            return {k: (mk(v) if isinstance(v, dict) else leaf(k, v))
                    for k, v in tree.items()}
        return mk(self.param_specs)

    def param_bytes(self, dtype=None) -> int:
        """Bytes of the float parameters ``init`` would draw."""
        dtype = dtype or self.cfg.dtype

        def walk(tree):
            return sum(walk(v) if isinstance(v, dict) else
                       math.prod(v.shape) * (v.dtype or dtype).itemsize
                       for v in tree.values())
        return walk(self.param_specs)

    def init_cache(self, batch: int, capacity: int, device) -> dict:
        """A zeroed dense cache of ``capacity`` positions, capped at the
        window for a windowed model (the reference's ``cache_defs``)."""
        cfg = self.cfg
        if cfg.sliding_window:
            capacity = min(capacity, cfg.sliding_window)
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "pos": 0}

    def _mlp(self, x, wl, cim):
        if self.cfg.num_experts:
            return moe.moe_block(x, wl, self.cfg, cim)[0]
        return swiglu(x, wl["w1"], wl["w3"], wl["w2"], cim)

    def prefill(self, params: dict, tokens: torch.Tensor, capacity: int,
                cim=None) -> tuple[torch.Tensor, dict]:
        """Consume a (B, S) prompt; returns (last-position logits
        (B, 1, V), state)."""
        cfg = self.cfg
        b, s = tokens.shape
        state = self.init_cache(b, capacity, tokens.device)
        x = params["embed"][tokens.long()].to(cfg.dtype)
        blocks = params["blocks"]
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(state["k"][i], state["v"][i], 0)
            out, _ = attn.prefill_attention(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
        state["pos"] = s
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    def _decode_read_layers(self, params, x, state, cim):
        """The read-only decode layer loop: each layer attends over its
        (stale) cache plus the fresh token.  Returns x and every layer's
        new k/v, (L, B, KV, hd) each, for one write after the loop, as
        the reference's scan does.  ``state`` is the dense cache or a
        paged gather view (same layout)."""
        cfg = self.cfg
        blocks = params["blocks"]
        kts, vts = [], []
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(state["k"][i], state["v"][i], state["pos"])
            out, kt, vt = attn.decode_attention_read(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
            kts.append(kt[:, 0])
            vts.append(vt[:, 0])
        return x, torch.stack(kts), torch.stack(vts)

    def decode(self, params: dict, token: torch.Tensor, state: dict,
               cim=None) -> tuple[torch.Tensor, dict]:
        """One-token step: token (B, 1) -> logits (B, 1, V).  Writes the
        new k/v into the cache in place and advances ``state['pos']``: a
        host int (every row at one position) or a (B,) device tensor
        (each row at its own).  A rolling cache writes slot pos % cap;
        any other, past capacity, writes the last slot, as the
        reference's clamped dynamic_update_slice does.  A host position
        stays on the host, a device one on the device."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x, kts, vts = self._decode_read_layers(params, x, state, cim)
        pos = state["pos"]
        cap = state["k"].shape[2]
        roll = attn.rolling(cfg, cap)
        if isinstance(pos, torch.Tensor):
            rows = torch.arange(pos.shape[0], device=pos.device)
            slot = (pos % cap if roll
                    else torch.clamp(pos, max=cap - 1)).long()
            state["k"][:, rows, slot] = kts
            state["v"][:, rows, slot] = vts
        else:
            slot = pos % cap if roll else min(pos, cap - 1)
            state["k"][:, :, slot] = kts
            state["v"][:, :, slot] = vts
        state["pos"] = pos + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    @property
    def supports_paged_kv(self) -> bool:
        """The full-cache read-then-write decode pages cleanly; a
        windowed model decodes against a rolling cache (slot = pos %
        window, engaged only when the capacity is the window) that a
        page-gathered view's capacity would silently disarm, so it
        serves from the dense pool, as in the reference."""
        return not self.cfg.sliding_window

    def decode_paged(self, params: dict, tokens: torch.Tensor, pool,
                     page_table: torch.Tensor, pos: torch.Tensor, cim=None
                     ) -> tuple:
        """One-token decode of every slot against the page pool through
        the gather: ``paged_kv.slot_view`` copies each slot's pages into
        the dense layout, then the read-only layer loop runs on it.
        tokens (S, 1), page_table (S, W), pos (S,).  Returns (logits
        (S, 1, V), kts (L, S, KV, hd), vts) in the compute dtype, for
        ``paged_kv.append_tokens``."""
        from . import paged_kv
        cfg = self.cfg
        view = paged_kv.slot_view(pool, page_table, pos)
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x, kts, vts = self._decode_read_layers(params, x, view, cim)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), kts, vts

    def decode_paged_fused(self, params: dict, tokens: torch.Tensor, pool,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           cim=None, attn_plan=None) -> tuple:
        """One-token decode of every slot straight off the page pool: each
        layer's attention read runs the planned executor (``attn_plan``,
        an ``op='attention'`` plan) on that layer's raw pages through the
        page table.  tokens (S,), page_table (S, W) int32, pos (S,)
        int32.  Returns (logits (S, 1, V), kts (L, S, KV, hd), vts) in
        the compute dtype, for ``paged_kv.append_tokens``."""
        if attn_plan is None:
            raise ValueError("decode_paged_fused needs a resolved "
                             "attention plan (PagedScheduler resolves "
                             "one per pool geometry)")
        from . import paged_kv
        cfg = self.cfg
        k_pages, v_pages = paged_kv.raw_pool_view(pool)
        x = params["embed"][tokens[:, None].long()].to(cfg.dtype)
        blocks = params["blocks"]
        kts, vts = [], []
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            out, kt, vt = attn.paged_decode_attention_read(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, k_pages[i],
                v_pages[i], page_table, pos, attn_plan, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
            kts.append(kt)
            vts.append(vt)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (dense(x, params["unembed"], cim), torch.stack(kts),
                torch.stack(vts))


def build(cfg: ModelConfig) -> Any:
    if cfg.family in FAMILIES:
        return TransformerLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")

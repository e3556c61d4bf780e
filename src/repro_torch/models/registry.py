"""The model families over a params dict: the decoder-only transformer
(dense and MoE, ``TransformerLM``), the hybrid Mamba2 backbone with one
shared attention block (``ZambaModel``) and the xLSTM stack
(``XLSTMModel``).  ``BaseModel`` holds what they share: ``init``,
``init_packed``, ``param_bytes`` and ``init_cache`` from each family's
parameter and decode-state specs.

TransformerLM.

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
read takes the page table itself (``kernels.paged_attention``).  An
int8 cache (``kv_cache_dtype="int8"``) adds ``k_scale``/``v_scale``
leaves; prefill builds the cache in the compute dtype and then quantizes
it, and the decode write quantizes each fresh k/v (the reference writes
``quantize_kv`` of the fresh k/v first cast to int8, which truncates
them; the port quantizes them as computed, ROADMAP queue 3).  The fused
paged read is float-KV only.

ZambaModel: ``cfg.num_layers`` Mamba2 layers (``models/ssm.py``); after
every ``cfg.attn_every`` of them the one shared, weight-tied attention +
SwiGLU block, with a KV cache of its own per invocation.  XLSTMModel:
``num_layers / 2`` (mLSTM, sLSTM) pairs.  Their decode state is the
recurrent carries (``h``/``conv``; ``m_*``/``s_*``), written in place
per layer; neither pages.

Every decode-state leaf but ``pos`` carries the batch (slot) at dim 1,
which is what the serving pools copy and pass.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .. import resolve_device
from . import attention as attn
from . import moe, ssm
from .config import ModelConfig, ParamSpec
from .layers import dense, rms_norm, swiglu


FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _probe(spec: ParamSpec, dtype) -> torch.Tensor:
    """A storage-free tensor of the leaf's shape and dtype."""
    return torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta")


def _default_packs(path: tuple, x) -> bool:
    """``ternarize_params``'s default predicate."""
    from ..core.cim_linear import _packable
    return _packable(path[-1] if path else "", x)


def _walk(tree: dict, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


class BaseModel:
    """What every family shares: the parameter specs (``param_specs``),
    the decode-state specs (``cache_specs``), and the draws, the byte
    count and the zeroed decode state made from them.  A family says
    which leaves it reads through ``layers.dense`` (``matmul_leaf``):
    those are the ones packing may replace."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.param_specs = self._param_specs()

    def _param_specs(self) -> dict:
        raise NotImplementedError

    def cache_specs(self, batch: int, capacity: int) -> dict:
        """The decode state's leaves as ``ParamSpec`` (zeros or ones; a
        dtype of None is the model's), each with the batch at dim 1."""
        raise NotImplementedError

    def matmul_leaf(self, path: tuple) -> bool:
        """Whether the leaf at ``path`` is a weight the model reads
        through ``layers.dense``."""
        raise NotImplementedError

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
                    dtype=None, predicate=None) -> dict:
        """Random parameters packed as ``ternarize_params(init(...), cim,
        predicate)`` packs them, but drawn and packed one layer at a time:
        leaf by leaf in the order of ``param_specs``, a leaf that would
        be packed is drawn one layer at a time (a 2-D one whole), each
        layer's draw packed into the stacked result and freed before the
        next, so the float tree never exists (mixtral-8x7b's is 93 GB in
        bf16); the other leaves are drawn whole.  The values are not
        ``init``'s: one stacked draw and L per-layer draws take
        different runs of the generator."""
        from ..kernels.ops import PackedTernary, pack_weights
        device = resolve_device(device)
        dtype = dtype or self.cfg.dtype
        pred = predicate or _default_packs

        def leaf(path, spec):
            if not pred(path, _probe(spec, dtype)):
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

        def mk(tree, path):
            return {k: (mk(v, path + (k,)) if isinstance(v, dict)
                        else leaf(path + (k,), v))
                    for k, v in tree.items()}
        return mk(self.param_specs, ())

    def param_bytes(self, dtype=None) -> int:
        """Bytes of the float parameters ``init`` would draw."""
        dtype = dtype or self.cfg.dtype

        def walk(tree):
            return sum(walk(v) if isinstance(v, dict) else
                       math.prod(v.shape) * (v.dtype or dtype).itemsize
                       for v in tree.values())
        return walk(self.param_specs)

    def init_cache(self, batch: int, capacity: int, device) -> dict:
        """A zeroed decode state (the reference's ``cache_defs``), its
        host position 0."""
        device = resolve_device(device)
        state = {k: spec.initialize(None, device, self.cfg.dtype)
                 for k, spec in self.cache_specs(batch, capacity).items()}
        state["pos"] = 0
        return state

    def pack_predicate(self, path: tuple, x) -> bool:
        """The default predicate narrowed to the weights read through
        ``layers.dense``: what a packed model can serve."""
        return _default_packs(path, x) and self.matmul_leaf(path)

    def packing_faults(self, dtype=None) -> list:
        """The leaves (dotted paths) that ``ternarize_params``'s default
        predicate packs but that the model reads outside its matmuls: a
        stacked norm or bias of 64 layers or more (zamba2-7b's 81), or
        sLSTM's recurrent ``wr`` at a head dim of 64 or more.  The
        reference packs them and then fails (ROADMAP queue 3)."""
        dtype = dtype or self.cfg.dtype
        return [".".join(path) for path, spec in _walk(self.param_specs)
                if _default_packs(path, _probe(spec, dtype))
                and not self.matmul_leaf(path)]

    @property
    def supports_paged_kv(self) -> bool:
        """Families whose decode state is not a plain per-position KV
        cache serve from the dense slot pool."""
        return False

    def decode_paged(self, params, tokens, pool, page_table, pos, cim=None):
        raise NotImplementedError(
            f"paged KV decode is not implemented for "
            f"{type(self).__name__} (family {self.cfg.family!r}); serve "
            f"it from the dense slot pool")

    def decode_paged_fused(self, params, tokens, pool, page_table, pos,
                           cim=None, attn_plan=None):
        raise NotImplementedError(
            f"fused paged decode is not implemented for "
            f"{type(self).__name__} (family {self.cfg.family!r}); serve "
            f"it through the slot_view gather path")


class TransformerLM(BaseModel):
    """Decoder-only transformer, dense or MoE: init, prefill, decode."""

    MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "unembed")

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

    def matmul_leaf(self, path: tuple) -> bool:
        return path[-1] in self.MATMULS

    def cache_specs(self, batch: int, capacity: int) -> dict:
        """A dense cache of ``capacity`` positions, capped at the window
        for a windowed model; an int8 cache holds int8 codes and f32
        scales per (row, position, KV head)."""
        cfg = self.cfg
        if cfg.sliding_window:
            capacity = min(capacity, cfg.sliding_window)
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.hd)
        if cfg.kv_cache_dtype != "int8":
            return {"k": ParamSpec(shape, "zeros"),
                    "v": ParamSpec(shape, "zeros")}
        return {"k": ParamSpec(shape, "zeros", torch.int8),
                "v": ParamSpec(shape, "zeros", torch.int8),
                "k_scale": ParamSpec(shape[:-1], "zeros", torch.float32),
                "v_scale": ParamSpec(shape[:-1], "zeros", torch.float32)}

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
        int8_kv = cfg.kv_cache_dtype == "int8"
        # an int8 cache is built in the compute dtype, then quantized
        kc = (torch.zeros(state["k"].shape, dtype=cfg.dtype,
                          device=tokens.device) if int8_kv else state["k"])
        vc = torch.zeros_like(kc) if int8_kv else state["v"]
        x = params["embed"][tokens.long()].to(cfg.dtype)
        blocks = params["blocks"]
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(kc[i], vc[i], 0)
            out, _ = attn.prefill_attention(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
        if int8_kv:
            state["k"], state["k_scale"] = attn.quantize_kv(kc)
            state["v"], state["v_scale"] = attn.quantize_kv(vc)
        state["pos"] = s
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    def _decode_read_layers(self, params, x, state, cim):
        """The read-only decode layer loop: each layer attends over its
        (stale) cache plus the fresh token.  Returns x and every layer's
        new k/v, (L, B, KV, hd) each in the compute dtype (the cache's
        dtype for a float cache), for one write after the loop, as the
        reference's scan does.  ``state`` is the dense cache or a paged
        gather view (same layout, scales included for int8)."""
        cfg = self.cfg
        blocks = params["blocks"]
        int8_kv = "k_scale" in state
        kts, vts = [], []
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(
                state["k"][i], state["v"][i], state["pos"],
                state["k_scale"][i] if int8_kv else None,
                state["v_scale"][i] if int8_kv else None)
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
        reference's clamped dynamic_update_slice does.  An int8 cache
        stores the codes and scales of the fresh k/v.  A host position
        stays on the host, a device one on the device."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x, kts, vts = self._decode_read_layers(params, x, state, cim)
        pos = state["pos"]
        cap = state["k"].shape[2]
        roll = attn.rolling(cfg, cap)
        writes = {"k": kts, "v": vts}
        if "k_scale" in state:
            writes["k"], writes["k_scale"] = attn.quantize_kv(kts)
            writes["v"], writes["v_scale"] = attn.quantize_kv(vts)
        if isinstance(pos, torch.Tensor):
            rows = torch.arange(pos.shape[0], device=pos.device)
            slot = (pos % cap if roll
                    else torch.clamp(pos, max=cap - 1)).long()
            for name, val in writes.items():
                state[name][:, rows, slot] = val
        else:
            slot = pos % cap if roll else min(pos, cap - 1)
            for name, val in writes.items():
                state[name][:, :, slot] = val
        state["pos"] = pos + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    @property
    def supports_paged_kv(self) -> bool:
        """The full-cache read-then-write decode pages cleanly (an int8
        pool with its scale pages); a
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


def _attn_specs(cfg: ModelConfig) -> dict:
    """One attention block's weights (unstacked)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    specs = {"wq": ParamSpec((d, h * hd)), "wk": ParamSpec((d, kv * hd)),
             "wv": ParamSpec((d, kv * hd)), "wo": ParamSpec((h * hd, d))}
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), "ones")
        specs["k_norm"] = ParamSpec((hd,), "ones")
    return specs


def _embed_specs(cfg: ModelConfig) -> dict:
    return {"embed": ParamSpec((cfg.padded_vocab, cfg.d_model), "embed"),
            "unembed": ParamSpec((cfg.d_model, cfg.padded_vocab)),
            "final_norm": ParamSpec((cfg.d_model,), "ones")}


class ZambaModel(BaseModel):
    """``cfg.num_layers`` Mamba2 layers; after every ``cfg.attn_every`` of
    them the one shared (weight-tied) attention + SwiGLU block runs,
    with a KV cache of its own per invocation (``n_groups`` of them),
    then ``n_tail`` Mamba2 layers.  The shared block writes its fresh
    k/v before it attends (``attention.decode_attention``), at a host
    position or at a (B,) device position per row."""

    MAMBA_MATMULS = ("in_proj", "out_proj")

    @property
    def n_groups(self) -> int:
        return self.cfg.num_layers // self.cfg.attn_every

    @property
    def n_tail(self) -> int:
        return self.cfg.num_layers - self.n_groups * self.cfg.attn_every

    def _param_specs(self) -> dict:
        cfg = self.cfg
        L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
        return {**_embed_specs(cfg),
                "mamba_ln": ParamSpec((L, d), "ones"),
                "mamba": ssm.mamba2_defs(cfg, L),
                "shared_ln": ParamSpec((d,), "ones"),
                "shared_attn": _attn_specs(cfg),
                "shared_mlp_ln": ParamSpec((d,), "ones"),
                "shared_mlp": {"w1": ParamSpec((d, f)),
                               "w2": ParamSpec((f, d)),
                               "w3": ParamSpec((d, f))}}

    def matmul_leaf(self, path: tuple) -> bool:
        if path[0] == "mamba":
            return path[-1] in self.MAMBA_MATMULS
        if path[0] == "shared_attn":
            return path[-1] in ("wq", "wk", "wv", "wo")
        return path[0] in ("shared_mlp", "unembed")

    def cache_specs(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        L, ng = cfg.num_layers, self.n_groups
        d_inner, heads, hd, st, groups, conv_dim = ssm.mamba2_dims(cfg)
        kv = (ng, batch, capacity, cfg.num_kv_heads, cfg.hd)
        return {"h": ParamSpec((L, batch, heads, hd, st), "zeros",
                               torch.float32),
                "conv": ParamSpec((L, batch, 3, conv_dim), "zeros"),
                "k": ParamSpec(kv, "zeros"),
                "v": ParamSpec(kv, "zeros")}

    def _mamba(self, x, params, i, state, cim):
        """Mamba2 layer i, its carried state updated in place."""
        cfg = self.cfg
        wl = _layer(params["mamba"], i)
        st = ssm.Mamba2State(state["h"][i], state["conv"][i], state["pos"])
        h, new = ssm.mamba2_block(
            rms_norm(x, params["mamba_ln"][i], cfg.norm_eps), wl, cfg, st,
            cim)
        state["h"][i] = new.h
        state["conv"][i] = new.conv
        return x + h

    def _run(self, params, x, state, prefill: bool, cim):
        cfg = self.cfg
        shared = params["shared_attn"]
        layer = 0
        for g in range(self.n_groups):
            for _ in range(cfg.attn_every):
                x = self._mamba(x, params, layer, state, cim)
                layer += 1
            cache = attn.KVCache(state["k"][g], state["v"][g],
                                 0 if prefill else state["pos"])
            xa = rms_norm(x, params["shared_ln"], cfg.norm_eps)
            if prefill:
                h, _ = attn.prefill_attention(xa, shared, cfg, cache, cim)
            else:
                h, _ = attn.decode_attention(xa, shared, cfg, cache, cim)
            x = x + h
            wm = params["shared_mlp"]
            x = x + swiglu(rms_norm(x, params["shared_mlp_ln"],
                                    cfg.norm_eps),
                           wm["w1"], wm["w3"], wm["w2"], cim)
        for _ in range(self.n_tail):
            x = self._mamba(x, params, layer, state, cim)
            layer += 1
        return x

    def prefill(self, params: dict, tokens: torch.Tensor, capacity: int,
                cim=None) -> tuple[torch.Tensor, dict]:
        """A (B, S) prompt from an empty state -> (last-position logits
        (B, 1, V), state)."""
        cfg = self.cfg
        b, s = tokens.shape
        state = self.init_cache(b, capacity, tokens.device)
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x = self._run(params, x, state, True, cim)
        state["pos"] = s
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    def decode(self, params: dict, token: torch.Tensor, state: dict,
               cim=None) -> tuple[torch.Tensor, dict]:
        """One-token step: token (B, 1) -> logits (B, 1, V); the state is
        updated in place and ``pos`` (a host int or (B,) tensor)
        advances."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x = self._run(params, x, state, False, cim)
        state["pos"] = state["pos"] + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state


class XLSTMModel(BaseModel):
    """``num_layers / 2`` (mLSTM, sLSTM) pairs; a prompt starts from the
    zero state, decode carries each pair's states."""

    MATMULS = {"mlstm": ("up", "wq", "wk", "wv", "wif", "down"),
               "slstm": ("wx", "up1", "up2")}
    STATE = ("m_C", "m_n", "m_m", "s_c", "s_n", "s_m", "s_h")

    @property
    def n_pairs(self) -> int:
        return self.cfg.num_layers // 2

    def _param_specs(self) -> dict:
        cfg = self.cfg
        n = self.n_pairs
        return {**_embed_specs(cfg),
                "m_ln": ParamSpec((n, cfg.d_model), "ones"),
                "s_ln": ParamSpec((n, cfg.d_model), "ones"),
                "mlstm": ssm.mlstm_defs(cfg, n),
                "slstm": ssm.slstm_defs(cfg, n)}

    def matmul_leaf(self, path: tuple) -> bool:
        if path[0] in self.MATMULS:
            return path[-1] in self.MATMULS[path[0]]
        return path[0] == "unembed"

    def cache_specs(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        n = self.n_pairs
        d_up, heads, hd = ssm.xlstm_dims(cfg)
        sh, shd = cfg.num_heads, cfg.d_model // cfg.num_heads
        f32 = torch.float32
        return {"m_C": ParamSpec((n, batch, heads, hd, hd), "zeros", f32),
                "m_n": ParamSpec((n, batch, heads, hd), "zeros", f32),
                "m_m": ParamSpec((n, batch, heads), "zeros", f32),
                "s_c": ParamSpec((n, batch, sh, shd), "zeros", f32),
                "s_n": ParamSpec((n, batch, sh, shd), "ones", f32),
                "s_m": ParamSpec((n, batch, sh), "zeros", f32),
                "s_h": ParamSpec((n, batch, sh, shd), "zeros", f32)}

    def _pairs(self, params, x, state, use_state: bool, cim):
        """Every pair in turn, each pair's new states written into
        ``state`` in place."""
        cfg = self.cfg
        for i in range(self.n_pairs):
            m_st = s_st = None
            if use_state:
                m_st = ssm.XLSTMState(state["m_C"][i], state["m_n"][i],
                                      state["m_m"][i],
                                      state["s_h"][i][..., :0], state["pos"])
                s_st = ssm.XLSTMState(state["s_c"][i][..., None],
                                      state["s_n"][i], state["s_m"][i],
                                      state["s_h"][i], state["pos"])
            h, new_m = ssm.mlstm_block(
                rms_norm(x, params["m_ln"][i], cfg.norm_eps),
                _layer(params["mlstm"], i), cfg, m_st, cim)
            x = x + h
            h, new_s = ssm.slstm_block(
                rms_norm(x, params["s_ln"][i], cfg.norm_eps),
                _layer(params["slstm"], i), cfg, s_st, cim)
            x = x + h
            for name, val in (("m_C", new_m.C), ("m_n", new_m.n),
                              ("m_m", new_m.m), ("s_c", new_s.C[..., 0]),
                              ("s_n", new_s.n), ("s_m", new_s.m),
                              ("s_h", new_s.h)):
                state[name][i] = val
        return x

    def prefill(self, params: dict, tokens: torch.Tensor, capacity: int,
                cim=None) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        b, s = tokens.shape
        state = self.init_cache(b, capacity, tokens.device)
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x = self._pairs(params, x, state, False, cim)
        state["pos"] = s
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    def decode(self, params: dict, token: torch.Tensor, state: dict,
               cim=None) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x = self._pairs(params, x, state, True, cim)
        state["pos"] = state["pos"] + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state


def build(cfg: ModelConfig) -> BaseModel:
    """The model of ``cfg.family``, as the reference's ``build``
    dispatches."""
    if cfg.family in ("dense", "moe"):
        return TransformerLM(cfg)
    if cfg.family == "ssm" and cfg.ssm_kind == "xlstm":
        return XLSTMModel(cfg)
    if cfg.family == "hybrid":
        return ZambaModel(cfg)
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: whisper's "
            f"EncDecModel (with its frames input) and the VLM "
            f"cross-attention (with its patches input) are the next port "
            f"slice (ported: {FAMILIES})")
    raise ValueError(f"unknown family {cfg.family!r} / ssm_kind "
                     f"{cfg.ssm_kind!r}")

"""Decoder-only transformer (dense family) over a params dict.

Params mirror the reference's tree: ``embed`` (V, d), ``unembed``
(d, V), ``final_norm`` (d,), and ``blocks`` whose leaves carry a leading
layer axis (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, ``w1``,
``w2``, ``w3``).  Packed weights are ``PackedTernary`` with the same
leading axis; the layer loop slices it.  Every weight matmul goes
through ``layers.dense`` and so through the CIM modes.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import resolve_device
from . import attention as attn
from .config import ModelConfig, ParamSpec
from .layers import dense, rms_norm, swiglu


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


class TransformerLM:
    """Dense decoder-only transformer: init, prefill, decode."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
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
                  "wo": ParamSpec(L + (h * hd, d)),
                  "w1": ParamSpec(L + (d, f)),
                  "w2": ParamSpec(L + (f, d)),
                  "w3": ParamSpec(L + (d, f))}
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

    def init_cache(self, batch: int, capacity: int, device) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "pos": 0}

    def _mlp(self, x, wl, cim):
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
        """The decode layer loop: each layer reads its (stale) cache plus
        the fresh token, then its new k/v are written in place at the
        current position.  The reference collects every layer's k/v and
        writes them once after the loop; here each layer writes its own
        cache right after reading it, which no later read sees, so every
        value is the same."""
        cfg = self.cfg
        pos = state["pos"]
        cap = state["k"].shape[2]
        # past capacity the write lands on the last slot, as the
        # reference's clamped dynamic_update_slice does; the slot is a
        # host int, so the write needs no copy to the device
        slot = min(pos, cap - 1)
        blocks = params["blocks"]
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(state["k"][i], state["v"][i], pos)
            out, kt, vt = attn.decode_attention_read(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
            state["k"][i, :, slot] = kt[:, 0]
            state["v"][i, :, slot] = vt[:, 0]
        return x

    def decode(self, params: dict, token: torch.Tensor, state: dict,
               cim=None) -> tuple[torch.Tensor, dict]:
        """One-token step: token (B, 1) -> logits (B, 1, V).  Updates the
        cache in place and advances ``state['pos']``."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x = self._decode_read_layers(params, x, state, cim)
        state["pos"] = state["pos"] + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state


def build(cfg: ModelConfig) -> Any:
    if cfg.family == "dense":
        return TransformerLM(cfg)
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")

"""The model families over a params dict: the decoder-only transformer
(dense, MoE and the cross-attending VLM, ``TransformerLM``), the
encoder-decoder over audio frames (``EncDecModel``), the hybrid Mamba2
backbone with one shared attention block (``ZambaModel``) and the xLSTM
stack (``XLSTMModel``).  ``BaseModel`` holds what they share: ``init``,
``init_packed``, ``param_bytes`` and ``init_cache`` from each family's
parameter and decode-state specs, and the training ``loss`` over a
family's ``forward``.

TransformerLM.

``forward`` (training: the whole sequence, no cache) is the dense and
MoE stack's; the VLM's cross blocks, ``EncDecModel``, ``ZambaModel`` and
``XLSTMModel`` raise (ROADMAP queue 1 item 9).  Its embedding gradient
is deterministic (``layers.embed``) and each layer runs under
``_maybe_remat`` (``remat="full"``: recomputed in the backward pass).

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

A VLM (``cross_attn_every = k``) has ``L / k`` gated cross-attention
blocks, ``cross_blocks``: ``ln``, an f32 ``gate`` (zeros at ``init``, so
a fresh model's cross blocks add nothing) and ``wq``/``wk``/``wv``/``wo``.
After every k self-attention layers, ``x + tanh(gate) * wo(attend(
wq(ln(x)), xk, xv))``, where ``xk``/``xv`` are the patches' keys and
values, projected once at prefill and held in the decode state (``L /
k``, B, patches, KV, hd).  Its decode writes each layer's fresh k/v
before it attends (``attention.decode_attention``), as the reference's
grouped scan does, and it does not page.  ``prefill`` takes the patch
embeddings as ``patches=`` (B, P, d).

EncDecModel (whisper; the conv frontend is a stub: frames are
embeddings): ``encode`` adds sinusoidal positions to the frames and runs
``encoder_layers`` non-causal blocks with a gelu MLP; each decoder layer
attends causally over its own cache, then over its cross keys and values
(``x_wk``/``x_wv`` of the encoder's output, projected once at prefill),
then runs a gelu MLP.  ``prefill`` takes the frames as ``frames=`` (B,
T, d).  A family refuses the extra input it does not read.

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
from typing import Any, Optional

import torch

from .. import resolve_device
from . import attention as attn
from . import moe, ssm
from .config import ModelConfig, ParamSpec
from .layers import (dense, embed, gelu_mlp, rms_norm, sinusoidal_positions,
                     swiglu)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _probe(spec: ParamSpec, dtype) -> torch.Tensor:
    """A storage-free tensor of the leaf's shape and dtype."""
    return torch.empty(spec.shape, dtype=spec.dtype or dtype, device="meta")


def _default_packs(path: tuple, x) -> bool:
    """``ternarize_params``'s default predicate."""
    from ..core.cim_linear import _packable
    return _packable(path[-1] if path else "", x)


def _maybe_remat(fn, cfg: ModelConfig):
    """``remat="full"``: each call of ``fn`` keeps only its inputs, and
    the backward pass runs it again (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``).  Without grad it is ``fn``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat != "full":
        raise NotImplementedError(
            f"remat={cfg.remat!r}: only 'none' and 'full' are ported "
            f"(a saving policy is ROADMAP queue 1 item 8)")

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return remat


def _no_forward(model, what: str):
    return NotImplementedError(
        f"{type(model).__name__} ({model.cfg.name}, family "
        f"{model.cfg.family!r}): {what} has no training forward yet "
        f"(ROADMAP queue 1 item 9)")


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

    def forward(self, params: dict, batch: dict, cim=None,
                return_aux: bool = False):
        """Full-sequence logits (B, S, V) of ``batch['tokens']`` (and
        the auxiliary loss with ``return_aux``): the training forward."""
        raise _no_forward(self, "the family")

    def loss(self, params: dict, batch: dict, cim=None) -> torch.Tensor:
        """Mean next-token cross-entropy over the labels >= 0, plus the
        auxiliary (MoE load-balance) loss: the logits in f32, their
        logsumexp minus the gold logit."""
        logits, aux = self.forward(params, batch, cim=cim, return_aux=True)
        labels = batch["labels"].long()
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).to(torch.float32)
        ce = torch.sum((logz - gold) * mask) / torch.clamp_min(mask.sum(),
                                                               1.0)
        return ce + aux

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

    def param_count(self) -> int:
        """Parameters ``init`` would draw."""
        return sum(math.prod(spec.shape)
                   for _, spec in _walk(self.param_specs))

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


def _cross_state(state: dict, shape: tuple) -> None:
    """Fit the state's ``xk``/``xv`` to ``shape`` (layers, B, T, KV, hd):
    kept where ``init_cache`` made them so (T the config's
    ``encoder_seq``), replaced by an empty pair for another T."""
    for name in ("xk", "xv"):
        if tuple(state[name].shape) != shape:
            state[name] = state[name].new_empty(shape)


def _refuse_input(cfg: ModelConfig, name: str, value) -> None:
    if value is not None:
        raise TypeError(f"{cfg.name} (family {cfg.family!r}) takes no "
                        f"{name!r} input")


def _needs_input(cfg: ModelConfig, name: str, value) -> torch.Tensor:
    if value is None:
        raise TypeError(f"{cfg.name} (family {cfg.family!r}) prefills from "
                        f"tokens and {name!r} (B, positions, d_model)")
    return value


class TransformerLM(BaseModel):
    """Decoder-only transformer, dense, MoE or cross-attending (vlm):
    init, prefill, decode."""

    MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "unembed")

    def __init__(self, cfg: ModelConfig):
        k = cfg.cross_attn_every
        if k and cfg.num_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                             f"group by cross_attn_every={k}")
        if k and cfg.kv_cache_dtype == "int8":
            raise ValueError(f"{cfg.name}: the cross-attending decode "
                             f"writes its cache before it reads it, with "
                             f"no int8 path (as in the reference)")
        super().__init__(cfg)

    @property
    def n_cross(self) -> int:
        k = self.cfg.cross_attn_every
        return self.cfg.num_layers // k if k else 0

    def _param_specs(self) -> dict:
        cfg = self.cfg
        d, f, L = cfg.d_model, cfg.d_ff, (cfg.num_layers,)
        blocks = {"ln1": ParamSpec(L + (d,), "ones"),
                  "ln2": ParamSpec(L + (d,), "ones"),
                  **_attn_specs(cfg, cfg.num_layers)}
        if cfg.num_experts:
            blocks.update(moe.moe_defs(cfg, cfg.num_layers))
        else:
            blocks.update(w1=ParamSpec(L + (d, f)), w2=ParamSpec(L + (f, d)),
                          w3=ParamSpec(L + (d, f)))
        specs = {**_embed_specs(cfg), "blocks": blocks}
        if cfg.cross_attn_every:
            n = self.n_cross
            specs["cross_blocks"] = {
                "ln": ParamSpec((n, d), "ones"),
                "gate": ParamSpec((n,), "zeros", torch.float32),
                **_attn_specs(cfg, n, cross=True)}
        return specs

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
            specs = {"k": ParamSpec(shape, "zeros"),
                     "v": ParamSpec(shape, "zeros")}
            if cfg.cross_attn_every:
                xshape = (self.n_cross, batch, cfg.encoder_seq or 1024,
                          cfg.num_kv_heads, cfg.hd)
                specs["xk"] = ParamSpec(xshape, "zeros")
                specs["xv"] = ParamSpec(xshape, "zeros")
            return specs
        return {"k": ParamSpec(shape, "zeros", torch.int8),
                "v": ParamSpec(shape, "zeros", torch.int8),
                "k_scale": ParamSpec(shape[:-1], "zeros", torch.float32),
                "v_scale": ParamSpec(shape[:-1], "zeros", torch.float32)}

    def _mlp(self, x, wl, cim):
        return self._mlp_aux(x, wl, cim)[0]

    def _mlp_aux(self, x, wl, cim):
        """(the MLP's output, its auxiliary loss: MoE's, else 0.0)."""
        if self.cfg.num_experts:
            return moe.moe_block(x, wl, self.cfg, cim)
        return swiglu(x, wl["w1"], wl["w3"], wl["w2"], cim), 0.0

    def _train_block(self, x, wl: dict, cim):
        """One layer of the training forward: causal self-attention over
        the whole sequence, then the MLP; returns (x, aux)."""
        cfg = self.cfg
        x = x + attn.self_attention(rms_norm(x, wl["ln1"], cfg.norm_eps),
                                    wl, cfg, cim_cfg=cim)
        m, aux = self._mlp_aux(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
        return x + m, aux

    def forward(self, params: dict, batch: dict, cim=None,
                return_aux: bool = False):
        """Logits (B, S, V) of ``batch['tokens']`` (B, S), dense or MoE,
        each layer under ``_maybe_remat``; with ``return_aux`` also the
        summed MoE auxiliary loss (an f32 0-d tensor).  The stacked
        weights are unbound once, so the backward pass stacks each
        leaf's gradient once instead of adding a full-size zero tensor
        per layer."""
        cfg = self.cfg
        if cfg.cross_attn_every:
            raise _no_forward(self, "the cross-attending (vlm) forward")
        x = embed(params["embed"], batch["tokens"]).to(cfg.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        per_layer = {k: (v.unbind(0) if isinstance(v, torch.Tensor)
                         else [v[i] for i in range(cfg.num_layers)])
                     for k, v in params["blocks"].items()}
        body = _maybe_remat(self._train_block, cfg)
        for i in range(cfg.num_layers):
            x, a = body(x, {k: v[i] for k, v in per_layer.items()}, cim)
            aux = aux + a
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = dense(x, params["unembed"], cim)
        return (logits, aux) if return_aux else logits

    def _cross(self, x, params, g: int, state: dict, cim):
        """Cross block g: ``x + tanh(gate) * wo(attend(wq(ln(x)), xk,
        xv))`` over the patches' cached keys and values, unmasked."""
        cfg = self.cfg
        wc = _layer(params["cross_blocks"], g)
        b, s, _ = x.shape
        q = dense(rms_norm(x, wc["ln"], cfg.norm_eps), wc["wq"], cim)
        h = attn._gqa_attend(q.reshape(b, s, cfg.num_heads, cfg.hd),
                             state["xk"][g], state["xv"][g], None)
        h = dense(h, wc["wo"], cim)
        return x + torch.tanh(wc["gate"]).to(x.dtype) * h

    def _precompute_cross(self, params, patches, state: dict, cim) -> None:
        """Each cross block's keys and values of the patches, once, into
        ``state['xk']``/``['xv']``."""
        cfg = self.cfg
        b, p, _ = patches.shape
        kv, hd = cfg.num_kv_heads, cfg.hd
        _cross_state(state, (self.n_cross, b, p, kv, hd))
        x = patches.to(cfg.dtype)
        for g in range(self.n_cross):
            wc = _layer(params["cross_blocks"], g)
            state["xk"][g] = dense(x, wc["wk"], cim).reshape(b, p, kv, hd)
            state["xv"][g] = dense(x, wc["wv"], cim).reshape(b, p, kv, hd)

    def _crosses_after(self, i: int) -> bool:
        k = self.cfg.cross_attn_every
        return bool(k) and (i + 1) % k == 0

    def prefill(self, params: dict, tokens: torch.Tensor, capacity: int,
                cim=None, patches: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, dict]:
        """Consume a (B, S) prompt (and a VLM's (B, P, d) ``patches``);
        returns (last-position logits (B, 1, V), state)."""
        cfg = self.cfg
        b, s = tokens.shape
        state = self.init_cache(b, capacity, tokens.device)
        if cfg.cross_attn_every:
            self._precompute_cross(params, _needs_input(cfg, "patches",
                                                        patches),
                                   state, cim)
        else:
            _refuse_input(cfg, "patches", patches)
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
            if self._crosses_after(i):
                x = self._cross(x, params, i // cfg.cross_attn_every,
                                state, cim)
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
        stays on the host, a device one on the device.  A VLM writes
        each layer's k/v before it attends (:meth:`_decode_cross`)."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        if cfg.cross_attn_every:
            return self._decode_cross(params, x, state, cim)
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

    def _decode_cross(self, params: dict, x, state: dict, cim):
        """The VLM's decode, the reference's grouped scan: each self
        layer writes its fresh k/v at ``state['pos']`` (a host int or a
        (B,) tensor) and attends over the written slots; after every k
        of them a cross block reads the cached patch keys and values."""
        cfg = self.cfg
        blocks = params["blocks"]
        for i in range(cfg.num_layers):
            wl = _layer(blocks, i)
            cache = attn.KVCache(state["k"][i], state["v"][i], state["pos"])
            out, _ = attn.decode_attention(
                rms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache, cim)
            x = x + out
            x = x + self._mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl, cim)
            if self._crosses_after(i):
                x = self._cross(x, params, i // cfg.cross_attn_every,
                                state, cim)
        state["pos"] = state["pos"] + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    @property
    def supports_paged_kv(self) -> bool:
        """The full-cache read-then-write decode pages cleanly (an int8
        pool with its scale pages); a
        windowed model decodes against a rolling cache (slot = pos %
        window, engaged only when the capacity is the window) that a
        page-gathered view's capacity would silently disarm, and a VLM
        writes its cache inside the layer loop and holds the patches'
        keys and values besides, so both serve from the dense pool, as in
        the reference."""
        return not self.cfg.sliding_window and not self.cfg.cross_attn_every

    def decode_paged(self, params: dict, tokens: torch.Tensor, pool,
                     page_table: torch.Tensor, pos: torch.Tensor, cim=None
                     ) -> tuple:
        """One-token decode of every slot against the page pool through
        the gather: ``paged_kv.slot_view`` copies each slot's pages into
        the dense layout, then the read-only layer loop runs on it.
        tokens (S, 1), page_table (S, W), pos (S,).  Returns (logits
        (S, 1, V), kts (L, S, KV, hd), vts) in the compute dtype, for
        ``paged_kv.append_tokens``."""
        if not self.supports_paged_kv:
            return super().decode_paged(params, tokens, pool, page_table,
                                        pos, cim)
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
        if not self.supports_paged_kv:
            return super().decode_paged_fused(params, tokens, pool,
                                              page_table, pos, cim,
                                              attn_plan)
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


def _attn_specs(cfg: ModelConfig, layers: Optional[int] = None,
                cross: bool = False) -> dict:
    """An attention block's weights, stacked over `layers` where given;
    a cross block has no qk-norm."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    L = () if layers is None else (layers,)
    specs = {"wq": ParamSpec(L + (d, h * hd)),
             "wk": ParamSpec(L + (d, kv * hd)),
             "wv": ParamSpec(L + (d, kv * hd)),
             "wo": ParamSpec(L + (h * hd, d))}
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec(L + (hd,), "ones")
        specs["k_norm"] = ParamSpec(L + (hd,), "ones")
    return specs


def _embed_specs(cfg: ModelConfig) -> dict:
    return {"embed": ParamSpec((cfg.padded_vocab, cfg.d_model), "embed"),
            "unembed": ParamSpec((cfg.d_model, cfg.padded_vocab)),
            "final_norm": ParamSpec((cfg.d_model,), "ones")}


class EncDecModel(BaseModel):
    """Whisper's backbone: ``encoder_layers`` non-causal blocks over the
    frames, ``num_layers`` decoder blocks (self, cross, gelu MLP)."""

    MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2", "x_wq", "x_wk", "x_wv",
               "x_wo", "unembed")

    def _param_specs(self) -> dict:
        cfg = self.cfg
        Le, Ld, d, f = (cfg.encoder_layers, cfg.num_layers, cfg.d_model,
                        cfg.d_ff)

        def mlp(L):
            return {"w1": ParamSpec((L, d, f)), "w2": ParamSpec((L, f, d))}
        return {**_embed_specs(cfg),
                "enc_blocks": {"ln1": ParamSpec((Le, d), "ones"),
                               "ln2": ParamSpec((Le, d), "ones"),
                               **_attn_specs(cfg, Le), **mlp(Le)},
                "enc_norm": ParamSpec((d,), "ones"),
                "dec_blocks": {"ln1": ParamSpec((Ld, d), "ones"),
                               "ln2": ParamSpec((Ld, d), "ones"),
                               "ln3": ParamSpec((Ld, d), "ones"),
                               **_attn_specs(cfg, Ld),
                               **{f"x_{k}": v for k, v in _attn_specs(
                                   cfg, Ld, cross=True).items()},
                               **mlp(Ld)}}

    def matmul_leaf(self, path: tuple) -> bool:
        return path[-1] in self.MATMULS

    def cache_specs(self, batch: int, capacity: int) -> dict:
        cfg = self.cfg
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        shape = (L, batch, capacity, kv, hd)
        xshape = (L, batch, cfg.encoder_seq, kv, hd)
        return {"k": ParamSpec(shape, "zeros"),
                "v": ParamSpec(shape, "zeros"),
                "xk": ParamSpec(xshape, "zeros"),
                "xv": ParamSpec(xshape, "zeros")}

    def encode(self, params: dict, frames: torch.Tensor, cim=None
               ) -> torch.Tensor:
        """(B, T, d) frames -> (B, T, d) encoder output: sinusoidal
        positions (f32, cast to the model dtype), then each block's
        non-causal attention and gelu MLP, then ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(cfg.dtype)
        enc = params["enc_blocks"]
        for i in range(cfg.encoder_layers):
            wl = _layer(enc, i)
            x = x + attn.self_attention(rms_norm(x, wl["ln1"], cfg.norm_eps),
                                        wl, cfg, causal=False, cim_cfg=cim)
            x = x + gelu_mlp(rms_norm(x, wl["ln2"], cfg.norm_eps), wl["w1"],
                             wl["w2"], cim)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, params: dict, enc: torch.Tensor, state: dict,
                  cim) -> None:
        """Every decoder layer's cross keys and values of the encoder's
        output, once, into ``state['xk']``/``['xv']``."""
        cfg = self.cfg
        b, t, _ = enc.shape
        kv, hd = cfg.num_kv_heads, cfg.hd
        _cross_state(state, (cfg.num_layers, b, t, kv, hd))
        dec = params["dec_blocks"]
        for i in range(cfg.num_layers):
            state["xk"][i] = dense(enc, dec["x_wk"][i], cim).reshape(
                b, t, kv, hd)
            state["xv"][i] = dense(enc, dec["x_wv"][i], cim).reshape(
                b, t, kv, hd)

    def _run_dec(self, params, x, state, prefill: bool, cim):
        """The decoder layers: causal self-attention (prefill writes the
        prompt's k/v; decode writes the fresh k/v, then attends), cross-
        attention over the cached ``xk``/``xv``, the gelu MLP."""
        cfg = self.cfg
        dec = params["dec_blocks"]
        b, s, _ = x.shape
        for i in range(cfg.num_layers):
            wl = _layer(dec, i)
            cache = attn.KVCache(state["k"][i], state["v"][i],
                                 0 if prefill else state["pos"])
            xa = rms_norm(x, wl["ln1"], cfg.norm_eps)
            if prefill:
                h, _ = attn.prefill_attention(xa, wl, cfg, cache, cim)
            else:
                h, _ = attn.decode_attention(xa, wl, cfg, cache, cim)
            x = x + h
            q = dense(rms_norm(x, wl["ln2"], cfg.norm_eps), wl["x_wq"], cim)
            h = attn._gqa_attend(q.reshape(b, s, cfg.num_heads, cfg.hd),
                                 state["xk"][i], state["xv"][i], None)
            x = x + dense(h, wl["x_wo"], cim)
            x = x + gelu_mlp(rms_norm(x, wl["ln3"], cfg.norm_eps), wl["w1"],
                             wl["w2"], cim)
        return x

    def prefill(self, params: dict, tokens: torch.Tensor, capacity: int,
                cim=None, frames: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, dict]:
        """Encode the (B, T, d) ``frames``, project the cross keys and
        values, then consume the (B, S) prompt; returns (last-position
        logits (B, 1, V), state)."""
        cfg = self.cfg
        frames = _needs_input(cfg, "frames", frames)
        b, s = tokens.shape
        state = self.init_cache(b, capacity, tokens.device)
        enc = self.encode(params, frames, cim)
        self._cross_kv(params, enc, state, cim)
        del enc
        x = params["embed"][tokens.long()].to(cfg.dtype)
        x = self._run_dec(params, x, state, True, cim)
        state["pos"] = s
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state

    def decode(self, params: dict, token: torch.Tensor, state: dict,
               cim=None) -> tuple[torch.Tensor, dict]:
        """One-token step: token (B, 1) -> logits (B, 1, V); the cache is
        written in place and ``pos`` (a host int or (B,) tensor)
        advances."""
        cfg = self.cfg
        x = params["embed"][token.long()].to(cfg.dtype)
        x = self._run_dec(params, x, state, False, cim)
        state["pos"] = state["pos"] + 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return dense(x, params["unembed"], cim), state


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
    if cfg.family in ("dense", "moe", "vlm"):
        return TransformerLM(cfg)
    if cfg.family == "audio":
        return EncDecModel(cfg)
    if cfg.family == "ssm" and cfg.ssm_kind == "xlstm":
        return XLSTMModel(cfg)
    if cfg.family == "hybrid":
        return ZambaModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r} / ssm_kind "
                     f"{cfg.ssm_kind!r}")

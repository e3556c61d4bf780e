"""Built-in execution backends for the plan registry.

  cuda  - the hand-written kernels (kernels/ternary_matmul.py, and
          kernels/cim_mac.py for ``op='cim'``), platform cuda, priority
          100.  2-D weights only (models slice the layer stack before the
          matmul).
  torch - the plain versions (kernels/ops.py, ``cim_mac_torch``), cpu and
          cuda, priority 50.  ``auto`` picks it on the CPU; on the card it
          runs only when named.
  ref   - the oracles (kernels/ref.py), priority 10; ternary op only.

A cim plan (the macro-exact mode) quantizes the activations per call
(per row inside :func:`~.plan.rows_as_calls`, where each row stands for a
call of the reference's), ternarizes a float weight with one per-tensor scale (or unpacks a base3
``PackedTernary`` into its planes), runs the CIM MAC and rescales, as the
reference's pallas runner does.  The torch backend does all of it on
every call.  The cuda backend at the code route (``adc_bits >= 5``)
quantizes x to 5-trit codes only (no planes) and takes the weight's
:class:`~.cim_mac.CodeWeight` and scale from :data:`CODE_WEIGHTS`, which
makes them once per weight, bitwise as ``ternarize`` would on each call;
at b <= 4 (the groups route) it ternarizes per call as the torch backend.
Under autograd the weight's scale (its one gradient path; the codes
carry none) is made again in the current graph, so a training step
never reuses a scale from an earlier step's graph; the cached codes
hold no graph and refill when the weight changes in place.

The matmul backends are layout-agnostic (the paged pool's gather and
scatter wrap around the matmuls), so they declare both KV layouts.  The
paged-attention read registers two backends for ``op='attention'``,
``kv_layout='paged'``, float domain:

  paged_attn       - the hand-written kernel (kernels/paged_attention.py),
                     platform cuda, priority 100.
  paged_attn_torch - its plain version (the gather oracle), cpu and cuda,
                     priority 50; on the card it runs only when named.

There is no fallback between them: a backend that cannot run a request
raises.
"""
from __future__ import annotations

import weakref

import torch

from ..core.packing import unpack_base3_to_planes
from ..core.ternary import (encode_inputs, quantize_8b_truncate_5t,
                            symmetric_scale, ternarize)
from . import cim_mac as cm
from . import ops, ref
from . import paged_attention as pa
from . import ternary_matmul as tm
from .plan import BackendSpec, register_backend, rows_are_calls


def _pad_k(x2: torch.Tensor, w: ops.PackedTernary) -> torch.Tensor:
    """trit2 packing pads K to a multiple of 4; zero-pad x to match."""
    kpad = w.kdim - x2.shape[-1]
    if kpad:
        return torch.nn.functional.pad(x2, (0, kpad))
    return x2


def _weight_trits(w, num_trits: int):
    """(trit planes, scale) of a cim plan's weight: a float (K, N) weight
    ternarized with one per-tensor scale, or a base3 PackedTernary."""
    if isinstance(w, ops.PackedTernary):
        if w.mode != "base3":
            raise ValueError("cim plans need base3 (multi-trit) weights; "
                             f"got packing {w.mode!r}")
        return unpack_base3_to_planes(w.data, num_trits), w.scale
    tt = ternarize(w, num_trits)
    return tt.trits, tt.scale


def _input_axis():
    """The activation scale's axis: one scale per call, or one per row
    where each row stands for a call (``rows_as_calls``); the scale is
    then (M, 1) and broadcasts in the epilogue."""
    return -1 if rows_are_calls() else None


def _run_cim(plan, x, w, mac):
    """x (..., K) float against a float (K, N) weight or a base3
    PackedTernary through the CIM MAC ``mac(x_trits, w_trits, adc_bits)``
    -> (..., N) f32."""
    lead = x.shape[:-1]
    xt = encode_inputs(x.reshape(-1, x.shape[-1]), plan.num_trits,
                       axis=_input_axis())
    w_trits, w_scale = _weight_trits(w, plan.num_trits)
    y = mac(xt.trits, w_trits, plan.adc_bits).to(torch.float32)
    return (y * xt.scale * w_scale).reshape(*lead, w_trits.shape[-1])


class CodeWeightCache:
    """The cuda backend's code-route weights: per weight and trit count,
    its :class:`~.cim_mac.CodeWeight` and scale, made once.

    The model slices its layer stack on every call, so an entry is keyed
    by what identifies the data (the root tensor's identity, the view's
    offset, shape, strides and dtype), not by the Python object.  An
    entry holds a weak reference to the root tensor and the data's
    version counter: a weight changed in place (a new ``_version``) is
    made again, and an entry dies with its root tensor, so a tensor later
    allocated at the same address cannot find it.  ``fills`` counts the
    entries made."""

    def __init__(self) -> None:
        self._entries: dict = {}
        self.fills = 0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def get(self, w, num_trits: int) -> tuple:
        """(CodeWeight, scale) of a float weight or base3 PackedTernary."""
        src = w.data if isinstance(w, ops.PackedTernary) else w
        root = src if src._base is None else src._base
        key = (id(root), src.storage_offset(), tuple(src.shape),
               src.stride(), src.dtype, isinstance(w, ops.PackedTernary),
               num_trits)
        hit = self._entries.get(key)
        if hit is not None and hit[0]() is root and hit[1] == src._version:
            return hit[2]
        with torch.no_grad():        # an entry holds no autograd graph
            w_trits, scale = _weight_trits(w, num_trits)
            value = (cm.code_weight(w_trits), scale)
        entries = self._entries
        self._entries[key] = (
            weakref.ref(root, lambda _, key=key: entries.pop(key, None)),
            src._version, value)
        self.fills += 1
        return value


CODE_WEIGHTS = CodeWeightCache()


def _run_cim_codes(plan, x, w):
    """The cuda backend's cim plan at the code route: x quantized to
    5-trit codes (the scale of ``encode_inputs``), the cached weight."""
    lead = x.shape[:-1]
    q = quantize_8b_truncate_5t(x.reshape(-1, x.shape[-1]), plan.num_trits,
                                axis=_input_axis())
    cw, w_scale = CODE_WEIGHTS.get(w, plan.num_trits)
    if (torch.is_grad_enabled() and isinstance(w, torch.Tensor)
            and w.requires_grad):
        # the scale is the weight's only gradient path: made in this
        # graph (bitwise the cached one), never taken from an earlier one
        w_scale = symmetric_scale(w, 127)
    y = cm.cim_mac_codes(q.values.to(torch.int8), cw,
                         plan.adc_bits).to(torch.float32)
    return (y * q.scale * w_scale).reshape(*lead, cw.data.shape[-1])


def _run_cuda(plan, x, w):
    if plan.op == "cim":
        if cm.route(plan.adc_bits) == "codes":
            return _run_cim_codes(plan, x, w)
        return _run_cim(plan, x, w, cm.cim_mac)
    if w.data.dim() != 2:
        raise ValueError(f"the cuda backend takes 2-D packed weights; got "
                         f"{tuple(w.data.shape)} (slice the layer stack)")
    lead = x.shape[:-1]
    if plan.domain == "int8":
        xi, x_scale = ops.quantize_acts_int8(x)
        xi2 = _pad_k(xi.reshape(-1, xi.shape[-1]), w).contiguous()
        y = tm.matmul_int8(xi2, x_scale.reshape(-1).contiguous(), w.data,
                           w.scale, w.mode)
    else:
        x2 = _pad_k(x.reshape(-1, x.shape[-1]), w).contiguous()
        y = tm.matmul_float(x2, w.data, w.scale, w.mode)
    return y.reshape(*lead, w.data.shape[-1])


def _run_torch(plan, x, w):
    if plan.op == "cim":
        return _run_cim(plan, x, w, cm.cim_mac_torch)
    if plan.domain == "int8":
        xi, x_scale = ops.quantize_acts_int8(x)
        return ops.ternary_matmul_int8_torch(xi, x_scale, w)
    return ops.ternary_matmul_torch(x, w)


def _run_ref(plan, x, w):
    if plan.domain == "int8":
        xi, x_scale = ops.quantize_acts_int8(x)
        return ref.ternary_matmul_int8_ref(xi, x_scale, w.data, w.scale,
                                           w.mode)
    return ref.ternary_matmul_ref(_pad_k(x, w), w.data, w.scale, w.mode)


_ALL = dict(domains=frozenset({"float", "int8"}),
            packings=frozenset({"base3", "trit2"}),
            kv_layouts=frozenset({"dense", "paged"}))

register_backend(BackendSpec(name="cuda", platforms=frozenset({"cuda"}),
                             priority=100, runner=_run_cuda,
                             ops=frozenset({"ternary", "cim"}), **_ALL))
register_backend(BackendSpec(name="torch",
                             platforms=frozenset({"cpu", "cuda"}),
                             priority=50, runner=_run_torch,
                             ops=frozenset({"ternary", "cim"}), **_ALL))
register_backend(BackendSpec(name="ref", platforms=frozenset({"cpu", "cuda"}),
                             priority=10, runner=_run_ref,
                             ops=frozenset({"ternary"}), **_ALL))


def _run_paged_attn(plan, q, kv):
    return pa.paged_attention(q, kv)


def _run_paged_attn_torch(plan, q, kv):
    return pa.paged_attention_torch(q, kv)


# attention has no packed operand: every packing a model runs under is
# admissible
_ATTN = dict(ops=frozenset({"attention"}), domains=frozenset({"float"}),
             packings=frozenset({"base3", "trit2"}),
             kv_layouts=frozenset({"paged"}))

register_backend(BackendSpec(name="paged_attn",
                             platforms=frozenset({"cuda"}), priority=100,
                             runner=_run_paged_attn, **_ATTN))
register_backend(BackendSpec(name="paged_attn_torch",
                             platforms=frozenset({"cpu", "cuda"}),
                             priority=50, runner=_run_paged_attn_torch,
                             **_ATTN))

# The device-fidelity backend (the fault-injected analog MAC over a seeded
# FaultModel) registers from repro_torch.faults.backend, imported last so
# the built-ins above are in place when it joins the registry.
from ..faults import backend as _faults_backend  # noqa: E402,F401

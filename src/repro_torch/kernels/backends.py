"""Built-in execution backends for the plan registry.

  cuda  - the hand-written kernels (kernels/ternary_matmul.py, and
          kernels/cim_mac.py for ``op='cim'``), platform cuda, priority
          100.  2-D weights only (models slice the layer stack before the
          matmul).
  torch - the plain versions (kernels/ops.py, ``cim_mac_torch``), cpu and
          cuda, priority 50.  ``auto`` picks it on the CPU; on the card it
          runs only when named.
  ref   - the oracles (kernels/ref.py), priority 10; ternary op only.

A cim plan (the macro-exact mode) encodes the activations into trit
planes per call, ternarizes a float weight per call with one per-tensor
scale (or unpacks a base3 ``PackedTernary`` into its planes), runs the
CIM MAC and rescales, as the reference's pallas runner does.

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

import torch

from ..core.packing import unpack_base3_to_planes
from ..core.ternary import encode_inputs, ternarize
from . import cim_mac as cm
from . import ops, ref
from . import paged_attention as pa
from . import ternary_matmul as tm
from .plan import BackendSpec, register_backend


def _pad_k(x2: torch.Tensor, w: ops.PackedTernary) -> torch.Tensor:
    """trit2 packing pads K to a multiple of 4; zero-pad x to match."""
    kpad = w.kdim - x2.shape[-1]
    if kpad:
        return torch.nn.functional.pad(x2, (0, kpad))
    return x2


def _run_cim(plan, x, w, mac):
    """x (..., K) float against a float (K, N) weight or a base3
    PackedTernary through the CIM MAC ``mac(x_trits, w_trits, adc_bits)``
    -> (..., N) f32."""
    lead = x.shape[:-1]
    xt = encode_inputs(x.reshape(-1, x.shape[-1]), plan.num_trits)
    if isinstance(w, ops.PackedTernary):
        if w.mode != "base3":
            raise ValueError("cim plans need base3 (multi-trit) weights; "
                             f"got packing {w.mode!r}")
        w_trits = unpack_base3_to_planes(w.data, plan.num_trits)
        w_scale = w.scale
    else:
        tt = ternarize(w, plan.num_trits)      # one per-tensor scale
        w_trits, w_scale = tt.trits, tt.scale
    y = mac(xt.trits, w_trits, plan.adc_bits).to(torch.float32)
    return (y * xt.scale * w_scale).reshape(*lead, w_trits.shape[-1])


def _run_cuda(plan, x, w):
    if plan.op == "cim":
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

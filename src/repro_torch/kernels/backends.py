"""Built-in execution backends for the plan registry.

  cuda  - the hand-written kernels (kernels/ternary_matmul.py), platform
          cuda, priority 100.  2-D weights only (models slice the layer
          stack before the matmul).
  torch - the plain versions (kernels/ops.py), cpu and cuda, priority 50.
          ``auto`` picks it on the CPU; on the card it runs only when
          named.
  ref   - the oracles (kernels/ref.py), priority 10.

There is no fallback between them: a backend that cannot run a request
raises.
"""
from __future__ import annotations

import torch

from . import ops, ref
from . import ternary_matmul as tm
from .plan import BackendSpec, register_backend


def _pad_k(x2: torch.Tensor, w: ops.PackedTernary) -> torch.Tensor:
    """trit2 packing pads K to a multiple of 4; zero-pad x to match."""
    kpad = w.kdim - x2.shape[-1]
    if kpad:
        return torch.nn.functional.pad(x2, (0, kpad))
    return x2


def _run_cuda(plan, x, w):
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


_ALL = dict(ops=frozenset({"ternary"}), domains=frozenset({"float", "int8"}),
            packings=frozenset({"base3", "trit2"}))

register_backend(BackendSpec(name="cuda", platforms=frozenset({"cuda"}),
                             priority=100, runner=_run_cuda, **_ALL))
register_backend(BackendSpec(name="torch",
                             platforms=frozenset({"cpu", "cuda"}),
                             priority=50, runner=_run_torch, **_ALL))
register_backend(BackendSpec(name="ref", platforms=frozenset({"cpu", "cuda"}),
                             priority=10, runner=_run_ref, **_ALL))

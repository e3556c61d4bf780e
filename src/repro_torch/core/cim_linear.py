"""CIM linear layer: the paper's technique as a drop-in linear layer.

Modes (``CIMConfig.mode``):
  'float'   - plain matmul.
  'ternary' - packed-ternary weights through the ternary matmul kernels:
              base3 (5-trit, one byte per weight) or trit2 (one trit,
              2 bits).  The production serving path.
  'exact'   - the macro-exact model through the cim_mac kernel: inputs
              and weights as ``num_trits`` trit planes, 16-row groups,
              an ``adc_bits`` ADC per group, shift-and-add.  For accuracy
              studies.  The plain torch backend ternarizes a float weight
              on every call, as the reference does; the cuda backend at
              ``adc_bits >= 5`` ternarizes each weight once and keeps it
              (``kernels/backends.py``, ``CODE_WEIGHTS``).

``fidelity`` is the execution fidelity of a ternary config: ``exact``
(the kernels) or ``device`` (the fault-injected analog MAC of
``repro_torch.faults``).  Engines resolve one config per phase
(:meth:`CIMConfig.resolve`), so a device request runs the device backend
in decode and an exact backend in prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

MODES = ("float", "ternary", "exact")


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Execution mode plus the plan request for the kernel layer."""
    mode: str = "float"            # float | ternary | exact
    packing: str = "base3"         # base3 | trit2
    num_trits: int = 5             # exact mode: trits per operand
    adc_bits: int = 5              # exact mode: ADC resolution
    backend: str = "auto"          # any registered kernel backend
    domain: str = "float"          # float | int8
    kv_layout: str = "dense"       # dense | paged: serving KV layout
    fidelity: str = "exact"        # exact | device: execution fidelity

    def resolve(self, platform: str, phase: str = "auto") -> "CIMConfig":
        """Pin 'auto' against the backend registry for `platform` (the
        device type the engine runs on), the config's KV layout and its
        fidelity as routed for ``phase`` (``kernels.route_fidelity``: a
        device request resolves an exact backend for prefill); raises on
        an incapable backend, so a bad request fails at construction."""
        from ..kernels.plan import (KV_LAYOUTS, check_choice,
                                    resolve_backend, route_fidelity)
        check_choice("cim mode", self.mode, MODES)
        check_choice("kv layout", self.kv_layout, KV_LAYOUTS)
        fidelity = route_fidelity(self.fidelity, phase)
        if self.mode == "ternary":
            spec = resolve_backend("ternary", self.backend, self.domain,
                                   self.packing, platform, self.kv_layout,
                                   fidelity)
        elif self.mode == "exact":
            spec = resolve_backend("cim", self.backend, "float", "base3",
                                   platform, self.kv_layout, fidelity)
        else:
            if fidelity != "exact":
                raise ValueError(
                    "fidelity 'device' needs the ternary (packed-weight) "
                    "serving path; float mode has no device model")
            return self
        return dataclasses.replace(self, backend=spec.name,
                                   fidelity=fidelity)


def linear(x: torch.Tensor, w: Any, cfg: CIMConfig = CIMConfig()
           ) -> torch.Tensor:
    """Apply a linear layer under the configured mode.  A float weight
    under a ternary config is packed on every call, as the reference
    does, and under an exact config ternarized by the plan's backend
    (once per weight on the card's code route); a packed weight takes
    the ternary path whatever the mode."""
    from ..kernels import execute, ops, plan_matmul, platform_of, shape_of
    if cfg.mode == "ternary" or isinstance(w, ops.PackedTernary):
        pw = w if isinstance(w, ops.PackedTernary) else ops.pack_weights(
            w, cfg.packing, cfg.num_trits)

        def run(xl, wl):
            plan = plan_matmul(shape_of(xl, wl), cfg, packing=wl.mode,
                               platform=platform_of(xl))
            return execute(plan, xl, wl)
        if getattr(pw, "split", None) is not None:
            # a model-axis shard (dist.runtime.ShardedPacked): the planned
            # kernel on the local shape, then the collective; an int8 row
            # shard adds int32 sums and applies the epilogue after them
            if cfg.domain == "int8":
                return pw.apply(x, run, "int8")
            return pw.apply(x, run)
        return run(x, pw)
    if cfg.mode == "float":
        return x @ w
    if cfg.mode == "exact":
        plan = plan_matmul(shape_of(x, w), cfg, op="cim", packing="base3",
                           domain="float", platform=platform_of(x),
                           adc_bits=cfg.adc_bits, num_trits=cfg.num_trits)
        return execute(plan, x, w)
    raise ValueError(f"unknown cim mode {cfg.mode!r}; expected one of "
                     f"{sorted(MODES)}")


def _packable(name: str, x: Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() in (2, 3, 4)
            and x.dtype in (torch.float32, torch.bfloat16)
            and min(x.shape[-2:]) >= 64
            and name not in ("embed", "router"))


def ternarize_params(params: Any, cfg: CIMConfig, predicate=None) -> Any:
    """Pack every matmul weight of a nested params dict with
    ``cfg.packing`` and ``cfg.num_trits``.  ``predicate(path, leaf)``
    (``path`` the tuple of keys down to the leaf) selects the weights;
    by default the 2/3/4-D float tensors whose two trailing dims are both
    >= 64 and whose name is not 'embed' or 'router' (so the unembed IS
    packed; norms and the embedding table stay float)."""
    from ..kernels import ops
    pred = predicate or (lambda path, x: _packable(path[-1] if path else "",
                                                   x))

    def convert(tree, path):
        if isinstance(tree, dict):
            return {k: convert(v, path + (k,)) for k, v in tree.items()}
        if pred(path, tree):
            return ops.pack_weights(tree, cfg.packing, cfg.num_trits)
        return tree

    return convert(params, ())


def hbm_bytes(params: Any) -> int:
    """Device-memory bytes of a (possibly packed) params dict."""
    from ..kernels import ops
    if isinstance(params, dict):
        return sum(hbm_bytes(v) for v in params.values())
    if isinstance(params, ops.PackedTernary):
        return params.data.numel() + params.scale.numel() * 4
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0

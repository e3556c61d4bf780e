"""CIM linear layer: the paper's technique as a drop-in linear layer.

Modes (``CIMConfig.mode``):
  'float'   - plain matmul.
  'ternary' - packed-ternary weights through the ternary matmul kernels:
              base3 (5-trit, one byte per weight) or trit2 (one trit,
              2 bits).  The production serving path.
The macro-exact 'exact' mode of the reference is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

MODES = ("float", "ternary")


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Execution mode plus the plan request for the kernel layer."""
    mode: str = "float"            # float | ternary
    packing: str = "base3"         # base3 | trit2
    backend: str = "auto"          # any registered kernel backend
    domain: str = "float"          # float | int8

    def resolve(self, platform: str) -> "CIMConfig":
        """Pin 'auto' against the backend registry for `platform` (the
        device type the engine runs on); raises on an incapable backend,
        so a bad request fails at construction.  (The reference resolves
        once per phase to route its device-fidelity path, which is not
        ported: both phases would resolve alike here.)"""
        from ..kernels.plan import check_choice, resolve_backend
        check_choice("cim mode", self.mode, MODES)
        if self.mode != "ternary":
            return self
        spec = resolve_backend("ternary", self.backend, self.domain,
                               self.packing, platform)
        return dataclasses.replace(self, backend=spec.name)


def linear(x: torch.Tensor, w: Any, cfg: CIMConfig = CIMConfig()
           ) -> torch.Tensor:
    """Apply a linear layer under the configured mode.  A float weight
    under a ternary config is packed on every call, as the reference
    does."""
    from ..kernels import execute, ops, plan_matmul, platform_of, shape_of
    if cfg.mode == "ternary" or isinstance(w, ops.PackedTernary):
        pw = w if isinstance(w, ops.PackedTernary) else ops.pack_weights(
            w, cfg.packing)
        plan = plan_matmul(shape_of(x, pw), cfg, packing=pw.mode,
                           platform=platform_of(x))
        return execute(plan, x, pw)
    if cfg.mode == "float":
        return x @ w
    raise ValueError(f"unknown cim mode {cfg.mode!r}; expected one of "
                     f"{sorted(MODES)}")


def _packable(name: str, x: Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() in (2, 3, 4)
            and x.dtype in (torch.float32, torch.bfloat16)
            and min(x.shape[-2:]) >= 64
            and name not in ("embed", "router"))


def ternarize_params(params: Any, cfg: CIMConfig) -> Any:
    """Pack every matmul weight of a nested params dict: the 2/3/4-D
    float tensors whose two trailing dims are both >= 64 and whose name
    is not 'embed' or 'router' (so the unembed IS packed; norms and the
    embedding table stay float)."""
    from ..kernels import ops

    def convert(tree):
        if isinstance(tree, dict):
            return {k: (convert(v) if isinstance(v, dict) else
                        (ops.pack_weights(v, cfg.packing)
                         if _packable(k, v) else v))
                    for k, v in tree.items()}
        return tree

    return convert(params)


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

"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
and combine (GShard style), as the reference computes it.

Tokens are flattened in batch-major order and routed in groups of
``group_size`` (``MOE_GROUP`` unless the caller names another); the last
group is zero-padded, and its pad rows are routed and take up capacity,
as in the reference.  Each expert holds ``cap = max(1, int(g*k*cf/E))``
rows per group; an assignment past it is dropped.  Its slot is the
running count of the expert's assignments in token-major, choice-minor
order, which decides which assignment is dropped.

Where each row of the input stands for a call of its own
(``kernels.plan.rows_as_calls``: the schedulers' per-slot decode, which
the reference vmaps over batch-1 decodes), each row forms its own
groups.

The expert products: a packed expert stack (``PackedTernary`` of
(E, K, N)) runs through the float-domain ternary matmul, one call per
expert and weight over every group's capacity rows (``M = G*C``),
whatever the CIM config asks of the other weights (the reference
dequantizes its experts into a plain einsum under every mode, domain and
fidelity).  A float expert stack is a plain matmul.  Each product is cast
to the activations' dtype, as the reference's einsum returns it.
"""
from __future__ import annotations

import functools

import torch

from ..core import cim_linear
from ..kernels.ops import PackedTernary
from ..kernels.plan import rows_are_calls
from .config import ModelConfig, ParamSpec
from .layers import silu

MOE_GROUP = 1024


def moe_defs(cfg: ModelConfig, layers: int) -> dict:
    """The router (L, d, E) in f32 and the stacked experts (L, E, d, f),
    (L, E, f, d)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    L = (layers,)
    return {"router": ParamSpec(L + (d, e), dtype=torch.float32,
                                axes=("layers", "embed", "none")),
            "w1": ParamSpec(L + (e, d, f),
                            axes=("layers", "expert", "embed", "mlp")),
            "w3": ParamSpec(L + (e, d, f),
                            axes=("layers", "expert", "embed", "mlp")),
            "w2": ParamSpec(L + (e, f, d),
                            axes=("layers", "expert", "mlp", "embed"))}


@functools.lru_cache(maxsize=None)
def expert_cim(cim, packing: str) -> cim_linear.CIMConfig:
    """The plan request of a packed expert product: the ternary float
    domain at exact fidelity, on the caller's kernel backend when that
    backend is an exact one (``cuda``, ``torch``, ``ref``), else on
    whatever ``auto`` finds (the device backend serves device plans
    only)."""
    backend = "auto"
    if cim is not None and cim.fidelity == "exact":
        backend = cim.backend
    return cim_linear.CIMConfig(
        mode="ternary", packing=packing, backend=backend, domain="float",
        kv_layout=cim.kv_layout if cim is not None else "dense",
        fidelity="exact")


def expert_product(x: torch.Tensor, w, cim=None) -> torch.Tensor:
    """x (M, K) @ one expert's weight, in x's dtype."""
    if isinstance(w, PackedTernary):
        return cim_linear.linear(x, w, expert_cim(cim, w.mode)).to(x.dtype)
    return x @ w


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """The gates (renormalised to sum to one) and experts of each
    token's k largest router probabilities, in descending order, ties to
    the lower expert index (as ``jax.lax.top_k``; ``torch.topk``
    promises no order among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
          dtype) -> tuple:
    """Routing of the groups ``xg`` (G, g, d): (dispatch, combine) of
    (G, g, E, C) in ``dtype``, the router probabilities (G, g, E) and
    the choices' one-hot (G, g, k, E)."""
    ng, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("ngd,de->nge", xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    cap = max(1, int(g * k * cfg.moe_capacity_factor / e))
    onehot = torch.nn.functional.one_hot(gate_idx, e).to(torch.int32)
    flat = onehot.reshape(ng, g * k, e)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) * flat
           - 1).reshape(ng, g, k, e)
    within = (pos >= 0) & (pos < cap)
    dispatch = torch.zeros((ng, g, e, cap), dtype=dtype, device=xg.device)
    combine = torch.zeros_like(dispatch)
    for i in range(k):
        sel = (onehot[:, :, i] * within[:, :, i]).to(dtype)     # (G,g,E)
        oh_cap = torch.nn.functional.one_hot(
            torch.clamp(pos[:, :, i], 0, cap - 1).long(), cap).to(dtype)
        d_i = oh_cap * sel[..., None]
        dispatch = dispatch + d_i
        combine = combine + d_i * gate_vals[:, :, i, None, None].to(dtype)
    return dispatch, combine, probs, onehot


def moe_block(x: torch.Tensor, w: dict, cfg: ModelConfig, cim=None,
              group_size: int = MOE_GROUP) -> tuple:
    """x (B, S, d) -> (y (B, S, d), aux): the routed experts' SwiGLU and
    the load-balancing auxiliary loss (an f32 scalar tensor)."""
    b, s, d = x.shape
    e = cfg.num_experts
    calls = b if rows_are_calls() else 1
    t = b * s // calls
    g = min(group_size, t)
    pad = -t % g
    xt = x.reshape(calls, t, d)
    if pad:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(-1, g, d)                                   # (G,g,d)
    ng = xg.shape[0]
    dispatch, combine, probs, onehot = route(xg, w["router"], cfg, x.dtype)
    cap = dispatch.shape[-1]
    xe = torch.einsum("ngec,ngd->necd", dispatch, xg)           # (G,E,C,d)
    ye = []
    for j in range(e):
        xj = xe[:, j].reshape(ng * cap, d)
        h = (silu(expert_product(xj, w["w1"][j], cim))
             * expert_product(xj, w["w3"][j], cim))
        ye.append(expert_product(h, w["w2"][j], cim).reshape(ng, cap, d))
    ye = torch.stack(ye, dim=1)                                 # (G,E,C,d)
    y = torch.einsum("ngec,necd->ngd", combine, ye)
    y = y.reshape(calls, t + pad, d)[:, :t].reshape(b, s, d)
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(dim=2).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce) * 1e-2
    return y, aux


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

On a mesh (:func:`moe_block_sharded`) the experts of a packed stack may
be split over a mesh dim (``dist.runtime.ShardedPacked.ep``: over
``model`` under the serve rules, over ``data`` under ``ep-data``) and
the rows over the DP dims (``dist.sharding.row_split``).  The block then
routes on the groups the unmeshed call forms: each rank's router logits
are all-gathered over the row split and every rank routes the whole
call.  A rank's own tokens fill their capacity slots (the dispatch
product of its rows; the other rows are zero, so each slot holds exactly
the unmeshed value); the slots of its experts are summed over the row
split, or, where the experts lie on a dim the rows are split over, sent
to the experts' owners by ``all_to_all`` and summed there.  Each rank
runs its own experts' products on every group's capacity rows (the
unmeshed M): the ranks of a row split repeat each other's expert work,
and the slots' sum over the split is an all-reduce of (G, E_local, C,
d) a layer, the price of the unmeshed routes and bits (ROADMAP queue 3
item 4 (g)).  The outputs come back along E (an all-gather, or the
``all_to_all`` back, each owner sending a rank the slots of that rank's
tokens) and the combine runs on the whole E and every row before the
rank keeps its own.  Every sum of the dispatch and the combine over a
slot or a token has the unmeshed terms and exact zeros, and the expert
products and the combine run on the unmeshed M, so the block's output
is bitwise the unmeshed one's wherever the router's product gives a
rank's rows the bits it gives them among all rows (on the CPU, from two
rows a rank: one row takes BLAS's matrix-vector kernel and its order).
The auxiliary loss's two means run over the whole call's probabilities
and choices, which every rank holds, so every rank's loss carries the
unmeshed aux.

Under grad (the meshed train step, which installs the row split) the
gather of the logits and the slots' sum carry gradients
(``dist.runtime.gather_split``, ``sum_rows``): each backward sums the
ranks' loss gradients and sends each rank the part of its own rows, so
the step's mean over the ranks' losses has the unmeshed loss's
gradient, aux included.  Training holds float experts, whole on every
rank (no expert split).
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
          dtype, logits=None) -> tuple:
    """Routing of the groups ``xg`` (G, g, d) (or of their router
    ``logits`` (G, g, E), given): (dispatch, combine) of (G, g, E, C) in
    ``dtype``, the router probabilities (G, g, E) and the choices'
    one-hot (G, g, k, E)."""
    if logits is None:
        logits = torch.einsum("ngd,de->nge", xg.float(), router.float())
    ng, g, _ = logits.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    cap = max(1, int(g * k * cfg.moe_capacity_factor / e))
    onehot = torch.nn.functional.one_hot(gate_idx, e).to(torch.int32)
    flat = onehot.reshape(ng, g * k, e)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) * flat
           - 1).reshape(ng, g, k, e)
    within = (pos >= 0) & (pos < cap)
    dispatch = torch.zeros((ng, g, e, cap), dtype=dtype,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    for i in range(k):
        sel = (onehot[:, :, i] * within[:, :, i]).to(dtype)     # (G,g,E)
        oh_cap = torch.nn.functional.one_hot(
            torch.clamp(pos[:, :, i], 0, cap - 1).long(), cap).to(dtype)
        d_i = oh_cap * sel[..., None]
        dispatch = dispatch + d_i
        combine = combine + d_i * gate_vals[:, :, i, None, None].to(dtype)
    return dispatch, combine, probs, onehot


def _experts(xe: torch.Tensor, w: dict, cim) -> torch.Tensor:
    """The SwiGLU of each expert of ``w``'s stacks on its capacity rows
    ``xe`` (G, E, C, d) -> (G, E, C, d)."""
    ng, e, cap, d = xe.shape
    ye = []
    for j in range(e):
        xj = xe[:, j].reshape(ng * cap, d)
        h = (silu(expert_product(xj, w["w1"][j], cim))
             * expert_product(xj, w["w3"][j], cim))
        ye.append(expert_product(h, w["w2"][j], cim).reshape(ng, cap, d))
    return torch.stack(ye, dim=1)


def _aux(probs: torch.Tensor, onehot: torch.Tensor, e: int) -> torch.Tensor:
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(dim=2).float().mean(dim=(0, 1))
    return e * torch.sum(me * ce) * 1e-2


def moe_block(x: torch.Tensor, w: dict, cfg: ModelConfig, cim=None,
              group_size: int = MOE_GROUP) -> tuple:
    """x (B, S, d) -> (y (B, S, d), aux): the routed experts' SwiGLU and
    the load-balancing auxiliary loss (an f32 scalar tensor)."""
    from ..dist.sharding import get_row_split
    ep = getattr(w["w1"], "ep", None)
    split = get_row_split()
    if ep is not None or split is not None:
        return moe_block_sharded(x, w, cfg, cim, group_size, ep, split)
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
    ye = _experts(xe, w, cim)                                   # (G,E,C,d)
    y = torch.einsum("ngec,necd->ngd", combine, ye)
    y = y.reshape(calls, t + pad, d)[:, :t].reshape(b, s, d)
    return y, _aux(probs, onehot, e)


def _owners_on(split, ep_dim: int, b: int, s: int, calls: int, t: int,
               pad: int, device) -> torch.Tensor:
    """(calls, t + pad) int64: the coordinate on mesh dim ``ep_dim`` of
    the rank whose rows hold each token of the whole call (-1 for the
    pad tokens); every rank holds ``b`` rows of ``s`` tokens."""
    flat = torch.arange(calls * t, device=device).reshape(calls, t)
    owner = (flat // s) // b                 # linear index in the split
    at = split.dims.index(ep_dim)
    for n in split.sizes[at + 1:]:
        owner = owner // n
    owner = owner % split.sizes[at]
    return torch.nn.functional.pad(owner, (0, pad), value=-1)


def moe_block_sharded(x: torch.Tensor, w: dict, cfg: ModelConfig, cim,
                      group_size: int, ep, split) -> tuple:
    """:func:`moe_block` on a mesh (see the module docstring): ``x`` is
    this rank's block of rows of the call split by ``split`` (a
    ``dist.sharding.RowSplit``, or None when the rows are the whole
    call), ``ep`` the ``ExpertSplit`` of the packed stacks (None when
    this rank holds every expert)."""
    import torch.distributed as dist
    from ..dist import runtime as dist_rt
    b, s, d = x.shape
    e = cfg.num_experts
    blocks = split.count if split is not None else 1
    mine = split.index if split is not None else 0
    b_all = b * blocks
    calls = b_all if rows_are_calls() else 1
    t = b_all * s // calls
    g = min(group_size, t)
    pad = -t % g
    # the unmeshed groups: every rank routes the whole call
    logits = torch.einsum("ngd,de->nge", x.reshape(1, b * s, d).float(),
                          w["router"].float()).reshape(b, s, e)
    logits = dist_rt.gather_split(logits, split).reshape(calls, t, e)
    if pad:
        logits = torch.nn.functional.pad(logits, (0, 0, 0, pad))
    dispatch, combine, probs, onehot = route(
        None, None, cfg, x.dtype, logits=logits.reshape(-1, g, e))
    cap = dispatch.shape[-1]
    ng = dispatch.shape[0]
    # this rank's tokens fill their slots; the other rows are zero
    xa = x
    if split is not None:
        xa = x.new_zeros((b_all, s, d))
        xa[mine * b:(mine + 1) * b] = x
    xt = xa.reshape(calls, t, d)
    if pad:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, pad))
    xe = torch.einsum("ngec,ngd->necd", dispatch,
                      xt.reshape(-1, g, d)).contiguous()
    e_l = e // ep.count if ep is not None else e
    lo = ep.index * e_l if ep is not None else 0
    a2a = ep is not None and split is not None and ep.dim in split.dims
    if a2a:
        # the other split dims first, then to the experts' owners
        dist_rt.reduce_split(xe, split, "sum", skip=(ep.dim,))
        send = xe.transpose(0, 1).contiguous()                  # (E,G,C,d)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=ep.group)
        xe_own = recv.reshape(ep.count, e_l, ng, cap, d).sum(dim=0)
        xe_own = xe_own.transpose(0, 1)
    else:
        xe_own = dist_rt.sum_rows(xe[:, lo:lo + e_l], split)
    ye_own = _experts(xe_own, w, cim)                           # (G,El,C,d)
    if ep is None:
        ye = ye_own
    elif a2a:
        # each peer gets the products of the slots its tokens fill
        owner = _owners_on(split, ep.dim, b, s, calls, t, pad,
                           x.device).reshape(ng, g)
        mine_d = dispatch[:, :, lo:lo + e_l]                    # (G,g,El,C)
        send = torch.stack([
            ye_own * (mine_d * (owner == p)[..., None, None].to(
                mine_d.dtype)).sum(dim=1)[..., None]
            for p in range(ep.count)]).contiguous()        # (D,G,El,C,d)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=ep.group)
        ye = recv.permute(1, 0, 2, 3, 4).reshape(ng, e, cap, d)
    else:
        parts = [torch.empty_like(ye_own) for _ in range(ep.count)]
        dist.all_gather(parts, ye_own.contiguous(), group=ep.group)
        ye = torch.cat(parts, dim=1)
    y = torch.einsum("ngec,necd->ngd", combine, ye)
    y = y.reshape(calls, t + pad, d)[:, :t].reshape(b_all, s, d)
    return y[mine * b:(mine + 1) * b], _aux(probs, onehot, e)


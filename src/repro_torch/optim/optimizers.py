"""Optimizers as (init, state_defs, update) triples, as the reference's
``repro.optim.optimizers``.

``update(grads, state, params, step)`` updates ``params`` and ``state``
in place (under ``torch.no_grad()``) and returns them with the metrics
``{grad_norm, lr}``: the counterpart of the reference's donated jit, so
the parameters and the optimizer state are held once.  ``step`` is the
int32 step counter (a 0-d tensor on the parameters' device, or an int).

The arithmetic is the reference's, operation by operation, in f32: the
learning rate is a 0-d f32 tensor, so ``p - lr * upd`` is computed in
f32 and only then cast to the parameter's dtype (torch would otherwise
keep a bf16 product: a 0-d tensor does not promote), and ``b1 ** t`` is
an f32 power.  The leaves are visited in the reference's order
(``repro_torch.tree``): ``global_norm`` sums them in it.

``state_defs`` maps the model's ``ParamSpec`` tree to the state's, as
the reference maps its ``ParamDef`` tree: AdamW's moments and SGD's
momentum take the parameter's shape and axes, Adafactor's factored
moments drop one of the last two dims.

On a mesh (``dist.runtime``) the params, grads and state are DTensors of
one placement per leaf.  AdamW's and SGD's updates are elementwise, so
they run on each rank's local pieces; ``global_norm`` adds each rank's
local sums (a piece replicated over a mesh dim counted once) and sums
them over the mesh.  Adafactor's factored moments reduce over the last
two dims and raise on a DTensor (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .. import tree
from ..dist import runtime as dist_rt
from ..models.config import ParamSpec


class Optimizer(NamedTuple):
    init: Callable          # params -> state
    state_defs: Callable    # ParamSpec tree -> ParamSpec tree
    update: Callable        # (grads, state, params, step) -> (params,
                            # state, metrics), params and state in place


def _f32(step) -> torch.Tensor:
    """The step as a 0-d f32 tensor."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _step_on(step, params) -> torch.Tensor:
    """The step as a 0-d int32 tensor on the parameters' device."""
    device = tree.leaves(params)[0].device
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int32)
    return torch.tensor(int(step), dtype=torch.int32, device=device)


# ------------------------------------------------------------- schedules

def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor``
    times it at ``total``; f32 throughout."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_lr(v: float) -> Callable:
    return lambda step: torch.full((), v, dtype=torch.float32,
                                   device=_f32(step).device)


# elements of a leaf the f32 temporaries of the norm, the clip and the
# updates cover at a time: a stacked leaf (3-D or more) past it is taken
# one slice of its leading axis at a time (zamba2-7b's Mamba2 in_proj,
# 81 x 3584 x 14576, would need 15.8 GiB for each full f32 copy)
PIECE = 1 << 28


def _parts(x: torch.Tensor) -> list:
    """Indices covering ``x``: the whole of it, or, for a stacked leaf
    past ``PIECE`` elements, each slice of its leading axis."""
    if x.dim() < 3 or x.numel() <= PIECE:
        return [slice(None)]
    return list(range(x.shape[0]))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sums of squares, added leaf by leaf in the
    reference's order (a sliced leaf's slices in turn).  DTensor leaves
    add this rank's piece where it owns it (``dist.runtime.owns``), and
    the total is summed over the mesh."""
    total = 0
    mesh = None
    for g in tree.leaves(grads):
        if dist_rt.is_dtensor(g):
            mesh = g.device_mesh
            if not dist_rt.owns(g):
                continue
            g = g.to_local()
        for i in _parts(g):
            total = total + torch.sum(torch.square(g[i].to(torch.float32)))
    if mesh is not None:           # (a rank may own no piece at all)
        device = dist_rt.local(tree.leaves(grads)[0]).device
        total = dist_rt.world_sum(torch.as_tensor(
            total, dtype=torch.float32, device=device), mesh)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the grads in place by min(1, max_norm / norm); returns them
    and the norm before clipping."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-12), max=1.0)
    for x in map(dist_rt.local, tree.leaves(grads)):
        # in f32, then rounded to x's dtype: on the card x.mul_(scale)
        # would round the 0-d f32 scale to a bf16 x's dtype first
        for i in _parts(x):
            x[i].copy_(x[i].to(torch.float32) * scale)
    return grads, g


def _norm_and_clip(grads, max_grad_norm):
    if max_grad_norm:
        return clip_by_global_norm(grads, max_grad_norm)[1]
    return global_norm(grads)


def _apply(p: torch.Tensor, lr_t: torch.Tensor, upd: torch.Tensor) -> None:
    """p <- (p - lr * upd.astype(p.dtype)) in f32, cast to p's dtype."""
    step = lr_t * upd.to(p.dtype).to(torch.float32)
    p.copy_(p.to(torch.float32) - step)


# ---------------------------------------------------------------- AdamW

def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: float = 1.0, state_dtype=torch.float32
          ) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def init(params):
        zero = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                     device=p.device)
        return {"mu": tree.map_leaves(zero, params),
                "nu": tree.map_leaves(zero, params)}

    def state_defs(param_specs):
        like = lambda d: ParamSpec(d.shape, "zeros", state_dtype, d.axes)
        return {"mu": tree.map_specs(like, param_specs),
                "nu": tree.map_specs(like, param_specs)}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = _norm_and_clip(grads, max_grad_norm)
        out = (params, state)
        grads, state, params = map(dist_rt.local_tree,
                                   (grads, state, params))
        step = _step_on(step, params)
        t = _f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        lr_t = lr_fn(step)

        def leaf(p, g, mu, nu):
            for i in _parts(p):
                gi = g[i].to(state_dtype)
                mu[i].mul_(b1).add_((1 - b1) * gi)
                nu[i].mul_(b2).add_((1 - b2) * torch.square(gi))
                upd = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + eps)
                if weight_decay:
                    upd = upd + weight_decay * p[i].to(state_dtype)
                _apply(p[i], lr_t, upd)

        tree.map_leaves(leaf, params, grads, state["mu"], state["nu"])
        return out + ({"grad_norm": gnorm, "lr": lr_t},)

    return Optimizer(init, state_defs, update)


# ------------------------------------------------------------ Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(lr: Callable | float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, max_grad_norm: float = 1.0,
              min_dim_size_to_factor: int = 2) -> Optimizer:
    """Factored second moments (Shazeer & Stern, 2018): a matrix keeps a
    row vector ``r`` and a column vector ``c`` in f32, anything else a
    full ``v``; the update is clipped to an RMS of ``clip_threshold``."""
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return tree.map_leaves(leaf, params)

    def state_defs(param_specs):
        def leaf(d: ParamSpec):
            shape, axes = tuple(d.shape), tuple(d.axes)
            if _factored(shape):
                return {"r": ParamSpec(shape[:-1], "zeros", torch.float32,
                                       axes[:-1]),
                        "c": ParamSpec(shape[:-2] + shape[-1:], "zeros",
                                       torch.float32,
                                       axes[:-2] + axes[-1:])}
            return {"v": ParamSpec(shape, "zeros", torch.float32, axes)}
        return tree.map_specs(leaf, param_specs)

    @torch.no_grad()
    def update(grads, state, params, step):
        if any(map(dist_rt.is_dtensor, tree.leaves(params))):
            raise NotImplementedError(
                "Adafactor on a mesh: its factored moments reduce over "
                "the last two dims, which the placements may split "
                "(ROADMAP queue 1 item 8); use adamw or sgd")
        gnorm = _norm_and_clip(grads, max_grad_norm)
        step = _step_on(step, params)
        t = _f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def unclipped(g, s, i, first: bool):
            """The update of part i of a leaf before the RMS clip; the
            first pass over a part updates its moments."""
            g32 = g[i].to(torch.float32)
            if "r" in s:
                r, c = s["r"][i], s["c"][i]
                if first:
                    g2 = torch.square(g32) + eps
                    r.copy_(beta * r + (1 - beta) * g2.mean(dim=-1))
                    c.copy_(beta * c + (1 - beta) * g2.mean(dim=-2))
                    del g2
                # rank-1 reconstruction of the second moment
                denom = (r[..., None] / torch.clamp_min(
                    r.mean(dim=-1, keepdim=True), eps)[..., None]) * \
                    c[..., None, :]
                return g32 * torch.rsqrt(torch.clamp_min(denom, eps))
            v = s["v"][i]
            if first:
                v.copy_(beta * v + (1 - beta) * (torch.square(g32) + eps))
            return g32 * torch.rsqrt(torch.clamp_min(v, eps))

        def leaf(p, g, s):
            parts = _parts(p)
            # update clipping (RMS)
            if len(parts) == 1:
                upd = unclipped(g, s, parts[0], True)
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
                _apply(p, lr_t, upd / torch.clamp_min(rms / clip_threshold,
                                                       1.0))
                return
            # a sliced leaf: the sum of squares over its slices, then each
            # slice's update again, clipped
            sq = 0
            for i in parts:
                sq = sq + torch.sum(torch.square(unclipped(g, s, i, True)))
            rms = torch.sqrt(sq / p.numel() + 1e-12)
            scale = torch.clamp_min(rms / clip_threshold, 1.0)
            for i in parts:
                _apply(p[i], lr_t, unclipped(g, s, i, False) / scale)

        # the state holds a dict where the params hold a leaf
        tree.map_leaves(leaf, params, grads, state)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, state_defs, update)


# ----------------------------------------------------------------- SGD

def sgd(lr: Callable | float, momentum: float = 0.0,
        max_grad_norm: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    def init(params):
        if momentum:
            return {"m": tree.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)}
        return {}

    def state_defs(param_specs):
        if momentum:
            return {"m": tree.map_specs(
                lambda d: ParamSpec(d.shape, "zeros", torch.float32,
                                    d.axes),
                param_specs)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = _norm_and_clip(grads, max_grad_norm)
        out = (params, state)
        grads, state, params = map(dist_rt.local_tree,
                                   (grads, state, params))
        lr_t = lr_fn(_step_on(step, params))
        if momentum:
            def leaf(p, g, m):
                m.mul_(momentum).add_(g.to(torch.float32))
                p.copy_(p.to(torch.float32) - lr_t * m)
            tree.map_leaves(leaf, params, grads, state["m"])
        else:
            def leaf(p, g):
                p.copy_(p.to(torch.float32) - lr_t * g.to(torch.float32))
            tree.map_leaves(leaf, params, grads)
        return out + ({"grad_norm": gnorm, "lr": lr_t},)

    return Optimizer(init, state_defs, update)

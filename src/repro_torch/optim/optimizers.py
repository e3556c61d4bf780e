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
momentum take the parameter's shape, Adafactor's factored moments drop
one of the last two dims.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .. import tree
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


def global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sums of squares, added leaf by leaf in the
    reference's order."""
    total = 0
    for g in tree.leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the grads in place by min(1, max_norm / norm); returns them
    and the norm before clipping."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-12), max=1.0)
    for x in tree.leaves(grads):
        # in f32, then rounded to x's dtype: on the card x.mul_(scale)
        # would round the 0-d f32 scale to a bf16 x's dtype first
        x.copy_(x.to(torch.float32) * scale)
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
        like = lambda d: ParamSpec(d.shape, "zeros", state_dtype)
        return {"mu": tree.map_specs(like, param_specs),
                "nu": tree.map_specs(like, param_specs)}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = _norm_and_clip(grads, max_grad_norm)
        step = _step_on(step, params)
        t = _f32(step) + 1.0
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        lr_t = lr_fn(step)

        def leaf(p, g, mu, nu):
            g = g.to(state_dtype)
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(state_dtype)
            _apply(p, lr_t, upd)

        tree.map_leaves(leaf, params, grads, state["mu"], state["nu"])
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

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
            shape = tuple(d.shape)
            if _factored(shape):
                return {"r": ParamSpec(shape[:-1], "zeros", torch.float32),
                        "c": ParamSpec(shape[:-2] + shape[-1:], "zeros",
                                       torch.float32)}
            return {"v": ParamSpec(shape, "zeros", torch.float32)}
        return tree.map_specs(leaf, param_specs)

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = _norm_and_clip(grads, max_grad_norm)
        step = _step_on(step, params)
        t = _f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def leaf(p, g, s):
            g32 = g.to(torch.float32)
            g2 = torch.square(g32) + eps
            if "r" in s:
                s["r"].copy_(beta * s["r"] + (1 - beta) * g2.mean(dim=-1))
                s["c"].copy_(beta * s["c"] + (1 - beta) * g2.mean(dim=-2))
                r, c = s["r"], s["c"]
                # rank-1 reconstruction of the second moment
                denom = (r[..., None] / torch.clamp_min(
                    r.mean(dim=-1, keepdim=True), eps)[..., None]) * \
                    c[..., None, :]
                upd = g32 * torch.rsqrt(torch.clamp_min(denom, eps))
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                upd = g32 * torch.rsqrt(torch.clamp_min(s["v"], eps))
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
            upd = upd / torch.clamp_min(rms / clip_threshold, 1.0)
            _apply(p, lr_t, upd)

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
                lambda d: ParamSpec(d.shape, "zeros", torch.float32),
                param_specs)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = _norm_and_clip(grads, max_grad_norm)
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
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, state_defs, update)

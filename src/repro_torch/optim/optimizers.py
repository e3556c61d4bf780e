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
them over the mesh.  Adafactor's factored moments are means over the
last two dims, which the train rules split: each is a local sum
all-reduced over the mesh dims that split its dim, over the dim's global
extent, and its RMS clip sums squares over the whole leaf as
``global_norm`` does.  A leaf no mesh dim of more than one rank splits
(every leaf on one card) takes the unmeshed arithmetic, op for op.
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


class _Split:
    """How a DTensor leaf is split over its mesh, for Adafactor's
    reductions: the process groups of the mesh dims (of more than one
    rank) that split each of its last two dims, its global numel, and
    whether any such dim splits it at all.  A plain tensor, or a leaf no
    mesh dim of more than one rank splits, reduces in place: the
    unmeshed arithmetic, op for op."""

    def __init__(self, x):
        self.x = x
        self.mesh = x.device_mesh if dist_rt.is_dtensor(x) else None
        self.numel = x.numel()
        self.by_dim = {}
        if self.mesh is None:
            return
        nd = x.ndim
        for i, p in enumerate(x.placements):
            if p.is_shard() and self.mesh.size(i) > 1:
                self.by_dim.setdefault(p.dim % nd, []).append(
                    self.mesh.get_group(i))

    @property
    def split(self) -> bool:
        return bool(self.by_dim)

    def mean(self, y: torch.Tensor, dim: int, tensor_dim: int,
             keepdim: bool = False) -> torch.Tensor:
        """``y.mean(dim)`` over the whole of the leaf's ``tensor_dim``
        (which ``dim`` of ``y``'s local piece runs along): a local sum
        all-reduced over the mesh dims that split it, over its global
        extent."""
        groups = self.by_dim.get(tensor_dim % self.x.ndim)
        if not groups:
            return y.mean(dim=dim, keepdim=keepdim)
        import torch.distributed as dist
        out = y.sum(dim=dim, keepdim=keepdim)
        for group in groups:
            dist.all_reduce(out, group=group)
        return out / self.x.shape[tensor_dim]

    def total(self, sq: torch.Tensor) -> torch.Tensor:
        """The whole leaf's sum from ``sq``, this rank's sum over its
        piece: counted where the rank owns the piece
        (``dist.runtime.owns``), summed over the mesh."""
        if not self.split:
            return sq
        if not dist_rt.owns(self.x):
            sq = torch.zeros_like(sq)
        return dist_rt.world_sum(sq, self.mesh)

    def moments(self, s: dict) -> tuple:
        """(the moment leaves' local pieces aligned with the leaf's piece,
        a function writing them back): ``r`` keeps the leaf's split of
        its leading dims (its last dim is the leaf's rows), ``c`` the
        leaf's split of every dim but the rows, ``v`` the leaf's; a
        moment placed otherwise is redistributed to that and back."""
        if self.mesh is None:
            return s, lambda: None
        from torch.distributed.tensor import Replicate, Shard
        nd = self.x.ndim

        def want(drop):
            out = []
            for p in self.x.placements:
                d = p.dim % nd if p.is_shard() else None
                if d is None or d == drop:
                    out.append(Replicate())
                else:
                    out.append(Shard(d - 1 if drop is not None and d > drop
                                     else d))
            return tuple(out)
        wants = {"r": want(nd - 1), "c": want(nd - 2), "v": want(None)}
        local, back = {}, []
        for k, m in s.items():
            w = wants[k]
            same = all(self.mesh.size(i) == 1 or a == b
                       for i, (a, b) in enumerate(zip(m.placements, w)))
            if same:
                local[k] = m.to_local()
                continue
            moved = m.redistribute(self.mesh, w)
            local[k] = moved.to_local()
            back.append((m, moved))

        def write_back():
            for m, moved in back:
                m.to_local().copy_(moved.redistribute(
                    self.mesh, tuple(m.placements)).to_local())
        return local, write_back


def adafactor(lr: Callable | float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, max_grad_norm: float = 1.0,
              min_dim_size_to_factor: int = 2) -> Optimizer:
    """Factored second moments (Shazeer & Stern, 2018): a matrix keeps a
    row vector ``r`` and a column vector ``c`` in f32, anything else a
    full ``v``; the update is clipped to an RMS of ``clip_threshold``.
    On a mesh the means over the last two dims and the RMS run over the
    whole leaf (:class:`_Split`)."""
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
        gnorm = _norm_and_clip(grads, max_grad_norm)
        step = _step_on(step, dist_rt.local_tree(params))
        t = _f32(step) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def unclipped(g, s, i, first: bool, sp: _Split):
            """The update of part i of a leaf before the RMS clip; the
            first pass over a part updates its moments."""
            g32 = g[i].to(torch.float32)
            nd = sp.x.ndim
            if "r" in s:
                r, c = s["r"][i], s["c"][i]
                if first:
                    g2 = torch.square(g32) + eps
                    r.copy_(beta * r + (1 - beta) * sp.mean(g2, -1, nd - 1))
                    c.copy_(beta * c + (1 - beta) * sp.mean(g2, -2, nd - 2))
                    del g2
                # rank-1 reconstruction of the second moment
                denom = (r[..., None] / torch.clamp_min(
                    sp.mean(r, -1, nd - 2, keepdim=True), eps)[..., None]) \
                    * c[..., None, :]
                return g32 * torch.rsqrt(torch.clamp_min(denom, eps))
            v = s["v"][i]
            if first:
                v.copy_(beta * v + (1 - beta) * (torch.square(g32) + eps))
            return g32 * torch.rsqrt(torch.clamp_min(v, eps))

        def leaf(p, g, s):
            sp = _Split(p)
            p, g = dist_rt.local(p), dist_rt.local(g)
            s, write_back = sp.moments(s)
            parts = _parts(p)
            # update clipping (RMS)
            if len(parts) == 1 and not sp.split:
                upd = unclipped(g, s, parts[0], True, sp)
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
                _apply(p, lr_t, upd / torch.clamp_min(rms / clip_threshold,
                                                       1.0))
            elif len(parts) == 1:
                upd = unclipped(g, s, parts[0], True, sp)
                rms = torch.sqrt(sp.total(torch.sum(torch.square(upd)))
                                 / sp.numel + 1e-12)
                _apply(p, lr_t, upd / torch.clamp_min(rms / clip_threshold,
                                                       1.0))
            else:
                # a sliced leaf: the sum of squares over its slices, then
                # each slice's update again, clipped
                sq = 0
                for i in parts:
                    sq = sq + torch.sum(torch.square(
                        unclipped(g, s, i, True, sp)))
                rms = torch.sqrt(sp.total(sq) / sp.numel + 1e-12)
                scale = torch.clamp_min(rms / clip_threshold, 1.0)
                for i in parts:
                    _apply(p[i], lr_t, unclipped(g, s, i, False, sp) / scale)
            write_back()

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

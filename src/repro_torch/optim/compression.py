"""Gradient compression: int8 quantization with error feedback, as the
reference's ``repro.optim.compression``.

``compress_int8`` is symmetric per tensor: the f32 amax over 127, round
half to even, clip to +/-127; both divisions are true divisions on
either device (a Python-scalar divisor becomes a multiply by its
reciprocal on the card).  Error feedback (Karimireddy et al., 2019)
keeps each leaf's quantization residual in f32 and adds it to the next
step's gradient.

``int8_allgather_sync`` is the reference's shard_map over a mesh's
data axes, on a ``DeviceMesh``: each rank quantizes its gradient of a
leaf to int8 with one f32 scale, the int8 bytes and the scales are
all-gathered over the data axes of more than one rank, and every rank
dequantizes and takes the mean in the reference's order.  With no such
axis (one card, or ``mesh`` a mapping of axis sizes, the one-card
paths' form) it reduces to the no-axes branch: error feedback, then
return.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import tree


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g ~= q * scale, q int8 in [-127, 127], scale a 0-d f32 tensor."""
    g32 = g.to(torch.float32)
    amax = torch.clamp_min(g32.abs().amax(), 1e-12)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_init(params: Any) -> Any:
    """Error-feedback residuals: f32 zeros shaped as the params."""
    return tree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)


def ef_compress_grads(grads: Any, residual: Any) -> tuple[Any, Any]:
    """(compressed-then-decompressed grads, new residuals)."""
    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        q, s = compress_int8(corrected)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    pairs = tree.map_leaves(leaf, grads, residual)
    return (tree.map_leaves(lambda _, pr: pr[0], grads, pairs),
            tree.map_leaves(lambda _, pr: pr[1], grads, pairs))


def int8_allgather_sync(grads: Any, mesh: Any = None,
                        axes: tuple = ("data",),
                        residual: Any | None = None):
    """Sync data-parallel gradients with int8 on the wire: quantize each
    rank's gradient of a leaf (whole tensors), all-gather the bytes and
    the scales over the ``axes`` of ``mesh`` that have more than one
    rank, dequantize and take the mean, ``sum(q_i * s_i) / N`` over the
    ranks in the axes' order (outer first).  Equivalent to the mean of
    the grads up to int8 rounding; with ``residual`` the rounding error
    is fed back first, as in the reference.  ``mesh`` is a DeviceMesh,
    or a mapping of axis sizes, where an axis of more than one device
    raises (a mapping has no process group).  Returns (synced grads,
    new residual)."""
    from ..dist.runtime import is_mesh
    if is_mesh(mesh):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    else:
        sizes = {a: int(v) for a, v in dict(mesh or {}).items()}
    multi = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if multi and not is_mesh(mesh):
        raise NotImplementedError(
            f"int8 gradient sync over {multi} of {sizes}: a mapping of "
            f"axis sizes has no process group; pass a DeviceMesh "
            f"(dist.make_mesh; multi-GPU training, ROADMAP queue 1 item 8)")
    if residual is not None:
        grads, residual = ef_compress_grads(grads, residual)
    if not multi:
        return grads, residual
    groups = [mesh.get_group(mesh.mesh_dim_names.index(a)) for a in multi]

    def gather(x: torch.Tensor) -> torch.Tensor:
        """(N,) + x.shape over the axes, the outer axis outermost."""
        import torch.distributed as dist
        for g in reversed(groups):
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, x.contiguous(), group=g)
            x = torch.stack(parts)
        return x.reshape((-1,) + tuple(x.shape[len(groups):]))

    def one(g):
        q, s = compress_int8(g)
        qs, ss = gather(q), gather(s)
        n = qs.shape[0]
        ss = ss.reshape((n,) + (1,) * g.dim())
        total = torch.sum(qs.to(torch.float32) * ss, dim=0)
        return (total / total.new_full((), float(n))).to(g.dtype)

    return tree.map_leaves(one, grads), residual

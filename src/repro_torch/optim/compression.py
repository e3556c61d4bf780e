"""Gradient compression: int8 quantization with error feedback, as the
reference's ``repro.optim.compression``.

``compress_int8`` is symmetric per tensor: the f32 amax over 127, round
half to even, clip to +/-127; both divisions are true divisions on
either device (a Python-scalar divisor becomes a multiply by its
reciprocal on the card).  Error feedback (Karimireddy et al., 2019)
keeps each leaf's quantization residual in f32 and adds it to the next
step's gradient.

``int8_allgather_sync`` is the reference's shard_map over a mesh's
data axes.  The port runs on one card, where it reduces to its no-axes
branch: error feedback, then return.  ``mesh`` is a mapping of axis name
to size; an axis of more than one device raises (multi-GPU training is
ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

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


def int8_allgather_sync(grads: Any, mesh: Optional[Mapping[str, int]] = None,
                        axes: tuple = ("data",),
                        residual: Any | None = None):
    """The int8 data-parallel gradient sync on one card: error feedback
    where a residual is given, and nothing to gather.  Returns (grads,
    new residual)."""
    multi = tuple(a for a in axes if mesh and int(mesh.get(a, 1)) > 1)
    if multi:
        raise NotImplementedError(
            f"int8 gradient sync over {multi} of mesh {dict(mesh)}: "
            f"multi-GPU training is not ported (ROADMAP queue 1 item 8)")
    if residual is not None:
        grads, residual = ef_compress_grads(grads, residual)
    return grads, residual

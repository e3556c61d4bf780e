"""Restore-scrub and drift channels over packed parameter trees.

The serving schedulers use three operations, all deterministic per
campaign key and all on the weights' device (no host transfer):

  * :func:`disturb_packed_params` - the accumulated-error channel: each
    trit of every packed weight is replaced by a uniform random trit
    with probability ``rate``.  Applied once per decode chunk with a
    chunk-indexed key, so error compounds while serving.
  * :func:`scrub_packed_params` - the paper's DC-power-free restore as an
    online repair: every weight is restored again from its pristine
    TL-ReRAM contents through the measured-yield confusion channel.
    Accumulated drift is discarded; the residual error is bounded by
    ``1 - yield`` per state.
  * :func:`packed_trit_error_rate` - the fraction of trits that differ
    between two packed trees (the repair metric).

``adc_probe`` is the per-chunk health counter: the worst-case all-ones
input drive over the served weights, counting row-group CBL counts that
would saturate the ADC.  It returns device scalars that ride the
schedulers' one transfer a chunk.

Leaves are numbered as the reference numbers them: ``jax.tree_util``
walks a dict by sorted key, so :func:`packed_leaves` does too, whatever
order the port's dict was built in; leaf ``i`` folds ``i`` into the key.
A stacked leaf (layers leading) is worked one layer at a time; each
layer's trit planes draw the elements of the whole leaf's draw that are
theirs (``prng.Block``: one run per plane, strided by the planes), so
the result is bitwise that of one draw over the leaf while the
temporaries stay one layer's size.
"""
from __future__ import annotations

import math

import torch

from ..core import prng
from ..core.cim import MacroConfig
from ..core.error_injection import inject_trit_errors
from ..core.packing import (pack_trit_planes_base3, pack_trits2,
                            unpack_base3_to_planes, unpack_trits2)
from ..kernels.ops import PackedTernary

ROWS_ACTIVE = MacroConfig().rows_active


def packed_to_trits(leaf: PackedTernary, num_trits: int = 5
                    ) -> torch.Tensor:
    """PackedTernary -> (q, ..., K, N) int8 trit planes (q = 1 for
    trit2, whose K is the packed K, a multiple of 4)."""
    if leaf.mode == "base3":
        return unpack_base3_to_planes(leaf.data, num_trits)
    t = unpack_trits2(torch.movedim(leaf.data, -2, 0), leaf.kdim)
    return torch.movedim(t, 0, -2)[None]


def trits_to_packed(trits: torch.Tensor, leaf: PackedTernary
                    ) -> PackedTernary:
    """Inverse of :func:`packed_to_trits` (scale and mode kept)."""
    if leaf.mode == "base3":
        data = pack_trit_planes_base3(trits)
    else:
        data = torch.movedim(pack_trits2(torch.movedim(trits[0], -2, 0)),
                             0, -2)
    return PackedTernary(data.contiguous(), leaf.scale, leaf.mode)


def packed_leaves(params) -> list:
    """[(path, PackedTernary)] in ``jax.tree_util`` order (dicts by
    sorted key)."""
    if isinstance(params, PackedTernary):
        return [((), params)]
    if isinstance(params, dict):
        return [((k,) + path, leaf) for k in sorted(params)
                for path, leaf in packed_leaves(params[k])]
    return []


def _slices(leaf: PackedTernary):
    """(layer index, one layer's PackedTernary) over a leaf's leading
    axes, flattened."""
    lead = tuple(leaf.data.shape[:-2])
    if not lead:
        yield 0, leaf
        return
    flat = PackedTernary(leaf.data.reshape((-1,) + leaf.data.shape[-2:]),
                         leaf.scale.reshape((-1,) + leaf.scale.shape[-1:]),
                         leaf.mode)
    for i in range(flat.data.shape[0]):
        yield i, flat[i]


def _map_packed(params, fn, num_trits: int):
    """Apply ``fn(planes, leaf_index, draw_shape, block) -> planes`` to
    every layer of every packed leaf; ``planes`` (q, K, N) are the
    elements ``block`` of the leaf's trit tensor of ``draw_shape``.
    Other leaves pass through; the result is a new tree."""
    index = {path: i for i, (path, _) in enumerate(packed_leaves(params))}

    def remap(leaf, i):
        layers = math.prod(leaf.data.shape[:-2])
        data = torch.empty_like(leaf.data)
        flat = data.view((-1,) + tuple(data.shape[-2:]))
        for li, one in _slices(leaf):
            planes = packed_to_trits(one, num_trits)
            q, k, n = planes.shape
            draw_shape = ((q,) + tuple(leaf.data.shape[:-2]) + (k, n))
            blk = prng.Block(li * k * n, q, layers * k * n, k * n)
            flat[li] = trits_to_packed(fn(planes, i, draw_shape, blk),
                                       one).data
        return PackedTernary(data, leaf.scale, leaf.mode)

    def walk(tree, path):
        if isinstance(tree, PackedTernary):
            return remap(tree, index[path])
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return tree

    return walk(params, ())


def disturb_packed_params(params, rate: float, key: prng.Key,
                          num_trits: int = 5):
    """One chunk's drift / read disturb: every trit independently
    replaced by a uniform random trit with probability ``rate``."""
    if rate <= 0.0:
        return params

    def disturb(planes, i, draw_shape, blk):
        km, kv = prng.split(prng.fold_in(key, i))
        dev = planes.device
        flip = prng.bernoulli(km, rate, draw_shape, dev, blk)
        rnd = prng.randint(kv, draw_shape, -1, 2, dev, blk)
        return torch.where(flip.reshape(planes.shape),
                           rnd.reshape(planes.shape).to(torch.int8), planes)

    return _map_packed(params, disturb, num_trits)


def scrub_packed_params(pristine, per_state_yield, key: prng.Key,
                        num_trits: int = 5):
    """Restore-scrub: rebuild the served weights from the PRISTINE tree
    through the store -> restore confusion channel at
    ``per_state_yield`` (None = ideal restore: the pristine tree).
    Whatever the served tree drifted to is discarded."""
    if per_state_yield is None:
        return pristine

    def restore(planes, i, draw_shape, blk):
        return inject_trit_errors(planes, per_state_yield,
                                  prng.fold_in(key, i), draw_shape, blk)

    return _map_packed(pristine, restore, num_trits)


def packed_trit_error_rate(params_a, params_b, num_trits: int = 5
                           ) -> float:
    """Fraction of trits that differ between two packed trees of the
    same structure (a host-side diagnostic: it synchronizes)."""
    leaves_a = packed_leaves(params_a)
    leaves_b = packed_leaves(params_b)
    if len(leaves_a) != len(leaves_b):
        raise ValueError(
            f"packed trees differ in structure: {len(leaves_a)} vs "
            f"{len(leaves_b)} packed leaves")
    diff = total = 0
    for (_, a), (_, b) in zip(leaves_a, leaves_b):
        for (_, sa), (_, sb) in zip(_slices(a), _slices(b)):
            ta = packed_to_trits(sa, num_trits)
            tb = packed_to_trits(sb, num_trits)
            diff += int((ta != tb).sum())
            total += ta.numel()
    return diff / total if total else 0.0


def _probe_rows(trits: torch.Tensor, adc_bits: int) -> tuple:
    """(clip_lo, clip_hi) of an all-ones drive over trit planes
    (q, rows, N), grouped from row 0."""
    q, k, n = trits.shape
    ra = ROWS_ACTIVE
    g = -(-k // ra)
    pad = g * ra - k
    if pad:
        trits = torch.nn.functional.pad(trits, (0, 0, 0, pad))
    wsum = trits.reshape(q, g, ra, n).sum(dim=2, dtype=torch.int32)
    rows_real = torch.clamp(k - torch.arange(g, device=trits.device) * ra,
                            0, ra).to(torch.int32)
    count = rows_real[None, :, None] - wsum         # all-ones drive
    return ((count < 0).sum(dtype=torch.int32),
            (count > 2**adc_bits - 1).sum(dtype=torch.int32))


def adc_probe(params, adc_bits: int = 5, num_trits: int = 5) -> tuple:
    """Worst-case saturation probe over the FIRST packed leaf: drive every
    row with input trit +1 and count row-group CBL counts outside the
    ADC code space [0, 2^bits - 1].  A stacked leaf's planes are probed
    as (q, layers * K, N), as the reference reshapes them.  Returns
    (clip_lo, clip_hi) int32 device scalars (zeros on the CPU when no
    packed leaf exists)."""
    leaves = packed_leaves(params)
    if not leaves:
        zero = torch.zeros((), dtype=torch.int32)
        return zero, zero
    leaf = leaves[0][1]
    if leaf.data.dim() > 2 and leaf.kdim % ROWS_ACTIVE == 0:
        # no group straddles two layers: probe one layer at a time
        lo = hi = 0
        for _, one in _slices(leaf):
            a, b = _probe_rows(packed_to_trits(one, num_trits), adc_bits)
            lo, hi = lo + a, hi + b
        return lo, hi
    trits = packed_to_trits(leaf, num_trits)
    return _probe_rows(trits.reshape(trits.shape[0], -1, trits.shape[-1]),
                       adc_bits)

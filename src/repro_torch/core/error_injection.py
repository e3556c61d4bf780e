"""Yield-driven trit-error injection (the paper's Fig. 10 methodology).

Restore failures are boundary events: a state is misread as the
neighbouring state whose decision margin was violated (HRS <-> MRS via
V_REF2, MRS <-> LRS via V_REF1); double-boundary errors are ignored.
Keys are ``core.prng`` keys, so the sampled errors are bit for bit those
of the reference's ``jax.random`` keys of the same seed.
"""
from __future__ import annotations

import torch

from . import prng
from .ternary import TernaryTensor


def confusion_from_yields(per_state) -> torch.Tensor:
    """(3,) per-state yields [HRS(-1), MRS(0), LRS(+1)] -> (3, 3) f32
    confusion matrix, rows = true state (index trit + 1), cols = read.

    The input must have shape (3,) and finite values (a NaN yield would
    poison every sampled trit); each yield is clamped into [0, 1], since
    Monte-Carlo yields at small sample counts can come out at 1 + eps.
    Every row sums to 1 (asserted)."""
    y = torch.as_tensor(per_state, dtype=torch.float32).detach().cpu()
    if tuple(y.shape) != (3,):
        raise ValueError(f"per-state yields must have shape (3,) "
                         f"[HRS, MRS, LRS]; got {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        raise ValueError(f"per-state yields must be finite; got "
                         f"{[float(v) for v in y]}")
    y_h, y_m, y_l = torch.clamp(y, 0.0, 1.0)
    zero = torch.zeros((), dtype=torch.float32)
    # -1 fails -> read as 0; +1 fails -> read as 0; 0 splits to +/-1 evenly
    c = torch.stack([torch.stack([y_h, 1 - y_h, zero]),
                     torch.stack([(1 - y_m) / 2, y_m, (1 - y_m) / 2]),
                     torch.stack([zero, 1 - y_l, y_l])])
    row_sums = c.sum(dim=-1)
    assert bool(torch.all((row_sums - 1.0).abs() < 1e-6)), (
        f"confusion rows must sum to 1; got {[float(v) for v in row_sums]}")
    return c


def read_thresholds(per_state_yield) -> list:
    """Per true state (index trit + 1), the f32 CDF of its confusion row
    as three Python floats: a state reads as ``sum(u > cdf) - 1`` for a
    uniform ``u``."""
    c = confusion_from_yields(per_state_yield)
    out = []
    for row in c:
        c0 = row[0]
        c1 = c0 + row[1]
        out.append([float(c0), float(c1), float(c1 + row[2])])
    return out


def read_index(u: torch.Tensor, cdf: list) -> torch.Tensor:
    """sum(u > cdf) as int8: 0, 1 or 2 (the read state's index)."""
    return ((u > cdf[0]).to(torch.int8) + (u > cdf[1]).to(torch.int8)
            + (u > cdf[2]).to(torch.int8))


def apply_restore(trits: torch.Tensor, u: torch.Tensor,
                  thresholds: list) -> torch.Tensor:
    """The restore channel on trits given their uniforms ``u``."""
    reads = [read_index(u, cdf) for cdf in thresholds]
    idx = torch.where(trits < 0, reads[0],
                      torch.where(trits == 0, reads[1], reads[2]))
    return (idx - 1).to(torch.int8)


def inject_trit_errors(trits: torch.Tensor, per_state_yield,
                       key: prng.Key, draw_shape=None,
                       block: prng.Block = None) -> torch.Tensor:
    """Sample restore errors on a trit tensor ((q, ...) int8) from the
    uniforms of ``key`` over its shape; or, with ``block``, ``trits`` are
    the elements ``block`` of a tensor of ``draw_shape`` and get the same
    errors as that tensor would."""
    thresholds = read_thresholds(per_state_yield)
    u = prng.uniform(key, trits.shape if block is None else draw_shape,
                     device=trits.device, block=block)
    return apply_restore(trits, u.reshape(trits.shape), thresholds)


def inject_restore_errors(t: TernaryTensor, per_state_yield,
                          key: prng.Key) -> TernaryTensor:
    return TernaryTensor(inject_trit_errors(t.trits, per_state_yield, key),
                         t.scale)


def expected_trit_error_rate(per_state_yield,
                             prior=(0.25, 0.5, 0.25)) -> float:
    p = torch.as_tensor(prior, dtype=torch.float32)
    y = torch.as_tensor(per_state_yield, dtype=torch.float32)
    return float(torch.dot(p, 1.0 - y))

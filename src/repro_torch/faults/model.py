"""Composable, seeded fault models for device-fidelity execution.

A :class:`FaultModel` is a frozen, hashable description of one device
instance's non-idealities, the *campaign*: every channel draws from a
``core.prng`` key derived with ``stable_seed`` over (campaign seed,
channel name, tensor shape, parts), so the same model on the same tensor
gives bitwise the same faults across calls, processes and chunk
boundaries, and the same faults as the reference's campaign of the same
fields.  Channels compose (each is optional):

  restore_yield - per-state restore confusion (HRS/MRS/LRS) at the
      measured TL yield (``core.yield_model.tl_restore_yield``), sampled
      as ``core.error_injection.inject_trit_errors`` samples it;
  stuck_rate    - stuck-at cells: a per-cell mask frozen to a random
      trit, overriding every restore (fabrication defects);
  variation     - lognormal resistance variation and CMOS mismatch on
      each cell's discharge path, as a multiplicative conductance error
      (what the ADC integrates);
  drift_rate    - per-chunk read disturb: the serving engines apply it
      between decode chunks, so error accumulates until a restore-scrub
      repairs it (``faults.scrub``).

The restore and stuck-at channels' draws depend on (campaign, shape,
parts) only, not on the trits: :meth:`FaultModel.fault_trits` keeps each
draw as a one-byte *channel code* per element (what each of the three
true trits reads as) in a bounded cache on the trits' device, and
applies it to the trits of each call.  A decode step of internlm2-1.8b
meets five weight shapes, 1.15e9 trits, so the codes take 1.15 GB where
the uniforms would take 4.6; the results are bitwise those of drawing
anew.  Build a model at the measured paper yield with
:func:`measured_fault_model`; vary one with :func:`dataclasses.replace`.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import torch

from ..core import device_models as dm
from ..core import prng
from ..core.error_injection import read_index, read_thresholds
from ..core.seeding import stable_seed

# channel codes kept (a code is one byte per element of one shape)
CODE_CACHE_ENTRIES = 16
# elements per piece while a code is made (bounds the f32 temporaries)
CODE_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One device instance's fault channels (frozen and hashable: a
    campaign cache key)."""
    seed: int = 0
    restore_yield: Optional[tuple] = None    # (y_HRS, y_MRS, y_LRS)
    stuck_rate: float = 0.0
    variation: bool = True
    drift_rate: float = 0.0                  # per-chunk disturb channel
    adc_noise_sigma: float = 0.0             # ADC readout noise (LSB)
    device: dm.DeviceParams = dm.DeviceParams()

    def __post_init__(self):
        if self.restore_yield is not None:
            ry = tuple(float(y) for y in self.restore_yield)
            if len(ry) != 3:
                raise ValueError(
                    f"restore_yield must be 3 per-state yields "
                    f"[HRS, MRS, LRS]; got {self.restore_yield!r}")
            object.__setattr__(self, "restore_yield", ry)
        for name in ("stuck_rate", "drift_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]; got {v}")

    # ------------------------------------------------------------ keys
    def key_for(self, *parts) -> prng.Key:
        """Deterministic campaign key for a named channel draw."""
        return prng.key(stable_seed("faults", self.seed, *parts))

    # -------------------------------------------------------- channels
    def fault_trits(self, trits: torch.Tensor, *parts) -> torch.Tensor:
        """Restore-confusion and stuck-at channels on a trit tensor
        ((q, ..., K, N) int8 in {-1, 0, 1}).  Deterministic per
        (campaign, parts, shape): re-applying gives the same faults."""
        if self.restore_yield is None and self.stuck_rate == 0.0:
            return trits
        code = channel_code(self, tuple(trits.shape), parts, trits.device)
        return apply_code(code, trits)

    def conductance_multiplier(self, trits: torch.Tensor,
                               *parts) -> torch.Tensor:
        """Per-cell multiplicative conductance error of the discharge
        path: the sampled resistance at each trit's stored level
        (lognormal filament-gap variation) and CMOS mismatch, over the
        level's nominal conductance.  Ones when ``variation`` is off."""
        if not self.variation:
            return torch.ones(trits.shape, dtype=torch.float32,
                              device=trits.device)
        shape = tuple(trits.shape)
        kr, kc = prng.split(self.key_for("gvar", _shape_tag(shape), *parts))
        level = trits.to(torch.int32) + 1        # -1/0/+1 -> HRS/MRS/LRS
        r = dm.resistance_from_normals(
            level, prng.normal(kr, shape, trits.device), self.device)
        cmos = self.device.cmos_sigma_rel * prng.normal(kc, shape,
                                                        trits.device)
        g = dm.discharge_conductance(r, self.device, cmos)
        g_nom = dm.discharge_conductance(
            dm.level_resistance(level, self.device), self.device)
        return (g / g_nom).to(torch.float32)

    # ------------------------------------------------------------ misc
    def describe(self) -> dict:
        """JSON-friendly campaign record."""
        return {"seed": self.seed,
                "restore_yield": (list(self.restore_yield)
                                  if self.restore_yield else None),
                "stuck_rate": self.stuck_rate,
                "variation": self.variation,
                "drift_rate": self.drift_rate,
                "adc_noise_sigma": self.adc_noise_sigma}


def _shape_tag(shape: tuple) -> str:
    return "x".join(map(str, shape))


# ---------------------------------------------------------- channel codes
# A code c in [0, 27) gives, for each true trit t, the trit it reads as:
# the read state's index (t_read + 1) is digit t + 1 of c in base 3.

_CODES: "collections.OrderedDict" = collections.OrderedDict()


def clear_code_cache() -> None:
    """Drop every cached channel code (frees their device memory)."""
    _CODES.clear()


def channel_code(model: FaultModel, shape: tuple, parts: tuple,
                 device) -> torch.Tensor:
    """The uint8 channel code of ``model.fault_trits`` for trits of
    ``shape`` on ``device``, made once and cached (least recently used
    out past ``CODE_CACHE_ENTRIES``)."""
    device = torch.device(device)
    cache_key = (model, shape, parts, str(device))
    code = _CODES.get(cache_key)
    if code is not None:
        _CODES.move_to_end(cache_key)
        return code
    code = make_channel_code(model, shape, parts, device)
    _CODES[cache_key] = code
    while len(_CODES) > CODE_CACHE_ENTRIES:
        _CODES.popitem(last=False)
    return code


def make_channel_code(model: FaultModel, shape: tuple, parts: tuple,
                      device) -> torch.Tensor:
    """Draw the channel code: ``inject_trit_errors`` with the
    ``restore`` key, then the ``stuck`` key's mask and random trits,
    evaluated for all three true trits at once, in flat pieces."""
    tag = (_shape_tag(shape),) + tuple(parts)
    n = math.prod(shape)
    code = torch.empty(n, dtype=torch.uint8, device=device)
    thresholds = (None if model.restore_yield is None
                  else read_thresholds(model.restore_yield))
    if model.stuck_rate > 0.0:
        km, kv = prng.split(model.key_for("stuck", *tag))
    for start in range(0, n, CODE_PIECE):
        blk = prng.flat_range(start, min(CODE_PIECE, n - start))
        if thresholds is None:
            reads = [torch.full((blk.cols,), a, dtype=torch.int8,
                                device=device) for a in range(3)]
        else:
            u = prng.uniform(model.key_for("restore", *tag), shape,
                             device=device, block=blk)
            reads = [read_index(u, cdf) for cdf in thresholds]
        if model.stuck_rate > 0.0:
            mask = prng.bernoulli(km, model.stuck_rate, shape, device, blk)
            stuck = (prng.randint(kv, shape, -1, 2, device, blk)
                     + 1).to(torch.int8)
            reads = [torch.where(mask, stuck, r) for r in reads]
        code[start:start + blk.cols] = (reads[0] + 3 * reads[1]
                                        + 9 * reads[2]).to(torch.uint8)
    return code.reshape(shape)


def apply_code(code: torch.Tensor, trits: torch.Tensor) -> torch.Tensor:
    """The trits a channel code reads ``trits`` as."""
    idx = torch.where(trits < 0, code % 3,
                      torch.where(trits == 0, (code // 3) % 3, code // 9))
    return idx.to(torch.int8) - 1


def measured_fault_model(n: int = 60, m: int = 4, num_mc: int = 4096,
                         seed: int = 0, variation: bool = False,
                         **channels) -> FaultModel:
    """FaultModel at the MEASURED TL restore yield: the Monte-Carlo yield
    model (Fig. 6) for the paper's cluster configuration, its per-state
    yields pinned as the restore-confusion channel.  Extra ``channels``
    keywords go to :class:`FaultModel` (``drift_rate=``, ...).

    ``variation`` is OFF by default here: in TL-nvSRAM the ternary MAC
    discharges through the SRAM array, and the yield model has already
    sampled the ReRAM resistances into the pinned yields; applying the
    lognormal channel to the MAC as well would count the variation twice
    (and model a ReRAM-CIM macro, not this paper's).  The Monte-Carlo
    runs on the CPU (3 x ``num_mc`` trials)."""
    from ..core.yield_model import tl_restore_yield
    key = prng.key(stable_seed("measured_fault_model", seed, n, m, num_mc))
    # on the host by design: a small Monte-Carlo whose yields are held
    # to the reference's (0.9412 / 0.99976 / 1.0 at the defaults), and a
    # pinned device keeps them the same wherever the campaign is built
    y = tl_restore_yield(key, n, m=m, num_mc=num_mc, device="cpu")
    per_state = tuple(float(v) for v in y["per_state"])
    return FaultModel(seed=seed, restore_yield=per_state,
                      variation=variation, **channels)

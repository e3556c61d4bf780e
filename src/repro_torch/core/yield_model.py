"""Monte-Carlo restore-yield model: the paper's Fig. 6 and the SL contrast.

Yield := P(the trit restored to the SRAM pair equals the trit stored in
the TL-ReRAM), under lognormal ReRAM resistance variation (filament gap
3 sigma / mu = 10 %), reference-ladder variation, CMOS discharge-path
mismatch, comparator offset, and leakage through the n - 1 unselected
insulating selectors (growing with cluster size n) plus m - 1 off
clusters.  Every draw comes from ``core.prng`` keys in the reference's
order (``jax.random.split`` / ``fold_in`` of the same key), so the trials
are the reference's up to the few-ulp difference of ``prng.normal``: a
trial flips only where a sampled margin lies within a few ulp of its
threshold.  The trials run on ``cuda`` unless the caller asks for
``device="cpu"``.
"""
from __future__ import annotations

import torch

from .. import resolve_device

from . import device_models as dm
from . import prng
from .cim import restore_levels_to_trits, store_trits_to_levels
from .seeding import stable_seed

STATE_TRITS = (-1, 0, 1)                      # HRS, MRS, LRS
# weights in NNs are sparse -> MRS-heavy prior (§3.4 "MRS tuned as
# preference")
SPARSE_PRIOR = (0.25, 0.50, 0.25)


def tl_restore_trials(key: prng.Key, n: int, m: int, num_mc: int,
                      d: dm.DeviceParams = dm.DeviceParams(),
                      device="cuda") -> torch.Tensor:
    """(3, num_mc) bool: per-state restore success for TL-nvSRAM-CIM."""
    device = resolve_device(device)
    shape = (3, num_mc)
    trits = torch.tensor(STATE_TRITS, dtype=torch.int8, device=device)
    levels = store_trits_to_levels(trits)[:, None]          # (3, 1)
    keys = prng.split(key, 5)
    r = dm.resistance_from_normals(
        levels.expand(shape), prng.normal(keys[0], shape, device), d)
    cmos = d.cmos_sigma_rel * prng.normal(keys[1], shape, device)
    g_cell = dm.discharge_conductance(r, d, cmos)
    # leakage: the unselected selectors' insulating resistance varies too
    z = prng.normal(keys[2], shape, device)
    g_leak = dm.leakage_conductance(n, m, d) * torch.exp(0.1 * z)
    g_ref = dm.reference_conductances_from_normals(
        [prng.normal(k, shape, device) for k in prng.split(keys[3], 3)], d)
    cmp1 = d.comparator_sigma_siemens * prng.normal(keys[4], shape, device)
    cmp2 = d.comparator_sigma_siemens * prng.normal(
        prng.fold_in(keys[4], 1), shape, device)
    # restore_levels_to_trits recomputes the series conductance from the
    # resistances; CMOS mismatch enters as an equivalent conductance
    # offset added to the leakage term
    g_eff_offset = g_cell - dm.discharge_conductance(r, d)
    got = restore_levels_to_trits(levels, resistances=r,
                                  g_leak=g_leak + g_eff_offset, g_ref=g_ref,
                                  cmp_noise=(cmp1, cmp2), device=d)
    return got == trits[:, None]


def _summary(ok: torch.Tensor, prior) -> dict:
    per_state = ok.to(torch.float32).mean(dim=1).cpu()
    return {"per_state": per_state,            # [HRS(-1), MRS(0), LRS(+1)]
            "weighted": float(torch.dot(
                torch.tensor(prior, dtype=torch.float32), per_state)),
            "min_state": float(per_state.min())}


def tl_restore_yield(key: prng.Key, n: int, m: int = 4, num_mc: int = 4096,
                     d: dm.DeviceParams = dm.DeviceParams(),
                     prior=SPARSE_PRIOR, device="cuda") -> dict:
    return _summary(tl_restore_trials(key, n, m, num_mc, d, device), prior)


def sl_restore_trials(key: prng.Key, n: int, num_mc: int,
                      d: dm.DeviceParams = dm.DeviceParams(),
                      device="cuda") -> torch.Tensor:
    """(2, num_mc) bool: HRS/LRS restore success for the voltage-divider
    select scheme of SL-nvSRAM-CIM [12].  The unselected SL-ReRAMs hold
    random binary data; their parallel resistance moves the divider
    output, squeezing the margin as n grows."""
    device = resolve_device(device)
    keys = prng.split(key, 4)
    un = max(n - 1, 1)
    states = torch.tensor([d.r_hrs, d.r_lrs], dtype=torch.float32,
                          device=device)
    r_sel = states[:, None] * torch.exp(
        d.sigma_ln_r * prng.normal(keys[0], (2, num_mc), device))
    bits = prng.bernoulli(keys[1], 0.5, (2, num_mc, un), device)
    r_un_nom = torch.where(bits, d.r_lrs, d.r_hrs).to(torch.float32)
    r_un = r_un_nom * torch.exp(
        d.sigma_ln_r * prng.normal(keys[2], (2, num_mc, un), device))
    vx = dm.sl_divider_voltage(r_sel, r_un, d.vdd)
    vth = dm.sl_nominal_threshold(n, d, d.vdd)  # trip fixed at n_design = 6
    vx = vx + 0.025 * prng.normal(keys[3], (2, num_mc), device)  # Vth sigma
    # V_X = V R_par / (R_sel + R_par): HRS gives a LOW V_X, LRS a HIGH one
    return torch.stack([vx[0] < vth, vx[1] > vth])


def sl_restore_yield(key: prng.Key, n: int, num_mc: int = 4096,
                     d: dm.DeviceParams = dm.DeviceParams(),
                     device="cuda") -> dict:
    ok = sl_restore_trials(key, n, num_mc, d, device)
    per_state = ok.to(torch.float32).mean(dim=1).cpu()
    return {"per_state": per_state, "weighted": float(per_state.mean()),
            "min_state": float(per_state.min())}


def yield_sweep(key: prng.Key, ns=(6, 12, 18, 30, 45, 60), m: int = 4,
                num_mc: int = 4096, scheme: str = "tl",
                device="cuda") -> dict:
    """Fig. 6(a): yield vs the number of ReRAMs per cluster / group.
    Per-point keys fold in ``stable_seed`` of the point's configuration,
    so a point's draw does not depend on which other points run."""
    out = {}
    for n in ns:
        k = prng.fold_in(key, stable_seed("yield_sweep", scheme, n, m,
                                          num_mc))
        out[n] = (tl_restore_yield(k, n, m, num_mc, device=device)
                  if scheme == "tl"
                  else sl_restore_yield(k, n, num_mc, device=device))
    return out


def cluster_sweep(key: prng.Key, ms=(1, 2, 3, 4), n: int = 60,
                  num_mc: int = 4096, device="cuda") -> dict:
    """Fig. 6(b): yield vs the number of clusters m (TL scheme), keyed
    like :func:`yield_sweep`."""
    return {m: tl_restore_yield(
        prng.fold_in(key, stable_seed("cluster_sweep", "tl", n, m, num_mc)),
        n, m, num_mc, device=device) for m in ms}

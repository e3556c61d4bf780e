"""Device models: TL-ReRAM, bidirectional selector, CMOS mismatch (§3.2/3.4).

Constants are the paper's (Table 2 footnote and §3.2): LRS 80 kOhm,
HRS 1 MOhm, MRS = argmax min(MRS/LRS, HRS/MRS) ~ 282 kOhm; selector
V_IMT 0.45 V, V_MIT 25 mV, R_metallic 40 kOhm, R_insulating 0.12 GOhm;
ReRAM filament-gap variation 3 sigma / mu = 10 %; V_DD 0.9 V, V_DDH
1.5 V, V_DDL 0.6 V, V_STR 0.31 V.

An analytic discharge-current model stands in for the paper's SPICE
Monte-Carlo: gap variation maps to log-resistance variation through the
exponential gap -> R law, so R is lognormal with
sigma_lnR = (3 sigma / mu of the gap / 3) * ln(HRS / LRS).  CMOS mismatch
enters as a Gaussian comparator or current offset.

The deterministic functions compute in f32 where they take tensors, as
the reference does; the ``sample_*`` functions draw from an explicit
``torch.Generator``.  The fault campaigns and the yield model draw their
standard normals from ``core.prng`` keys instead (bit for bit the
reference's ``jax.random`` draws) and pass them to the ``*_from_normals``
forms, which the ``sample_*`` functions share.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    r_lrs: float = 80e3
    r_hrs: float = 1e6
    r_mrs: Optional[float] = None       # None -> derived optimum (~282.8 kOhm)
    # selector (bidirectional, IMT/MIT)
    v_imt: float = 0.45
    v_mit: float = 0.025
    r_sel_metallic: float = 40e3
    r_sel_insulating: float = 0.12e9
    # access/discharge transistor on-resistance (28 nm core device)
    r_nmos: float = 10e3
    # variations
    gap_3sigma_over_mu: float = 0.10    # paper: 10 %
    cmos_sigma_rel: float = 0.03        # discharge-current mismatch (sigma/I)
    comparator_sigma_siemens: float = 0.10e-6  # latch input-referred offset
    # supplies
    vdd: float = 0.9
    vddh: float = 1.5
    vddl: float = 0.6
    vstr: float = 0.31

    @property
    def mrs(self) -> float:
        if self.r_mrs is not None:
            return self.r_mrs
        return optimal_mrs(self.r_lrs, self.r_hrs)

    @property
    def sigma_ln_r(self) -> float:
        return (self.gap_3sigma_over_mu / 3.0) * math.log(self.r_hrs
                                                          / self.r_lrs)


def optimal_mrs(r_lrs: float, r_hrs: float) -> float:
    """MRS maximizing min(MRS/LRS, HRS/MRS): the geometric mean (282 kOhm)."""
    return math.sqrt(r_lrs * r_hrs)


def level_resistance(level: torch.Tensor, d: DeviceParams) -> torch.Tensor:
    """ReRAM level (0 = HRS, 1 = MRS, 2 = LRS) -> nominal resistance, f32."""
    table = torch.tensor([d.r_hrs, d.mrs, d.r_lrs], dtype=torch.float32,
                         device=level.device)
    return table[level.long()]


def resistance_from_normals(level: torch.Tensor, z: torch.Tensor,
                            d: DeviceParams) -> torch.Tensor:
    """Lognormal resistance around the level's nominal value, given the
    standard normals ``z``."""
    return level_resistance(level, d) * torch.exp(d.sigma_ln_r * z)


def sample_resistance(level: torch.Tensor, generator: torch.Generator,
                      d: DeviceParams, shape=()) -> torch.Tensor:
    """Lognormal resistance sample around the level's nominal value."""
    z = torch.randn(tuple(shape) if shape else level.shape,
                    generator=generator, device=level.device)
    return resistance_from_normals(level, z, d)


def discharge_conductance(r_reram, d: DeviceParams, cmos_rel=0.0):
    """Conductance of the Q-node discharge path: the ReRAM in series with
    the metallic selector and the restore NMOS; CMOS mismatch scales the
    current."""
    g = 1.0 / (r_reram + d.r_sel_metallic + d.r_nmos)
    return g * (1.0 + cmos_rel)


def leakage_conductance(n: int, m: int, d: DeviceParams,
                        sel_off_leak: float = 2e-9) -> float:
    """Parasitic discharge through the (n-1) unselected insulating
    selectors of the active cluster plus the (m-1) off clusters' SEL
    transistors: the term that grows with cluster size n and bounds
    restore yield (Fig. 6), ~0.5 uS even at n = 60."""
    g_unsel = (n - 1) / d.r_sel_insulating
    g_off_clusters = (m - 1) * sel_off_leak
    return g_unsel + g_off_clusters


def _path_conductance(r: float, d: DeviceParams):
    return 1.0 / (r + d.r_sel_metallic + d.r_nmos)


def reference_conductances(d: DeviceParams) -> tuple[float, float, float]:
    """V_REF1/2/3 ladders (serially connected ReRAMs, §3.2) as discharge
    conductances: ref1 splits LRS|MRS, ref2 splits MRS|HRS, ref3 sits far
    above LRS so the Q1 = 0 branch always resolves Q2 = 0."""
    r1 = math.sqrt(d.r_lrs * d.mrs)
    r2 = math.sqrt(d.mrs * d.r_hrs)
    r3 = 8.0 * d.r_lrs
    return (_path_conductance(r1, d), _path_conductance(r2, d),
            _path_conductance(r3, d))


def reference_conductances_from_normals(zs, d: DeviceParams) -> tuple:
    """The reference ladders are built from ReRAMs too, so they vary; two
    series devices halve the variance of ln R (sigma / sqrt 2).  ``zs``
    are the three ladders' standard normals."""
    sig = d.sigma_ln_r / math.sqrt(2.0)
    nominals = (math.sqrt(d.r_lrs * d.mrs), math.sqrt(d.mrs * d.r_hrs),
                8.0 * d.r_lrs)
    return tuple(_path_conductance(nominal * torch.exp(sig * z), d)
                 for nominal, z in zip(nominals, zs))


def sample_reference_conductances(generator: torch.Generator,
                                  d: DeviceParams, shape=()):
    """:func:`reference_conductances_from_normals` with the normals drawn
    from `generator`; the samples lie on its device."""
    zs = [torch.randn(tuple(shape), generator=generator,
                      device=generator.device) for _ in range(3)]
    return reference_conductances_from_normals(zs, d)


# ---------------- SL-nvSRAM-CIM voltage-divider select scheme [12] -------

def sl_divider_voltage(r_selected: torch.Tensor, r_unselected: torch.Tensor,
                       v: float = 0.9) -> torch.Tensor:
    """Voltage-divider readout of the previous SL-nvSRAM-CIM: the selected
    SL-ReRAM in series with the parallel combination of the (n-1)
    unselected ones, V_X = V * R_par / (R_sel + R_par); r_unselected has
    shape (..., n-1)."""
    r_par = 1.0 / torch.sum(1.0 / r_unselected, dim=-1)
    return v * r_par / (r_selected + r_par)


def sl_nominal_threshold(n: int, d: DeviceParams, v: float = 0.9,
                         n_design: int = 6) -> float:
    """Fixed SRAM trip voltage of the SL voltage-divider scheme [12]: the
    midpoint of the nominal HRS/LRS divider outputs at `n_design` (6
    SL-ReRAMs per group, [12]'s silicon) with a balanced unselected
    population.  As n grows past the design point, V_X(LRS) slides below
    this trip voltage and restore collapses (§2.2)."""
    nd = n_design
    half = max(1, (nd - 1) // 2)
    g_par = half / d.r_lrs + max(0, nd - 1 - half) / d.r_hrs
    r_par = 1.0 / g_par
    v_h = v * r_par / (d.r_hrs + r_par)
    v_l = v * r_par / (d.r_lrs + r_par)
    return (v_h + v_l) / 2.0

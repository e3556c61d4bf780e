"""Architecture-level energy / throughput / area model (Tables 4-5, Figs 9/11).

All per-op constants are the paper's Table 5; the few values the paper
does not publish are calibrated once and documented:

* ``E_COL_RERAM_CIM`` — ReRAM-CIM column-cycle energy.  The paper reports
  only the end ratio (TL = 2.0x baseline-3).  0.30 pJ/col-cycle (≈2.7x
  the SRAM column energy — consistent with the larger cell currents of
  current-domain ReRAM readout) reproduces that ratio.
* ``PERIPHERY_AREA_UM2`` — per-subarray periphery (ADCs, drivers, S&A).
  194,000 µm² simultaneously reproduces Fig. 11(a)'s 7.2x array-density
  gain and Fig. 11(b)'s 89.1% area saving.

Cycle/throughput model (validated against three separate paper claims):
a b-bit x b-bit MAC decomposes into b*b single-bit (or t*t single-trit)
partial products; each ADC sense accumulates `rows_active` partials for
one CBL; per cycle, #ADCs CBLs are sensed.  Peak MACs/cycle =
ADCs * rows_active / width^2  ->  BC: 32*32/64 = 16, TC: 32*16/25 = 20.48
(1.28x ~ the paper's 1.3x), and a 250-column TC array: 25*16/25 = 16
(parity with 21.9% fewer ADCs — §4.3).
The reference's model (``repro.core.energy``) line for line, over this
package's ``MacroConfig`` and ``mapping``: pure host Python, no kernel;
the constants and calibrations are the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .cim import MacroConfig
from .mapping import LayerSpec, MappingPlan, compact_map, subarrays_needed

PJ = 1e-12
FJ = 1e-15


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    # Table 5
    e_col_sram_cim: float = 0.11 * PJ        # per column-cycle, 32 rows (BC)
    e_cbl_tl_cim: float = 0.096 * PJ         # per CBL-cycle, 16 rows (TC)
    e_restore_tl_array: float = 75.2 * PJ    # per array restore cycle
    e_ternary_encoder: float = 13.1 * FJ     # per 8b->5t conversion
    e_adc: float = 0.188 * PJ                # per 5-bit conversion
    e_shift_add: float = 0.336 * PJ / 5      # per CBL/col-cycle (0.336 pJ/5col)
    e_buffer_bit: float = 0.042 * PJ
    e_dram_bit: float = 4.2 * PJ
    e_reram_read_bit: float = 1.63 * PJ
    # Table 4 (cell level, layout-extracted)
    e_store_sl_cell: float = 360 * FJ
    e_store_tl_cell: float = 69.2 * FJ
    e_restore_sl_bit: float = 15.6 * FJ
    e_restore_tl_trit: float = 8.57 * FJ
    area_6t_um2: float = 0.75
    area_sl_cell_um2: float = 2.33
    area_tl_cell_um2: float = 6.35
    # calibrated (see module docstring)
    e_col_reram_cim: float = 0.30 * PJ
    periphery_area_um2: float = 194_000.0


C = EnergyConstants()

# ---------------------------------------------------------------- throughput

def macs_per_cycle(adcs: int, rows_active: int, width: int) -> float:
    """Peak full-precision MACs per cycle for a width-bit/trit coded array."""
    return adcs * rows_active / (width * width)


def peak_throughput_ratio(cfg: MacroConfig = MacroConfig()) -> float:
    """Fig. 9(a): TC(5t, 16 rows) vs BC(8b, 32 rows), 32 ADCs each."""
    tc = macs_per_cycle(cfg.adcs, cfg.rows_active, cfg.num_trits)
    bc = macs_per_cycle(32, 32, 8)
    return tc / bc


# ------------------------------------------------------------- cell metrics

def cell_metrics(cfg: MacroConfig = MacroConfig(), c: EnergyConstants = C) -> dict:
    """Reproduces Table 4 (density & CIM efficiency are derived, not copied)."""
    trits = cfg.trits_per_cell                       # 240
    bits_equiv = trits * 8 / 5                       # paper counts 384 "bits"
    sl_bits = 18
    tl = dict(
        data_per_cell_trits=trits,
        data_per_cell_bits=bits_equiv,
        store_energy=c.e_store_tl_cell,
        restore_energy=c.e_restore_tl_trit,
        # ops/fJ: 16 rows x 2 ops, x (64/25) effective-precision factor
        cim_efficiency_op_per_fj=(cfg.rows_active * 2 * (64 / 25))
        / (c.e_cbl_tl_cim / FJ),
        area_um2=c.area_tl_cell_um2,
        density_bits_um2=bits_equiv / c.area_tl_cell_um2,
    )
    sl = dict(
        data_per_cell_bits=sl_bits,
        store_energy=c.e_store_sl_cell,
        restore_energy=c.e_restore_sl_bit,
        cim_efficiency_op_per_fj=(32 * 2) / (c.e_col_sram_cim / FJ),
        area_um2=c.area_sl_cell_um2,
        density_bits_um2=sl_bits / c.area_sl_cell_um2,
    )
    return {"tl": tl, "sl": sl,
            "density_gain": tl["density_bits_um2"] / sl["density_bits_um2"]}


# ------------------------------------------------------ capacity & area

def array_capacity_bits(scheme: str, cfg: MacroConfig = MacroConfig()) -> float:
    """On-chip weight capacity of ONE subarray, in equivalent bits."""
    if scheme == "tl":
        trits = cfg.rows * cfg.trit_cols * cfg.trits_per_cell
        return trits * 8 / 5
    if scheme == "sl":            # [DAC'22]: 18 SL-ReRAMs per cell
        return 256 * 256 * 18
    if scheme == "sl_sel":        # SL + DC-free selectors: 3 groups x 18
        return 256 * 256 * 54
    if scheme in ("sram_dram", "sram_reram", "reram_cim"):
        return 256 * 256          # SRAM-resident bits only
    raise ValueError(scheme)


def array_area_um2(scheme: str, cfg: MacroConfig = MacroConfig(),
                   c: EnergyConstants = C) -> float:
    cell = {"tl": c.area_tl_cell_um2}.get(scheme, c.area_sl_cell_um2)
    cells = cfg.rows * cfg.trit_cols if scheme == "tl" else 256 * 256
    if scheme in ("sram_dram", "sram_reram", "reram_cim"):
        cell = c.area_6t_um2
    return cells * cell + c.periphery_area_um2


def arrays_to_fit(model_bytes: float, scheme: str, cfg: MacroConfig = MacroConfig()) -> int:
    return math.ceil(model_bytes * 8 / array_capacity_bits(scheme, cfg))


# ------------------------------------------------------- inference energy

@dataclasses.dataclass
class EnergyBreakdown:
    cim_array: float = 0.0
    adc: float = 0.0
    shift_add: float = 0.0
    encoder: float = 0.0
    buffer: float = 0.0
    weight_supply: float = 0.0   # DRAM / ReRAM-read / restore
    total: float = 0.0

    def finish(self):
        self.total = (self.cim_array + self.adc + self.shift_add +
                      self.encoder + self.buffer + self.weight_supply)
        return self


def inference_energy(layers: Sequence[LayerSpec], scheme: str,
                     cfg: MacroConfig = MacroConfig(), c: EnergyConstants = C,
                     num_arrays: int | None = None,
                     in_bits: int = 8, w_bits: int = 8) -> EnergyBreakdown:
    """Per-inference energy of the five evaluated schemes (§4.1).

    scheme: 'tl' | 'sl' (baseline-4) | 'sram_dram' (b1) | 'sram_reram' (b2)
            | 'reram_cim' (b3).
    `num_arrays` caps on-chip capacity (None = enough to fit: the paper's
    default for b2/b3/b4; b1's SRAM never fits a whole model)."""
    e = EnergyBreakdown()
    total_macs = sum(l.macs() for l in layers)
    model_bits = sum(l.params() for l in layers) * w_bits
    total_in_elems = sum(l.rows * l.spatial for l in layers)
    total_out_elems = sum(l.cout * l.spatial for l in layers)

    if scheme == "tl":
        q = cfg.num_trits
        partials = total_macs * q * q
        cbl_cycles = partials / cfg.rows_active
        e.cim_array = cbl_cycles * c.e_cbl_tl_cim
        e.adc = cbl_cycles * c.e_adc
        e.shift_add = cbl_cycles * c.e_shift_add
        e.encoder = total_in_elems * c.e_ternary_encoder
        e.buffer = (total_in_elems + total_out_elems) * 8 * c.e_buffer_bit
        n_arr = num_arrays or subarrays_needed(layers, cfg)
        fit_bits = n_arr * array_capacity_bits("tl", cfg)
        # the first-fit planner is exact for CNN-scale models; LLM-scale
        # models have millions of blocks, where the analytic depth count
        # (ceil(total trits / trits-per-depth-level)) is equivalent for
        # the energy term and O(1)
        n_blocks = sum(
            math.ceil(l.rows / cfg.rows_active)
            * math.ceil(l.cols(cfg.num_trits) / cfg.sram_cols)
            for l in layers)
        if n_blocks <= 50_000:
            restore_cycles = compact_map(layers, cfg, n_arr).restore_cycles
        else:
            total_trits = sum(l.params() for l in layers) * cfg.num_trits
            per_depth = n_arr * cfg.rows * cfg.trit_cols
            restore_cycles = math.ceil(total_trits / per_depth)
        e.weight_supply = n_arr * c.e_restore_tl_array * max(1, restore_cycles)
        overflow_bits = max(0.0, model_bits * 5 / 8 - fit_bits)  # trit bits
        e.weight_supply += overflow_bits * c.e_dram_bit
        return e.finish()

    # binary-coded schemes share the BC cycle structure
    partials = total_macs * in_bits * w_bits
    col_cycles = partials / 32
    e_col = c.e_col_reram_cim if scheme == "reram_cim" else c.e_col_sram_cim
    e.cim_array = col_cycles * e_col
    e.adc = col_cycles * c.e_adc
    e.shift_add = col_cycles * c.e_shift_add
    e.buffer = (total_in_elems + total_out_elems) * 8 * c.e_buffer_bit

    # weights a streaming baseline actually touches: spatial < 1 marks
    # conditionally-activated (MoE expert) layers — DRAM/ReRAM baselines
    # fetch only the routed fraction, CIM schemes store everything
    touched_bits = sum(l.params() * min(l.spatial, 1.0)
                       for l in layers) * w_bits
    if scheme == "sram_dram":        # baseline-1: stream weights from DRAM
        e.weight_supply = touched_bits * c.e_dram_bit
    elif scheme == "sram_reram":     # baseline-2: on-chip ReRAM -> SRAM each pass
        e.weight_supply = touched_bits * c.e_reram_read_bit
    elif scheme == "reram_cim":      # baseline-3: in-situ, no movement
        e.weight_supply = 0.0
    elif scheme == "sl":             # baseline-4: restore from SL-ReRAMs
        n_arr = num_arrays or arrays_to_fit(model_bits / 8, "sl", cfg)
        fit_bits = n_arr * array_capacity_bits("sl", cfg)
        restored = min(model_bits, fit_bits)
        e.weight_supply = restored * c.e_restore_sl_bit
        overflow = max(0.0, model_bits - fit_bits)
        e.weight_supply += overflow * c.e_dram_bit
    else:
        raise ValueError(scheme)
    return e.finish()


def efficiency_ratios(layers: Sequence[LayerSpec],
                      cfg: MacroConfig = MacroConfig(), c: EnergyConstants = C,
                      same_area_sl: bool = False) -> dict:
    """Fig. 9(b) / Fig. 11(b): TL energy-efficiency gains vs each baseline."""
    tl = inference_energy(layers, "tl", cfg, c).total
    out = {}
    for s in ("sram_dram", "sram_reram", "reram_cim", "sl"):
        kw = {}
        if s == "sl" and same_area_sl:
            # SL constrained to TL's area -> limited capacity -> DRAM refills
            tl_area = array_area_um2("tl", cfg, c) * subarrays_needed(layers, cfg)
            kw["num_arrays"] = max(1, int(tl_area // array_area_um2("sl", cfg, c)))
        out[s] = inference_energy(layers, s, cfg, c, **kw).total / tl
    return out


def area_and_ee_per_area(layers: Sequence[LayerSpec],
                         cfg: MacroConfig = MacroConfig(), c: EnergyConstants = C) -> dict:
    """Fig. 11(b): whole-model area and energy-efficiency-per-area."""
    model_bytes = sum(l.params() for l in layers)  # 8b weights
    n_tl = subarrays_needed(layers, cfg)
    n_sl = arrays_to_fit(model_bytes, "sl", cfg)
    a_tl = n_tl * array_area_um2("tl", cfg, c)
    a_sl = n_sl * array_area_um2("sl", cfg, c)
    e_tl = inference_energy(layers, "tl", cfg, c).total
    e_sl = inference_energy(layers, "sl", cfg, c, num_arrays=n_sl).total
    ee_per_area = (1 / e_tl / a_tl) / (1 / e_sl / a_sl)
    # same-area scenario: SL capped to TL's footprint
    n_sl_same = max(1, int(a_tl // array_area_um2("sl", cfg, c)))
    e_sl_same = inference_energy(layers, "sl", cfg, c, num_arrays=n_sl_same).total
    ee_per_area_same = (1 / e_tl / a_tl) / (1 / e_sl_same / (n_sl_same * array_area_um2("sl", cfg, c)))
    return {
        "tl_arrays": n_tl, "sl_arrays": n_sl,
        "tl_area_mm2": a_tl / 1e6, "sl_area_mm2": a_sl / 1e6,
        "area_saved": 1 - a_tl / a_sl,
        "ee_per_area_gain": ee_per_area,
        "ee_per_area_gain_same_area": ee_per_area_same,
    }

"""Bit-exact functional model of the TL-nvSRAM-CIM macro (Figs. 3-5, §3).

The macro computes y = x @ w with ternary-coded operands:

* weights: q_w balanced trits, each restored into a PAIR of 6T SRAM cells
  (Q1Q2 per Table 1);
* inputs: q_i balanced trits driven serially (IN1/IN2 per Table 1), one
  trit per CIM cycle;
* 16 rows are active at a time; each row adds 1 - x*w discharge paths to
  the shared CBL (2 paths for the product -1, 1 for 0, 0 for +1), so the
  CBL *count* of a 16-row group lies in [0, 32] and is sensed by a 5-bit
  ADC: of the 33 counts only the extreme 32 saturates, at 31.  That is
  the macro's only intrinsic nonideality, and it is modelled;
* a shift-and-add combines trit positions with powers of 3 and row
  groups by plain summation.

With ``adc_bits`` large enough the model reduces exactly to the integer
matmul of the quantized operands.

:func:`cim_matmul_int` is the oracle of the ``cim_mac`` kernel
(``kernels/cim_mac.py``).  ADC noise draws from an explicit
``torch.Generator``; with ``adc_noise_sigma=0`` every function here is
bitwise equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .ternary import (TernaryTensor, encode_inputs, signals_to_weight_trit,
                      ternarize, weight_signals)

# Elements of one f32 block of group MACs (and of one f32 weight chunk)
# in cim_matmul_int: the model's (qi, qw, B, G, N) temporaries would take
# ~107 GB for internlm2-1.8b's w1 at B = 1024; chunks of N keep them at
# 256 MB.
CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class MacroConfig:
    """TL-nvSRAM-CIM macro parameters (defaults: the paper's 256x320 array)."""
    rows: int = 256                # SRAM rows per subarray
    sram_cols: int = 320           # SRAM columns (2 per trit column)
    rows_active: int = 16          # rows accumulated per CBL sense
    adc_bits: int = 5              # ADC resolution (counts domain)
    cbls_per_adc: int = 5          # ADC sharing (mux ratio)
    num_trits: int = 5             # trits per weight / input
    clusters_per_cell: int = 4     # m
    rerams_per_cluster: int = 60   # n
    num_subarrays: int = 6

    @property
    def trit_cols(self) -> int:           # weight-trit columns (= CBLs)
        return self.sram_cols // 2

    @property
    def weights_per_row(self) -> int:
        return self.trit_cols // self.num_trits

    @property
    def adcs(self) -> int:
        return self.trit_cols // self.cbls_per_adc

    @property
    def trits_per_cell(self) -> int:      # ReRAM capacity behind one trit
        return self.clusters_per_cell * self.rerams_per_cluster

    @property
    def subarray_weight_capacity_trits(self) -> int:
        return self.rows * self.trit_cols * self.trits_per_cell

    def row_groups(self, k: int) -> int:
        return -(-k // self.rows_active)


def adc_transfer(count: torch.Tensor, adc_bits: int,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CBL count -> ADC code.  Counts live in [0, 2 * rows_active]; a
    b-bit ADC has 2**b codes.  Optional additive noise (in LSB) models
    readout noise."""
    x = count.to(torch.float32)
    if noise is not None:
        x = x + noise
    code = torch.clamp(torch.round(x), 0, 2**adc_bits - 1)
    return code.to(torch.int32)


def cim_matmul_int(x_trits: torch.Tensor, w_trits: torch.Tensor,
                   cfg: MacroConfig, adc_noise_sigma: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Integer CIM matmul over trit planes: x_trits (q_i, B, K) int8,
    w_trits (q_w, K, N) int8 -> (B, N) int32, equal (up to ADC saturation
    and noise) to sum_ij 3^(i+j) (x_i @ w_j).

    K is cut into groups of ``rows_active`` rows; a last partial group of
    r rows has its missing rows deactivated, so its count is r - mac.
    Per plane pair and chunk of N, every group's MAC is one f32 product
    (exact: |mac| <= rows_active), turned into the count r - mac and
    through :func:`adc_transfer`'s steps in place (+ noise, round, clip
    to the ADC's codes); sum_g (r_g - code_g) = K - sum_g code_g then
    takes the shift-and-add in int32.
    """
    qi, b, k = x_trits.shape
    qw, k2, n = w_trits.shape
    if k != k2:
        raise ValueError(f"x has K={k} rows of trits, w has {k2}")
    if adc_noise_sigma > 0.0 and generator is None:
        raise ValueError("ADC noise needs a torch.Generator")
    dev = x_trits.device
    ra = cfg.rows_active
    g = cfg.row_groups(k)
    pad = g * ra - k
    xg = torch.nn.functional.pad(x_trits, (0, pad)).reshape(
        qi, b, g, ra).permute(0, 2, 1, 3).contiguous().to(
        torch.float32)                                         # (qi, G, B, ra)
    wg = torch.nn.functional.pad(w_trits, (0, 0, 0, pad)).reshape(
        qw, g, ra, n)                                          # (qw, G, ra, N)
    rows_real = torch.clamp(k - torch.arange(g, device=dev) * ra, 0, ra)
    rows_real = rows_real.to(torch.float32)[:, None, None]
    cmax = 2**cfg.adc_bits - 1
    nc = max(1, min(n, CHUNK_ELEMENTS // max(1, g * b),
                    CHUNK_ELEMENTS // max(1, qw * g * ra)))
    out = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for n0 in range(0, n, nc):
        wc = wg[..., n0:n0 + nc].to(torch.float32)
        acc = out[:, n0:n0 + nc]
        for i in range(qi):
            for j in range(qw):
                count = torch.bmm(xg[i], wc[j])            # (G, B, nc) macs
                torch.sub(rows_real, count, out=count)     # count = r - mac
                if adc_noise_sigma > 0.0:
                    count.add_(adc_noise_sigma * torch.randn(
                        count.shape, generator=generator, device=dev))
                    count.round_()
                count.clamp_(0, cmax)                      # ADC code
                # integer-valued f32 sums are exact below 2^24
                codes = (count.sum(dim=0) if cmax * g < 2**24
                         else count.double().sum(dim=0))
                acc += 3**(i + j) * (k - codes.to(torch.int32))
    return out


def cim_matmul(x: torch.Tensor, w: Optional[torch.Tensor],
               cfg: MacroConfig = MacroConfig(), method: str = "truncate",
               adc_noise_sigma: float = 0.0,
               generator: Optional[torch.Generator] = None,
               w_ternary: Optional[TernaryTensor] = None) -> torch.Tensor:
    """Float in, float out: quantize -> trit MAC -> rescale.  x (B, K)
    float; w (K, N) float, or pre-ternarized as ``w_ternary``."""
    xt = encode_inputs(x, cfg.num_trits)
    wt = (w_ternary if w_ternary is not None
          else ternarize(w, cfg.num_trits, method=method))
    y_int = cim_matmul_int(xt.trits, wt.trits, cfg, adc_noise_sigma,
                           generator)
    return y_int.to(torch.float32) * xt.scale * wt.scale


# ----------------------------------------------------------------------
# Store / restore state machine (Table 2, Figs. 4-5): behavioural model.
# ----------------------------------------------------------------------

# Signal settings of Table 2, kept as data so tests can assert the modes.
VDD, VDDH, VDDL, VSTR = 0.9, 1.5, 0.6, 0.31
SIGNAL_TABLE = {
    ("store", 1):   dict(SEL_i=VDDH, SL_j=0.0, SL_x=VDDL, RSTR=0.0, STR1=0.0,
                         STR2=0.0, CBL=VDDH),
    ("store", 2):   dict(SEL_i=VDDH, SL_j=VDDH, SL_x=VDDL, RSTR=0.0,
                         STR1=VDD, STR2=VSTR, CBL=None),
    ("restore", 1): dict(SEL_i=0.0, SL_j=VDDL, SL_x=VDDL, RSTR=0.0, STR1=0.0,
                         STR2=0.0, CBL=None),
    ("restore", 2): dict(SEL_i=VDD, SL_j=0.0, SL_x=VDDL, RSTR=VDD, STR1=0.0,
                         STR2=0.0, CBL=None),
    ("cim", 0):     dict(SEL_i=0.0, SL_j=VDDL, SL_x=VDDL, RSTR=0.0,
                         STR1="INB2", STR2="INB1", CBL="MAC"),
}

# ReRAM levels
HRS, MRS, LRS = 0, 1, 2
TRIT_TO_LEVEL = {-1: HRS, 0: MRS, 1: LRS}
LEVEL_TO_TRIT = {HRS: -1, MRS: 0, LRS: 1}


def store_trits_to_levels(trits: torch.Tensor) -> torch.Tensor:
    """Store mode: SRAM pair (Q1, Q2) -> conditional set current -> level.
    Phase 1 resets the selected ReRAM to HRS; phase 2 produces the set
    current I00 (-> LRS) for Q1Q2 = 00, I10 (-> MRS) for 10, none (stay
    HRS) for 11."""
    q1, q2 = weight_signals(trits)
    level = torch.where((q1 == 0) & (q2 == 0), LRS,
                        torch.where((q1 == 1) & (q2 == 0), MRS, HRS))
    return level.to(torch.int8)


def restore_levels_to_trits(levels: torch.Tensor,
                            resistances: Optional[torch.Tensor] = None,
                            g_leak=0.0, g_ref: Optional[tuple] = None,
                            cmp_noise: Optional[tuple] = None,
                            device=None) -> torch.Tensor:
    """Restore mode: ReRAM level (+ sampled resistance) -> (Q1, Q2) -> trit.

    With no variation arguments this is the ideal restore (the exact
    inverse of store).  With `resistances` (ohms, the shape of levels)
    and leak / reference conductances it runs the differential-discharge
    comparison of §3.4 and may make errors, which is what the yield
    model measures.  ``device`` is a ``device_models.DeviceParams`` (the
    reference's name for it).
    """
    if resistances is None:
        q1 = levels != LRS
        q2 = levels == HRS
        return signals_to_weight_trit(q1.to(torch.int8), q2.to(torch.int8))
    from . import device_models as dm
    d = device or dm.DeviceParams()
    g_cell = dm.discharge_conductance(resistances, d) + g_leak
    if g_ref is None:
        g_ref = dm.reference_conductances(d)
    g_ref1, g_ref2, g_ref3 = g_ref
    n1 = n2 = 0.0
    if cmp_noise is not None:
        n1, n2 = cmp_noise
    q1 = g_cell + n1 < g_ref1                      # R above ref1 -> Q1 = 1
    q2_hi = g_cell + n2 < g_ref2                   # Q1 = 1 branch (VREF2)
    q2_lo = g_cell + n2 < g_ref3                   # Q1 = 0 branch (VREF3)
    q2 = torch.where(q1, q2_hi, q2_lo)
    return signals_to_weight_trit(q1.to(torch.int8), q2.to(torch.int8))


def roundtrip_store_restore(trits: torch.Tensor, **restore_kw
                            ) -> torch.Tensor:
    """store -> (ideal or varied) restore; the identity when ideal."""
    return restore_levels_to_trits(store_trits_to_levels(trits), **restore_kw)

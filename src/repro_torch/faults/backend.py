"""The ``device``-fidelity execution backend: ternary MACs through the
analog signal chain.

Where the exact backends compute ``x @ dequant(w)``, this backend runs a
plan as the TL-nvSRAM-CIM macro would: per 16-row group, each cell adds
``1 - x*w`` discharge paths to the shared CBL, weighted by its sampled
conductance (the active :class:`~.model.FaultModel`'s lognormal
resistance variation and CMOS mismatch), and the group count goes
through ``core.cim.adc_transfer`` (round, clip to the b-bit code space)
before the digital shift-and-add rebuilds the MAC assuming NOMINAL rows:
there conductance error and ADC saturation become output error.  The
weight trits first pass the model's restore-confusion and stuck-at
channels.

The reference's device MAC is XLA, not Pallas, so this is plain torch on
either device.  It is integer-exact up to the final scale when
``variation`` is off (every count is an integer-valued f32 sum of at
most 16 unit terms, the shift-and-add an int64 sum), so it is bitwise the
same on the CPU and the card and, given the same draws, the reference's.
With ``variation`` the counts are f32 sums whose order differs between
torch and XLA, so a count within an ulp of a rounding boundary may land
on the other code.  The (qi, qw, B, G, N) count tensor is made one
weight plane and one column piece at a time (at most ``COUNT_PIECE``
elements), so the packed unembedding of internlm2-1.8b at B = 8 needs
256 MB of counts and not 9.5 GB.

Registered through ``register_backend`` with ``fidelities={'device'}``
only: it never shadows an exact request, and no exact backend serves a
device plan.  The active fault model is module state
(:func:`set_fault_model`); swapping campaigns does not change plan
resolution.  Whether a call's rows are separate calls
(``kernels.plan.rows_as_calls``, public here as well) follows from how
the caller batches, not from the plan.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import prng
from ..core.cim import MacroConfig, adc_transfer
from ..core.ternary import encode_inputs
from ..kernels import plan as _plan
from ..kernels.ops import PackedTernary
from ..kernels.plan import rows_as_calls  # noqa: F401  (public here too)
from .model import FaultModel
from .scrub import packed_to_trits

DEVICE_BACKEND = "device"
ROWS_ACTIVE = MacroConfig().rows_active      # 16 rows per CBL sense
COUNT_PIECE = 1 << 26                        # count elements per piece

_ACTIVE_MODEL = FaultModel()


def get_fault_model() -> FaultModel:
    """The fault campaign the device backend currently runs under."""
    return _ACTIVE_MODEL


def set_fault_model(model: FaultModel) -> FaultModel:
    """Swap the active campaign (returns the previous one).  Plans are
    unaffected: fidelity routing is capability-level."""
    global _ACTIVE_MODEL
    if not isinstance(model, FaultModel):
        raise TypeError(f"expected a FaultModel, got {type(model).__name__}")
    prev, _ACTIVE_MODEL = _ACTIVE_MODEL, model
    return prev


def weight_trit_planes(w: PackedTernary, num_trits: int = 5
                       ) -> torch.Tensor:
    """Packed weights -> (q, ..., K, N) int8 trit planes (q = 1 for
    trit2, ``num_trits`` for base3)."""
    return packed_to_trits(w, num_trits)


def device_ternary_mac(x: torch.Tensor, w_trits: torch.Tensor,
                       w_scale: torch.Tensor, model: FaultModel,
                       num_trits: int = 5, adc_bits: int = 5,
                       with_stats: bool = False, per_row: bool = False):
    """Analog ternary MAC: faulted trits, conductance-weighted discharge
    counts, ADC quantization, nominal digital reconstruction.

    x: (..., K) float; w_trits: (q, K, N) int8; w_scale: (N,) float.
    Returns y (..., N) f32, or (y, clip_lo, clip_hi) with int32 scalars
    counting the pre-clip ADC codes outside [0, 2^bits - 1] when
    ``with_stats``.  The inputs share one quantization scale and the ADC
    noise is one draw over the (qi, qw, B, G, N) counts, unless
    ``per_row``: then every row of x is its own call (its own scale, and
    the noise of a one-row call, the same for every row), bitwise as
    calling once per row."""
    if w_trits.dim() != 3:
        raise ValueError(
            f"device backend runs per-layer (q, K, N) weights; got trit "
            f"planes of shape {tuple(w_trits.shape)} (slice the stack)")
    qw, k, n = w_trits.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K={x.shape[-1]}, the weight planes "
                         f"{k}")
    lead = x.shape[:-1]
    dev = x.device
    xt = encode_inputs(x.reshape(-1, k).to(torch.float32), num_trits,
                       axis=-1 if per_row else None)
    ft = model.fault_trits(w_trits, "w")                # (qw, K, N)
    gmul = (model.conductance_multiplier(ft, "g") if model.variation
            else None)                                  # None: all ones
    qi, b, _ = xt.trits.shape
    ra = ROWS_ACTIVE
    g = -(-k // ra)
    pad = g * ra - k
    rows = (0, 0, 0, pad)
    # (G, qi * B, ra): each group's input trits, every plane and row
    xg = torch.nn.functional.pad(xt.trits, (0, pad)).reshape(
        qi * b, g, ra).transpose(0, 1).to(torch.float32)
    rows_real = torch.clamp(k - torch.arange(g, device=dev) * ra, 0,
                            ra).to(torch.int32)
    act = (torch.arange(g * ra, device=dev).reshape(g, ra) < k
           ).to(torch.float32)
    cmax = 2**adc_bits - 1
    sigma = model.adc_noise_sigma
    if sigma > 0.0:
        nb = 1 if per_row else b          # rows of one call's draw
        noise_key = model.key_for("adc", nb, k, n)
        count_shape = (qi, qw, nb, g, n)
    y_int = torch.zeros((b, n), dtype=torch.int64, device=dev)
    clip_lo = torch.zeros((), dtype=torch.int64, device=dev)
    clip_hi = torch.zeros((), dtype=torch.int64, device=dev)
    piece = max(1, COUNT_PIECE // (g * qi * b))
    for j in range(qw):
        wj = ft[j].to(torch.float32)
        if gmul is None:
            base = rows_real.to(torch.float32)[:, None]          # (G, 1)
        else:
            gg = torch.nn.functional.pad(gmul[j], rows).reshape(g, ra, n)
            base = (act[:, :, None] * gg).sum(dim=1)             # (G, N)
            wj = wj * gmul[j]
        wg = torch.nn.functional.pad(wj, rows).reshape(g, ra, n)
        for n0 in range(0, n, piece):
            n1 = min(n, n0 + piece)
            mac = torch.bmm(xg, wg[:, :, n0:n1])          # (G, qi*B, nc)
            count = (base if gmul is None else base[:, n0:n1])[:, None] \
                - mac
            noise = None
            if sigma > 0.0:
                noise = torch.stack([prng.normal(
                    noise_key, count_shape, dev, prng.Block(
                        (i * qw + j) * nb * g * n + n0, nb * g, n, n1 - n0))
                    .reshape(nb, g, n1 - n0) for i in range(qi)])
                noise = sigma * noise.expand(qi, b, g, n1 - n0).reshape(
                    qi * b, g, n1 - n0).transpose(0, 1)
            code = adc_transfer(count, adc_bits, noise)
            if with_stats:
                pre = torch.round(count if noise is None else count + noise)
                clip_lo += (pre < 0).sum()
                clip_hi += (pre > cmax).sum()
            # digital reconstruction assumes the NOMINAL count offset
            mac_q = (rows_real[:, None, None] - code).sum(
                dim=0, dtype=torch.int64).reshape(qi, b, n1 - n0)
            for i in range(qi):
                y_int[:, n0:n1] += 3**(i + j) * mac_q[i]
    y = (y_int.to(torch.int32).to(torch.float32) * xt.scale
         * w_scale.to(torch.float32)).reshape(*lead, n)
    if not with_stats:
        return y
    return y, clip_lo.to(torch.int32), clip_hi.to(torch.int32)


def _run_device(plan, x, w):
    if not isinstance(w, PackedTernary):
        raise ValueError("device backend needs PackedTernary weights; "
                         f"got {type(w).__name__}")
    num_trits = plan.num_trits or 5
    planes = weight_trit_planes(w, num_trits)
    return device_ternary_mac(x, planes, w.scale, get_fault_model(),
                              num_trits=num_trits,
                              adc_bits=plan.adc_bits or 5,
                              per_row=_plan.rows_are_calls())


def register_device_backend(model: Optional[FaultModel] = None, *,
                            priority: int = 60,
                            override: bool = True) -> None:
    """Register (or register again) the device-fidelity backend,
    optionally activating a new fault campaign."""
    if model is not None:
        set_fault_model(model)
    _plan.register_backend(_plan.BackendSpec(
        name=DEVICE_BACKEND,
        ops=frozenset({"ternary"}),
        domains=frozenset({"float"}),
        packings=frozenset({"base3", "trit2"}),
        platforms=frozenset({"cpu", "cuda"}),
        priority=priority,
        runner=_run_device,
        kv_layouts=frozenset({"dense", "paged"}),
        fidelities=frozenset({"device"}),
    ), override=override)


# the built-ins register first (kernels/backends.py imports this module
# after them), then the device backend, as the reference orders them
_plan._ensure_builtin_backends()
register_device_backend()

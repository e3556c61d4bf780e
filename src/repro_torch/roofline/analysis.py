"""Three-term roofline of a traced step, as the reference's
``repro.roofline.analysis`` on the H100's constants:

    compute    = FLOPs_per_device      / peak FLOP/s (each at its rate)
    memory     = bytes_per_device      / HBM bandwidth
    collective = wire_bytes_per_device / link bandwidth

The counts come from :mod:`.op_cost`'s roll-up of the ops a traced step
dispatches on one rank (``analyze_step``), in place of the reference's
compiled HLO.  Collectives are turned into wire bytes with the standard
ring formulas (the reference's), S the bytes of the op's result:

    all-reduce          2·S·(g-1)/g    (reduce-scatter + all-gather)
    all-gather          S·(g-1)/g      (S = the full gathered size)
    reduce-scatter      S·(g-1)        (S = the per-shard output)
    all-to-all          S·(g-1)/g
    collective-permute  S

where g is the size of the op's process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card hardware constants."""
    name: str
    peak_flops: float          # FLOP/s, bf16 tensor cores (dense)
    hbm_bw: float              # B/s
    ici_bw: float              # B/s per card between nodes
    f32_flops: float = 0.0     # FLOP/s of products on f32 inputs
    int8_flops: float = 0.0    # OP/s, int8 tensor cores (dense)


# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 1979 TOP/s int8
# dense, 67 TFLOP/s f32, 3.35 TB/s HBM3.  A 16-card mesh axis spans two
# 8-card NVLink nodes (450 GB/s a direction inside a node), so a ring
# over it is bound by the inter-node link: one 400 Gb/s NDR port a card.
H100 = HW("h100-sxm", 989e12, 3.35e12, 50e9, f32_flops=67e12,
          int8_flops=1979e12)


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Bytes one rank puts on the wire for a collective of ``kind``
    whose result is ``size`` bytes over a group of ``group`` ranks."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}; expected one of "
                         f"{KINDS}")
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (group - 1) / group
    if kind in ("all-gather", "all-to-all"):
        return size * (group - 1) / group
    if kind == "reduce-scatter":
        return float(size) * (group - 1)
    return float(size)


def collective_bytes(records) -> dict:
    """Per-device wire bytes by kind from ``(kind, result bytes, group
    size)`` records; the reference's dict (every kind, ``total`` and
    ``counts``, a group of one rank counted nowhere)."""
    out = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(KINDS, 0)
    for kind, size, group in records:
        if group <= 1:
            continue
        out[kind] += wire_bytes(kind, size, group)
        counts[kind] += 1
    out["total"] = sum(out.values())
    out["counts"] = counts
    return out


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D per generated/processed token
    for serving: the 'useful work' denominator."""
    n = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float        # model FLOPs / (FLOPs_per_device x chips)
    peak_fraction: float       # t_compute / max(all terms)
    collectives: dict
    memory_stats: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
                f"{self.useful_ratio:.2f} | {self.peak_fraction:.2f} |")


def compute_seconds(cost, hw: HW = H100) -> float:
    """The products at their rates (bf16 tensor cores, f32, int8) plus
    the elementwise and reduce ops at the f32 rate."""
    return (cost.flops_by_rate["bf16"] / hw.peak_flops
            + cost.flops_by_rate["int8"] / hw.int8_flops
            + (cost.flops_by_rate["f32"] + cost.flops_by_rate["other"])
            / hw.f32_flops)


def analyze_step(cost, *, arch: str, shape: str, mesh_name: str,
                 chips: int, cfg=None, tokens: int = 0, kind: str = "train",
                 hw: HW = H100, memory_stats: Optional[dict] = None
                 ) -> RooflineReport:
    """The report of one rank's roll-up ``cost`` (an ``op_cost.OpCost``
    after its trace)."""
    coll = collective_bytes(cost.collectives)
    t_comp = compute_seconds(cost, hw)
    t_mem = cost.bytes / hw.hbm_bw
    t_coll = coll["total"] / hw.ici_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    flops = cost.flops
    mf = model_flops(cfg, tokens, kind) if cfg is not None and tokens \
        else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=cost.bytes,
        wire_bytes_per_device=coll["total"], t_compute=t_comp,
        t_memory=t_mem, t_collective=t_coll, bottleneck=bottleneck,
        model_flops_total=mf,
        useful_ratio=mf / (flops * chips) if flops else 0.0,
        peak_fraction=t_comp / max(max(terms.values()), 1e-30),
        collectives={**coll, **cost.summary()},
        memory_stats=memory_stats)

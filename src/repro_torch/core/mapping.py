"""Compact weight mapping (§3.6, Fig. 8) — pure-Python planner.

Three steps, exactly as the paper describes:
  1. each layer's weights -> an (R_L x C_L) trit matrix
     (conv C,M,k,q -> (C·k·k) x (M·q·2) SRAM columns), split into
     R x C blocks with R = rows activated per CIM cycle and C = subarray
     columns;
  2. blocks are distributed over subarrays evenly (round-robin by block
     count), optionally DUPLICATING blocks onto idle subarrays to raise
     inference parallelism;
  3. within a subarray, blocks first-fit into the column space left by
     earlier blocks at ReRAM depth slot (cluster i, SL j); when slot
     R_{i,j} fills, mapping moves to R_{i,(j+1)}.

The plan feeds the energy model (restore cycles, subarray count) and
CIMLinear (virtual macro placement).

The reference's planner (``repro.core.mapping``), over this package's
``MacroConfig``: pure host Python, no kernel.  Its first fit resumes
each width's scan where the last block of that width went, which places
every block where the reference's scan from slot 0 does, without
rescanning the slots that earlier blocks filled (ResNet-18 has 21,828
blocks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .cim import MacroConfig


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One weight tensor; conv: (cin, k, k, cout); fc: k=1.
    `spatial` = output feature-map positions (weight reuse per inference)."""
    name: str
    cin: int
    cout: int
    kernel: int = 1
    spatial: int = 1

    @property
    def rows(self) -> int:          # R_L
        return self.cin * self.kernel * self.kernel

    def cols(self, num_trits: int) -> int:   # C_L in SRAM columns
        return self.cout * num_trits * 2

    def params(self) -> int:
        return self.rows * self.cout

    def macs(self) -> int:
        """MACs for one inference."""
        return self.rows * self.cout * self.spatial


@dataclasses.dataclass
class Placement:
    layer: str
    block_row: int          # which R-row band of the layer matrix
    block_col: int          # which C-column band
    subarray: int
    cluster: int            # i
    depth: int              # j  (SL index within cluster)
    col_offset: int         # starting SRAM column inside the subarray slot
    width: int              # SRAM columns occupied


@dataclasses.dataclass
class MappingPlan:
    placements: list
    num_subarrays: int
    depth_slots_used: int           # max (cluster, depth) index used + 1
    restore_cycles: int             # one per occupied depth slot
    total_block_rows: int
    duplication: int
    overflow_trits: int             # trits that did NOT fit on-chip
    utilization: float              # occupied SRAM-col-slots / capacity

    @property
    def fits(self) -> bool:
        return self.overflow_trits == 0


def _blocks(layers: Sequence[LayerSpec], cfg: MacroConfig):
    """Step 1: split every layer matrix into (R x C) blocks; yields
    (layer, brow, bcol, width_cols) sorted large-to-small per the paper's
    'smaller blocks fill the columns left by the former block' rule."""
    out = []
    for sp in layers:
        n_r = math.ceil(sp.rows / cfg.rows_active)
        c_l = sp.cols(cfg.num_trits)
        n_c = math.ceil(c_l / cfg.sram_cols)
        for br in range(n_r):
            for bc in range(n_c):
                width = min(cfg.sram_cols, c_l - bc * cfg.sram_cols)
                out.append((sp.name, br, bc, width))
    return out


def compact_map(layers: Sequence[LayerSpec], cfg: MacroConfig = MacroConfig(),
                num_subarrays: int | None = None, duplicate: bool = False) -> MappingPlan:
    if num_subarrays is None:
        num_subarrays = cfg.num_subarrays
    blocks = _blocks(layers, cfg)
    # step 2: even distribution (round-robin)
    per_sub = [[] for _ in range(num_subarrays)]
    for idx, b in enumerate(blocks):
        per_sub[idx % num_subarrays].append(b)

    # each subarray: rows/rows_active row-bands x sram_cols columns per
    # depth slot; depth slots = clusters_per_cell * rerams_per_cluster
    bands = cfg.rows // cfg.rows_active
    max_depth = cfg.clusters_per_cell * cfg.rerams_per_cluster
    placements: list[Placement] = []
    overflow = 0
    max_slot = 0
    occupied_cols = 0
    for s, blist in enumerate(per_sub):
        # first-fit within (depth, band): cursor per depth slot
        # free space tracked as (depth, band) -> next free column
        cursors: dict[tuple[int, int], int] = {}
        # the first slot that may still hold a block of each width: a
        # slot's free columns only shrink, so a slot too full for a width
        # stays too full for it, and the scan for the next block of that
        # width resumes here (the same first fit as a scan from slot 0)
        first: dict[int, int] = {}
        # sort smaller blocks later so they backfill leftover columns
        blist = sorted(blist, key=lambda b: -b[3])
        for (name, br, bc, width) in blist:
            placed = False
            slot = first.get(width, 0)
            while slot < max_depth * bands:
                depth, band = divmod(slot, bands)
                free = cursors.get((depth, band), 0)
                if cfg.sram_cols - free >= width:
                    cursors[(depth, band)] = free + width
                    cluster, d_in = divmod(depth, cfg.rerams_per_cluster)
                    placements.append(Placement(name, br, bc, s, cluster,
                                                d_in, free, width))
                    occupied_cols += width
                    max_slot = max(max_slot, depth + 1)
                    placed = True
                    break
                slot += 1
            first[width] = slot
            if not placed:
                overflow += width * cfg.rows_active // 2  # trits that spill
    dup = 1
    if duplicate and overflow == 0:
        # duplicate the whole plan onto idle depth slots for parallelism
        capacity_slots = max_depth
        dup = max(1, capacity_slots // max(1, max_slot))
    capacity = num_subarrays * bands * max_depth * cfg.sram_cols
    return MappingPlan(
        placements=placements,
        num_subarrays=num_subarrays,
        depth_slots_used=max_slot,
        restore_cycles=max_slot,
        total_block_rows=len(blocks),
        duplication=dup,
        overflow_trits=overflow,
        utilization=occupied_cols / capacity,
    )


def subarrays_needed(layers: Sequence[LayerSpec], cfg: MacroConfig = MacroConfig()) -> int:
    """Minimum subarrays so that every trit fits (capacity argument of
    Fig. 11(b): ResNet-18 needs 6 TL subarrays vs 76 SL subarrays)."""
    total_trits = sum(sp.params() for sp in layers) * cfg.num_trits
    cap = cfg.rows * cfg.trit_cols * cfg.trits_per_cell
    return math.ceil(total_trits / cap)


# ---- reference models of the paper's evaluation (§4.1) ------------------

def resnet18_cifar() -> list[LayerSpec]:
    """ResNet-18 (CIFAR-10 variant, ~11.2M params ~ 11 MB @ 8b)."""
    ls = [LayerSpec("conv1", 3, 64, 3, 32 * 32)]
    cfgs = [(64, 64, 2, 32), (64, 128, 2, 16), (128, 256, 2, 8), (256, 512, 2, 4)]
    for i, (cin, cout, blocks, hw) in enumerate(cfgs):
        for b in range(blocks):
            c0 = cin if b == 0 else cout
            ls.append(LayerSpec(f"s{i}b{b}c1", c0, cout, 3, hw * hw))
            ls.append(LayerSpec(f"s{i}b{b}c2", cout, cout, 3, hw * hw))
            if b == 0 and cin != cout:
                ls.append(LayerSpec(f"s{i}b{b}sc", cin, cout, 1, hw * hw))
    ls.append(LayerSpec("fc", 512, 10, 1, 1))
    return ls


def vgg9_cifar() -> list[LayerSpec]:
    """VGG-9 (~3M params ~ 3 MB @ 8b) as in [24]'s federated benchmark."""
    return [LayerSpec("conv1", 3, 32, 3, 32 * 32), LayerSpec("conv2", 32, 64, 3, 32 * 32),
            LayerSpec("conv3", 64, 128, 3, 16 * 16), LayerSpec("conv4", 128, 128, 3, 16 * 16),
            LayerSpec("conv5", 128, 256, 3, 8 * 8), LayerSpec("conv6", 256, 256, 3, 8 * 8),
            LayerSpec("fc1", 256 * 16, 512, 1, 1), LayerSpec("fc2", 512, 512, 1, 1),
            LayerSpec("fc3", 512, 10, 1, 1)]

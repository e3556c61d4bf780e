"""The enumerable registry of sharding-rule variants, as the reference's
``repro.dist.variants``.

Every placement the repo can resolve is some base ``rules_for(cfg, mode,
fsdp)`` plus at most one of the named overrides below.
``enumerate_variants(cfg)`` yields every (mode x fsdp x variant) cell for
one model config; crossing that with ``MESHES`` gives the placement
lattice that the ``shard`` analysis pass proves.  All of it is abstract:
``Rules`` and ``MeshSpec`` carry no devices.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

from .mesh import MULTI_POD, SINGLE_POD, MeshSpec
from .sharding import Rules, rules_for

# name -> (Rules.with_overrides kwargs, one-line rationale).
OVERRIDES: dict[str, tuple[dict, str]] = {
    "ep-data": (
        dict(expert="data"),
        "true EP: experts sharded over the DP axis - tokens move to "
        "the expert owners via all-to-all instead of re-gathering "
        "the expert weights over 'data' on every use",
    ),
    "pure-dp": (
        dict(batch=("pod", "data", "model"), heads=None, kv=None,
             mlp=None, inner=None, vocab=None, expert=None,
             embed_rp=None, head_count=None, cache_seq=None),
        "small models on big meshes: fold the model axis into data "
        "parallelism (1 sequence per card) and keep weights "
        "replicated over it",
    ),
    "sp": (
        dict(seq="model"),
        "sequence parallelism over 'model' (Megatron-SP): everything "
        "between the TP matmuls stops being replicated",
    ),
}

# Variants whose point is weight replication: the shard pass skips its
# replication-floor rule (SD003) for these.
REPLICATING_VARIANTS = frozenset({"pure-dp"})

# The meshes the prover crosses the variants with.
MESHES: tuple[MeshSpec, ...] = (SINGLE_POD, MULTI_POD)


def apply_override(rules: Rules, name: str) -> Rules:
    """Apply one named override variant to a base ``Rules``."""
    try:
        overrides, _ = OVERRIDES[name]
    except KeyError:
        raise KeyError(
            f"unknown rules variant {name!r}; known: "
            f"{sorted(OVERRIDES)}") from None
    return rules.with_overrides(**overrides)


class VariantCell(NamedTuple):
    """One resolved cell of the rules lattice for a model config."""
    mode: str          # "train" | "serve"
    fsdp: bool
    variant: str       # "base" or an OVERRIDES key
    rules: Rules

    @property
    def tag(self) -> str:
        fs = "fsdp" if self.fsdp else "nofsdp"
        return f"{self.mode}/{fs}/{self.variant}"


def enumerate_variants(cfg) -> Iterator[VariantCell]:
    """Yield every (mode x fsdp x variant) rules cell for one config."""
    for mode in ("train", "serve"):
        for fsdp in (True, False):
            base = rules_for(cfg, mode, fsdp=fsdp)
            yield VariantCell(mode, fsdp, "base", base)
            for name in OVERRIDES:
                yield VariantCell(mode, fsdp, name,
                                  apply_override(base, name))

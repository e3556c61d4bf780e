"""Logical-axis sharding rules: names -> per-dim mesh axes -> DTensor
placements, as the reference's ``repro.dist.sharding``.

Every parameter and cache leaf carries *logical* axis names
(``ParamSpec.axes``, the ``constrain_act`` call sites).  This module owns
the one mapping from those names to physical mesh axes, so a whole
parallelism strategy is one ``Rules`` object; ``dist.variants`` holds the
named overrides.

Resolution invariants (enforced by ``logical_to_spec``, the reference's
semantics, held against it by ``tests/test_torch_dist.py``):

* **divisibility** - a dim only shards if its size divides evenly over
  the target mesh axes; otherwise it silently replicates.
* **no axis reuse** - one physical axis shards at most one dim of a
  given array (left-to-right, first dim wins).
* **quantum units** - dims made of indivisible units (attention heads:
  quantum = head_dim) shard by the unit count, so a TP axis never splits
  mid-head.
* **batch folding** - 'batch' maps to the tuple of data-parallel axes
  present in the mesh; trailing axes are dropped until the batch
  divides, so a batch of 1 replicates.
* **zero-size dims** never shard.

A resolved spec is a tuple with one entry per dim (an axis name, a tuple
of names, or None), trailing None entries dropped, as the reference's
``PartitionSpec`` is.  ``placements(spec, mesh)`` turns it into DTensor
placements: a dim sharded over two mesh axes gets ``Shard(d)`` on both
mesh dims, in the spec's order.

``activation_context`` installs the (rules, mesh) pair that
``constrain_act`` resolves against for the length of a meshed call;
with no context, or for a plain (local) tensor, it is a no-op.
``row_split`` installs the mesh dims a meshed call's activation rows are
split over (:class:`RowSplit`), for the MoE block's routing groups,
which depend on the whole call and not on a row
(``runtime.row_block`` installs it beside the exact mode's per-call
input scale).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

from . import mesh as mesh_lib


class UnknownLogicalAxisError(KeyError):
    """A ParamSpec / constraint names a logical axis no rule covers."""


# ---------------------------------------------------------------------
# rule sets
# ---------------------------------------------------------------------

# Default logical->physical mapping for training.  Values are a physical
# axis name, a tuple of names (folded jointly, trailing ones dropped on
# divisibility failure), or None (replicate).
_TRAIN_AXES = {
    # activations
    "batch": mesh_lib.DP_AXES,
    # continuous-batching slot pool: the pool's leading slot axis is the
    # serving batch axis, so it folds over the same DP axes
    "slot": mesh_lib.DP_AXES,
    # paged-KV block pool: pages distribute over the same DP axes
    "page": mesh_lib.DP_AXES,
    "seq": None,
    "kv_seq": None,
    "head_count": "model",
    "act_embed": None,
    # parameters
    "layers": None,
    "embed": "data",            # FSDP: weights reduce-scattered over DP
    "embed_rp": "model",        # row-parallel contraction (kv projections)
    "vocab": "model",           # unembed: column-parallel TP
    "vocab_in": None,           # lookup table: vocab dim never sharded
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "inner": "model",           # SSM expanded dim
    "expert": "model",
    "cache_seq": None,
    "none": None,
}

# Serving additionally shards the KV-cache sequence dim over the TP axis
# and anchors cache reads ('kv_seq') to match.
_SERVE_AXES = {**_TRAIN_AXES, "cache_seq": "model", "kv_seq": "model"}


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable logical->physical axis mapping + sharding quanta."""
    axis_map: Any                      # dict[str, str | tuple | None]
    quantum: Any = None                # dict[str, int] - unit sizes

    def physical(self, name: str):
        try:
            return self.axis_map[name]
        except KeyError:
            raise UnknownLogicalAxisError(
                f"no sharding rule for logical axis {name!r}; known axes: "
                f"{sorted(self.axis_map)}") from None

    def with_overrides(self, **overrides) -> "Rules":
        """New Rules with some logical axes remapped (None = replicate)."""
        return Rules({**self.axis_map, **overrides}, dict(self.quantum or {}))

    def with_quantum(self, **units) -> "Rules":
        return Rules(dict(self.axis_map), {**(self.quantum or {}), **units})


def train_rules(fsdp: bool = True, quantum: Optional[dict] = None) -> Rules:
    axes = dict(_TRAIN_AXES)
    if not fsdp:
        axes["embed"] = None
    return Rules(axes, dict(quantum or {}))


def serve_rules(fsdp: bool = True, quantum: Optional[dict] = None) -> Rules:
    axes = dict(_SERVE_AXES)
    if not fsdp:
        axes["embed"] = None
    return Rules(axes, dict(quantum or {}))


def rules_for(cfg, mode: str, fsdp: bool = True) -> Rules:
    """Rules for a ModelConfig: head-bearing dims get quantum = head_dim
    so TP never splits inside a head (GQA kv groups included)."""
    quantum = {"heads": cfg.hd, "kv": cfg.hd}
    if mode == "train":
        return train_rules(fsdp=fsdp, quantum=quantum)
    if mode == "serve":
        return serve_rules(fsdp=fsdp, quantum=quantum)
    raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")


# ---------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------

def _resolve_dim(candidate, dim: int, name: str, sizes: dict, used: set,
                 quantum: dict):
    """One dim -> spec entry (axis name, tuple, or None)."""
    if candidate is None or dim == 0:
        return None
    axes = (candidate,) if isinstance(candidate, str) else tuple(candidate)
    axes = tuple(a for a in axes if a in sizes and a not in used)
    if not axes:
        return None
    q = (quantum or {}).get(name, 1)
    if q > 1 and dim % q:
        return None                      # partial unit: cannot shard at all
    units = dim // q
    # drop trailing axes until the unit count divides the fold product
    while axes:
        prod = math.prod(sizes[a] for a in axes)
        if units % prod == 0:
            break
        axes = axes[:-1]
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def logical_to_spec(axes: tuple, shape: tuple, rules: Rules,
                    mesh) -> tuple:
    """Resolve logical axes against a mesh into a spec tuple.

    `mesh` may be a DeviceMesh, a MeshSpec, or anything with .axis_names
    + .devices.  Trailing replicated dims are trimmed (``("data",)``
    rather than ``("data", None)``), as the reference's PartitionSpec
    entries are."""
    if len(axes) != len(shape):
        raise ValueError(
            f"axes {axes} and shape {shape} disagree on rank")
    sizes = mesh_lib.axis_sizes(mesh)
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        entry = _resolve_dim(rules.physical(name), dim, name, sizes, used,
                             rules.quantum)
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
        entries.append(entry)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a resolved spec on a DeviceMesh: per mesh
    dim, ``Shard(d)`` for the dim its axis shards, else ``Replicate()``.
    A dim folded over several mesh axes is ``Shard(d)`` on each of them,
    split in the spec's order (the first axis outermost)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    order = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            order.append((names.index(a), d))
    for i, d in order:
        out[i] = Shard(d)
    # DTensor splits a dim sharded on several mesh dims in mesh-dim
    # order; the spec names them outermost first, so the two agree only
    # when the spec's order follows the mesh's
    for d in {d for _, d in order}:
        dims = [i for i, dd in order if dd == d]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec} folds dim {d} over mesh dims "
                             f"{dims} against the mesh's order {names}")
    return tuple(out)


def page_spmd_axes(rules: Rules, mesh, pages: int):
    """Physical mesh axes the paged-KV pool's leading ``page`` axis
    folds over - the page-pool mirror of :func:`slot_spmd_axes`, with
    the same folding/divisibility policy (None when replicated)."""
    entry = _resolve_dim(rules.physical("page"), pages, "page",
                         mesh_lib.axis_sizes(mesh), set(), rules.quantum)
    if entry is None:
        return None
    return entry if isinstance(entry, str) else tuple(entry)


def slot_spmd_axes(rules: Rules, mesh, slots: int):
    """Physical mesh axes the slot-pool axis folds over, under the same
    folding/divisibility policy as logical_to_spec (trailing DP axes
    dropped until `slots` divides); None when the pool replicates."""
    entry = _resolve_dim(rules.physical("slot"), slots, "slot",
                         mesh_lib.axis_sizes(mesh), set(), rules.quantum)
    if entry is None:
        return None
    return entry if isinstance(entry, str) else tuple(entry)


def spec_tree(specs: Any, rules: Rules, mesh) -> Any:
    """ParamSpec tree -> spec-tuple tree (same nested-dict structure)."""
    from .. import tree
    return tree.map_specs(
        lambda d: logical_to_spec(d.axes, d.shape, rules, mesh), specs)


# ---------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------

def constrain(x, axes: tuple, rules: Optional[Rules], mesh):
    """Redistribute a DTensor to the placements its logical axes resolve
    to; a no-op off-mesh and for a plain (rank-local) tensor."""
    if rules is None or mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(logical_to_spec(axes, tuple(x.shape), rules, mesh),
                      mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# Module-level activation context: model code calls constrain_act
# without threading rules/mesh through every signature.  The meshed
# train step and the meshed engine install it for the length of their
# call (activation_context); off-mesh it is None and constrain_act
# returns at its first test.
_ACT_CTX = None


def set_activation_context(rules: Optional[Rules], mesh) -> None:
    """Install (rules, mesh) for constrain_act; either None clears it."""
    global _ACT_CTX
    _ACT_CTX = None if rules is None or mesh is None else (rules, mesh)


def get_activation_context():
    return _ACT_CTX


@contextlib.contextmanager
def activation_context(rules: Optional[Rules], mesh):
    """(rules, mesh) installed for the body, the previous context after."""
    old = _ACT_CTX
    set_activation_context(rules, mesh)
    try:
        yield
    finally:
        set_activation_context(*(old or (None, None)))


def constrain_act(x, axes: Optional[tuple] = None):
    """Re-anchor an activation's placement (no-op without a context).

    Default axes assume the (batch, seq, *feature) layout with features
    replicated - the layout of every residual-stream activation."""
    ctx = _ACT_CTX
    if ctx is None or x.ndim < 2:
        return x
    rules, mesh = ctx
    if axes is None:
        axes = ("batch", "seq") + ("none",) * (x.ndim - 2)
    return constrain(x, axes, rules, mesh)


# ---------------------------------------------------------------------
# row splits
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The mesh dims (indices, outermost first) that split a meshed
    call's activation rows into equal contiguous blocks, one per rank of
    their product: the batch of the bucket engine, the slot pool of the
    schedulers.  Rank ``index`` (its coordinates on ``dims``, outermost
    first) holds rows ``[index * rows, (index + 1) * rows)`` of the
    whole call, where ``rows`` is its local count."""
    mesh: Any
    dims: tuple

    @property
    def sizes(self) -> tuple:
        return tuple(self.mesh.size(i) for i in self.dims)

    @property
    def count(self) -> int:
        return math.prod(self.sizes)

    def coords(self) -> tuple:
        coord = self.mesh.get_coordinate()
        return tuple(coord[i] for i in self.dims)

    @property
    def index(self) -> int:
        out = 0
        for c, n in zip(self.coords(), self.sizes):
            out = out * n + c
        return out


_ROW_SPLIT = contextvars.ContextVar("row_split", default=None)


@contextlib.contextmanager
def row_split(split: Optional[RowSplit]):
    """Within the block, the model's rows are this rank's block of a
    call split by ``split`` (None: the rows are the whole call)."""
    token = _ROW_SPLIT.set(split)
    try:
        yield
    finally:
        _ROW_SPLIT.reset(token)


def get_row_split() -> Optional[RowSplit]:
    return _ROW_SPLIT.get()

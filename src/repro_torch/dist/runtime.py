"""Running on a ``DeviceMesh``: placing trees as DTensors by their
logical axes, and the rank-local views the model computes on.

The split of work, which every meshed path shares:

* **At rest** every parameter and optimizer-state leaf is a
  ``DTensor`` placed by ``logical_to_spec`` of its ``ParamSpec.axes``
  (:func:`place_tree`); a packed weight is a ``PackedTernary`` whose
  ``data`` takes the leaf's axes (trit2's ``K/4`` rows divided by the
  same rule) and whose ``scale`` takes ``axes[:-2] + (axes[-1],)``, as
  the reference's ``launch/input_specs.py`` places them.
* **Activations** are plain tensors: each rank holds its own rows of the
  batch (the batch folded over the DP axes, :func:`shard_rows`) and
  every feature, the same on every rank of the model axis.  So the model
  code runs unchanged on rank-local tensors, and ``constrain_act`` has
  nothing to redistribute.  A serving decode state is such a tensor
  too: its rows at every position, not placed by its cache specs.
* **At use** a float leaf is gathered whole on every rank
  (:func:`param_view`, over the model axis too: the state is sharded at
  rest only, like ZeRO-1, not per layer as in FSDP); a packed leaf is
  gathered over the DP axes only and keeps its model-axis shard, which
  ``cim_linear.linear`` consumes as tensor parallelism
  (:class:`ShardedPacked`): column-parallel (N sharded) all-gathers the
  output columns, row-parallel (K sharded) sums the partial products.
* **Gradients** of the gathered leaves are rank-local; the train step
  averages them over the DP axes and keeps each rank's shard
  (:func:`reduce_grads`, a reduce-scatter).

Mesh dims of size one are never redistributed: on a one-card mesh every
view is the leaf's own storage, and the model runs the aten ops of the
unmeshed path on the same tensors.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple, Optional

import torch

from .. import tree as tree_lib
from ..kernels.ops import PackedTernary
from . import mesh as mesh_lib
from . import sharding as shd


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_mesh(mesh) -> bool:
    """Whether ``mesh`` is a DeviceMesh (and not the axis-size mapping
    the one-card paths take)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


# ------------------------------------------------------------ placing

def _from_local(local: torch.Tensor, mesh, place: tuple, shape,
                dtype=None):
    """A DTensor of the contiguous global ``shape`` from this rank's
    piece ``local`` under ``place``."""
    from torch.distributed.tensor import DTensor
    g = torch.empty(tuple(shape), dtype=dtype or local.dtype, device="meta")
    return DTensor.from_local(local, mesh, tuple(place), run_check=False,
                              shape=g.shape, stride=g.stride())


def _local_chunk(x: torch.Tensor, place: tuple, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` (held whole on every rank) under
    ``place``, cut locally: no communication.  The rules shard only
    dims that divide, so every piece has the same size."""
    coord = mesh.get_coordinate()
    out = x
    for i, p in enumerate(place):
        if p.is_shard():
            n = mesh.size(i)
            d = p.dim
            step = out.shape[d] // n
            out = out.narrow(d, coord[i] * step, step)
    return out.contiguous()


def place(x: torch.Tensor, axes: tuple, rules: shd.Rules, mesh):
    """A DTensor of ``x`` (the same tensor on every rank) placed by its
    logical axes; each rank keeps its own piece."""
    spec = shd.logical_to_spec(tuple(axes), tuple(x.shape), rules, mesh)
    want = shd.placements(spec, mesh)
    return _from_local(_local_chunk(x, want, mesh), mesh, want, x.shape)


def packed_axes(axes: tuple) -> tuple[tuple, tuple]:
    """(data axes, scale axes) of a packed leaf with logical ``axes``."""
    axes = tuple(axes)
    return axes, axes[:-2] + (axes[-1],)


def place_leaf(x, spec, rules: shd.Rules, mesh):
    """One leaf (tensor or ``PackedTernary``) placed by its ParamSpec."""
    if isinstance(x, PackedTernary):
        daxes, saxes = packed_axes(spec.axes)
        return PackedTernary(place(x.data, daxes, rules, mesh),
                             place(x.scale, saxes, rules, mesh), x.mode)
    if isinstance(x, torch.Tensor):
        return place(x, spec.axes, rules, mesh)
    return x


def place_tree(tree: Any, specs: Any, rules: shd.Rules, mesh) -> Any:
    """A nested dict of tensors / packed weights placed leaf by leaf by
    the ParamSpec tree ``specs`` of the same structure (a key missing
    from ``specs``, like a cache's host ``pos``, is kept as it is)."""
    if isinstance(tree, dict):
        return {k: (place_tree(v, specs[k], rules, mesh) if k in specs
                    else v) for k, v in tree.items()}
    return place_leaf(tree, specs, rules, mesh)


def abstract(shape: tuple, axes: tuple, dtype, rules: shd.Rules, mesh,
             device="meta"):
    """A storage-free DTensor of the global ``shape`` placed by its
    logical ``axes``: a meta piece, or a fake one under an active
    ``FakeTensorMode`` (the dry run's, on ``device``)."""
    spec = shd.logical_to_spec(tuple(axes), tuple(shape), rules, mesh)
    want = shd.placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(want):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    piece = torch.empty(local, dtype=dtype, device=device)
    return _from_local(piece, mesh, want, shape)


def placement_tree(specs: Any, rules: shd.Rules, mesh,
                   dtype=torch.float32, device="meta") -> Any:
    """ParamSpec tree -> tree of storage-free DTensors (:func:`abstract`)
    with each leaf's global shape, dtype (``dtype`` where the spec has
    none) and placements: the abstract state."""
    return tree_lib.map_specs(
        lambda d: abstract(d.shape, d.axes, d.dtype or dtype, rules, mesh,
                           device), specs)


def distribute_like(x: torch.Tensor, like):
    """``x`` (whole, on every rank) placed as the DTensor ``like``."""
    mesh, place_ = like.device_mesh, tuple(like.placements)
    return _from_local(_local_chunk(x, place_, mesh), mesh, place_, x.shape)


# ------------------------------------------------------ gathering views

def _target(x, keep) -> tuple:
    """Placements of the view: a mesh dim of size one keeps its
    placement (nothing to move), another keeps it where ``keep(i, p)``
    and is replicated elsewhere."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return tuple(p if mesh.size(i) == 1 or keep(i, p) else Replicate()
                 for i, p in enumerate(x.placements))


def _view(x, keep) -> torch.Tensor:
    want = _target(x, keep)
    if want != tuple(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return x.to_local()


def full(x):
    """A DTensor gathered whole on every rank (the rank-local tensor of
    a one-card mesh as it is); anything else as it is."""
    if isinstance(x, PackedTernary) and is_dtensor(x.data):
        return PackedTernary(full(x.data), full(x.scale), x.mode)
    if not is_dtensor(x):
        return x
    return _view(x, lambda i, p: False)


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of a tree gathered whole (a collective: every
    rank must call it)."""
    return tree_lib.map_leaves(full, tree)


class ExpertSplit(NamedTuple):
    """How a stacked expert weight's E dim is split: over mesh dim
    ``dim`` (process group ``group``), ``count`` ranks, this rank's
    experts ``[index * E_local, (index + 1) * E_local)``."""
    mesh: Any
    dim: int
    group: Any
    index: int
    count: int


class ShardedPacked(PackedTernary):
    """The rank-local shard of a packed weight split over the mesh:
    ``split`` 'col' (N sharded over ``group``, output columns
    all-gathered), 'row' (K sharded, partial products summed) or None
    (K and N whole), and ``ep`` the :class:`ExpertSplit` of a stacked
    expert weight's E dim (None where E is whole), which
    ``models.moe`` consumes."""

    def __init__(self, data, scale, mode, group, split, ep=None):
        super().__init__(data, scale, mode)
        self.group = group
        self.split = split
        self.ep = ep

    def __getitem__(self, i) -> "ShardedPacked":
        return ShardedPacked(self.data[i], self.scale[i], self.mode,
                             self.group, self.split, self.ep)

    def __repr__(self):
        return (f"ShardedPacked(mode={self.mode!r}, split={self.split!r}, "
                f"ep={None if self.ep is None else self.ep.count}, "
                f"data={tuple(self.data.shape)}, "
                f"scale={tuple(self.scale.shape)})")

    def _rows(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """The K range of ``x (..., K)`` this row shard multiplies, zero
        past K (trit2's rows cover a multiple of 4)."""
        kl = self.kdim
        xl = x[..., index * kl:(index + 1) * kl]
        if xl.shape[-1] < kl:
            xl = torch.nn.functional.pad(xl, (0, kl - xl.shape[-1]))
        return xl.contiguous()

    def partial(self, x: torch.Tensor, run, index: int) -> torch.Tensor:
        """This shard's part of ``x (..., K) @ w`` through ``run(x_local,
        w_local)`` (the planned kernel on the local shard), where the
        shard is number ``index`` along the model axis: its output
        columns ('col'), or the partial product of its K rows ('row')."""
        if self.split == "col":
            return run(x, self).contiguous()
        return run(self._rows(x, index), self).contiguous()

    def partial_int32(self, x: torch.Tensor, index: int) -> tuple:
        """A row shard's part in the int8 domain: ``x`` quantized per
        row over its whole K (the scale ``amax / 127`` must see every
        column), this shard's K range of the codes through the int32
        sums (``ternary_matmul.matmul_int32``).  Returns (int32 sums
        (M, N), the rows' scales (M,))."""
        from ..kernels import ops
        from ..kernels import ternary_matmul as tm
        xi, x_scale = ops.quantize_acts_int8(x)
        xl = self._rows(xi, index)
        acc = tm.matmul_int32(xl.reshape(-1, xl.shape[-1]), self.data,
                              self.mode)
        return acc, x_scale.reshape(-1)

    def epilogue(self, acc: torch.Tensor, x_scale: torch.Tensor,
                 lead: tuple) -> torch.Tensor:
        """``acc * x_scale * scale`` in f32, in that order (the int8
        routes' epilogue), on the sums of every row shard."""
        y = acc.float() * x_scale.float()[:, None] * self.scale.float()
        return y.reshape(*lead, y.shape[-1])

    def apply(self, x: torch.Tensor, run, domain: str = "float"
              ) -> torch.Tensor:
        """``x (..., K) @ self``: this rank's :meth:`partial` and the
        model-axis collective that completes it.  In the int8 domain a
        column split is the planned kernel on whole rows (bitwise the
        unsplit product's columns); a row split adds the ranks' int32
        sums, which is exact, and applies the epilogue once."""
        import torch.distributed as dist
        index = dist.get_rank(self.group)
        if self.split == "row" and domain == "int8":
            acc, x_scale = self.partial_int32(x, index)
            dist.all_reduce(acc, group=self.group)
            return self.epilogue(acc, x_scale, tuple(x.shape[:-1]))
        y = self.partial(x, run, index)
        if self.split == "col":
            parts = [torch.empty_like(y)
                     for _ in range(dist.get_world_size(self.group))]
            dist.all_gather(parts, y, group=self.group)
            return torch.cat(parts, dim=-1)
        dist.all_reduce(y, group=self.group)
        return y


def _packed_view(w: PackedTernary) -> PackedTernary:
    """A packed leaf gathered over every mesh dim but those that split
    its N or K dim over a non-DP axis, or its expert dim over any axis,
    which stay split: a ``ShardedPacked`` where such a dim has more than
    one rank (tensor parallelism on K or N, expert parallelism on E)."""
    data, scale = w.data, w.scale
    mesh = data.device_mesh
    names = tuple(mesh.mesh_dim_names)
    nd = data.ndim
    split, tp_dim, ep_dim = None, None, None
    for i, p in enumerate(data.placements):
        if not p.is_shard() or mesh.size(i) == 1:
            continue
        if nd >= 4 and p.dim == nd - 3:
            ep_dim = i                       # a stacked expert weight's E
        elif names[i] in mesh_lib.DP_AXES:
            continue
        elif p.dim in (nd - 1, nd - 2):
            split = "col" if p.dim == nd - 1 else "row"
            tp_dim = i
        else:
            raise NotImplementedError(
                f"packed weight {tuple(data.shape)} is split over "
                f"{names[i]!r} on dim {p.dim}: only the K, N and expert "
                f"dims stay split on a mesh (ROADMAP queue 1 item 8)")
    local = _view(data, lambda i, p: i in (tp_dim, ep_dim))
    local_scale = _view(scale, lambda i, p: i == ep_dim or (
        i == tp_dim and split == "col"))
    if split is None and ep_dim is None:
        return PackedTernary(local, local_scale, w.mode)
    ep = None
    if ep_dim is not None:
        ep = ExpertSplit(mesh, ep_dim, mesh.get_group(ep_dim),
                         mesh.get_coordinate()[ep_dim], mesh.size(ep_dim))
    return ShardedPacked(local, local_scale, w.mode,
                         None if tp_dim is None else mesh.get_group(tp_dim),
                         split, ep)


def param_view(params: Any) -> Any:
    """The compute view of a placed params tree: float leaves whole on
    every rank, packed leaves gathered over the DP axes with their
    model-axis shard kept (:class:`ShardedPacked`).  Unplaced leaves
    pass through."""
    def leaf(x):
        if isinstance(x, PackedTernary) and is_dtensor(x.data):
            return _packed_view(x)
        return full(x)
    if isinstance(params, dict):
        return {k: param_view(v) for k, v in params.items()}
    return leaf(params)


# -------------------------------------------------------- batch rows

def batch_split(rules: shd.Rules, mesh, rows: int,
                axis: str = "batch") -> Optional[shd.RowSplit]:
    """How a call of ``rows`` rows on the logical ``axis`` ('batch' or
    'slot') splits over the mesh: the :class:`~.sharding.RowSplit` of the
    mesh dims of more than one rank that shard it (the DP axes the rule
    folds the rows over, where they divide), or None where every rank
    holds them all."""
    spec = shd.logical_to_spec((axis,), (rows,), rules, mesh)
    dims = tuple(i for i, p in enumerate(shd.placements(spec, mesh))
                 if p.is_shard() and mesh.size(i) > 1)
    return shd.RowSplit(mesh, dims) if dims else None


def split_count(split: Optional[shd.RowSplit]) -> int:
    """How many row blocks ``split`` cuts a call into (1 without one)."""
    return split.count if split is not None else 1


def shard_rows(x: torch.Tensor, split: Optional[shd.RowSplit]
               ) -> torch.Tensor:
    """This rank's block of the rows of ``x`` (the whole call, the same
    on every rank), cut locally: every rank draws the same global batch
    and keeps its block."""
    if split is None:
        return x
    n = x.shape[0] // split.count
    return x.narrow(0, split.index * n, n).contiguous()


def gather_split(x: torch.Tensor, split: Optional[shd.RowSplit]
                 ) -> torch.Tensor:
    """The whole call's rows from each rank's block (an all-gather over
    the split's dims, in their order; ``x`` itself without a split).
    Under grad its backward keeps this rank's block of the gradient
    summed over the split (:class:`_GatherRows`)."""
    if split is None:
        return x
    return _GatherRows.apply(x, split)


def reduce_split(x: torch.Tensor, split: Optional[shd.RowSplit],
                 op: str = "sum", skip: tuple = ()) -> torch.Tensor:
    """``x`` all-reduced (``op`` 'sum' or 'max') over the split's dims
    but those in ``skip``, in place where it reduces."""
    import torch.distributed as dist
    if split is None:
        return x
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    for i in split.dims:
        if i not in skip:
            dist.all_reduce(x, op=red, group=split.mesh.get_group(i))
    return x


def _max_over(t: torch.Tensor, split: shd.RowSplit) -> torch.Tensor:
    """The max of ``t`` over the whole call: this rank's max, all-reduced
    over the split in f32 (gloo has no bf16 max)."""
    out = t.amax().float().clone()
    return reduce_split(out, split, "max").to(t.dtype)


# ------------------------------------- collectives that carry gradients
#
# The meshed train step runs its forward and backward on this rank's
# rows (``row_block``) and sums each rank's gradient over the split
# (``reduce_grads``): its objective is the sum of the ranks' losses
# (over the split's count).  A value every rank holds alike, made from
# the rows of every rank, then sends each rank's loss gradient back to
# the rows it came from: a collective's backward sums the incoming
# gradient over the split.


def _summed(g: torch.Tensor, split: shd.RowSplit, skip: tuple = ()
            ) -> torch.Tensor:
    """``g`` summed over the split's dims (but ``skip``), in f32 and
    back in g's dtype."""
    return reduce_split(g.float().contiguous().clone(), split, "sum",
                        skip).to(g.dtype)


class _SumRows(torch.autograd.Function):
    """The sum of ``x`` over the split's ranks; its backward sums the
    gradient over them."""

    @staticmethod
    def forward(ctx, x, split, skip):
        ctx.split, ctx.skip = split, skip
        return reduce_split(x.clone(memory_format=torch.contiguous_format),
                            split, "sum", skip)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.split, ctx.skip), None, None


class _GatherRows(torch.autograd.Function):
    """The whole call's rows from each rank's block; its backward keeps
    this rank's block of the gradient summed over the split (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, split):
        from torch.distributed.tensor import Replicate, Shard
        ctx.split = split
        mesh = split.mesh
        place_ = tuple(Shard(0) if i in split.dims else Replicate()
                       for i in range(mesh.ndim))
        shape = (x.shape[0] * split.count,) + tuple(x.shape[1:])
        return full(_from_local(x.contiguous(), mesh, place_, shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate, Shard
        split = ctx.split
        mesh = split.mesh
        src = tuple(Partial() if i in split.dims else Replicate()
                    for i in range(mesh.ndim))
        want = tuple(Shard(0) if i in split.dims else Replicate()
                     for i in range(mesh.ndim))
        d = _from_local(g.float().contiguous(), mesh, src, g.shape)
        return d.redistribute(mesh, want).to_local().to(g.dtype), None


class _MaxRows(torch.autograd.Function):
    """The max of ``t`` over the whole call; its backward gives the
    gradient summed over the split to the elements equal to the max,
    split evenly among them over every rank, as the reference's
    ``jnp.max`` splits it among ties on one device (and ``amax``'s own
    backward does within a rank)."""

    @staticmethod
    def forward(ctx, t, split):
        m = _max_over(t, split)
        mask = t == m
        count = reduce_split(mask.sum().to(torch.float32), split, "sum")
        ctx.split = split
        ctx.save_for_backward(mask, count.to(torch.int64))
        return m

    @staticmethod
    def backward(ctx, g):
        mask, count = ctx.saved_tensors
        return mask * (_summed(g, ctx.split) / count), None


def sum_rows(x: torch.Tensor, split: Optional[shd.RowSplit]
             ) -> torch.Tensor:
    """:func:`reduce_split`'s sum, out of place and carrying gradients
    (the sum over the split's ranks of the incoming gradient)."""
    if split is None:
        return x
    return _SumRows.apply(x, split, ())


def max_rows(t: torch.Tensor, split: Optional[shd.RowSplit]
             ) -> torch.Tensor:
    """The max of ``t`` over the whole call (a 0-d tensor), carrying
    gradients where ``t`` needs them (:class:`_MaxRows`)."""
    if split is None:
        return t.amax()
    if torch.is_grad_enabled() and t.requires_grad:
        return _MaxRows.apply(t, split)
    return _max_over(t, split)


@contextlib.contextmanager
def row_block(split: Optional[shd.RowSplit]):
    """Within the block, the model's rows are this rank's block of a call
    split by ``split`` (None: the rows are the whole call): the MoE
    router routes the whole call's groups (``sharding.row_split``), and
    the exact plans' per-call input scale is the max over the split's
    ranks (``kernels.plan.call_amax_reducer``).  Under grad both carry
    gradients (:func:`gather_split`, :func:`sum_rows`, :func:`max_rows`),
    so a train step's forward and backward run inside it."""
    from ..kernels.plan import call_amax_reducer
    reduce = (None if split is None
              else functools.partial(max_rows, split=split))
    with shd.row_split(split), call_amax_reducer(reduce):
        yield


def reduce_grads(grads: Any, like: Any, mesh,
                 split: Optional[shd.RowSplit]) -> Any:
    """Each rank's gradient of its rows (whole tensors) -> the mean over
    the row blocks of ``split``, placed as the DTensor leaves of
    ``like``: a reduce-scatter where a DP dim has more than one rank, a
    local cut elsewhere (none on a one-card mesh)."""
    from torch.distributed.tensor import Partial, Replicate
    n = split_count(split)
    dims = split.dims if split is not None else ()

    def leaf(g, p):
        if n > 1:
            g = g / n
        src = tuple(Partial() if i in dims
                    else (p.placements[i] if mesh.size(i) == 1
                          else Replicate())
                    for i in range(mesh.ndim))
        d = _from_local(g, mesh, src, p.shape)
        if src != tuple(p.placements):
            d = d.redistribute(mesh, tuple(p.placements))
        return d
    return tree_lib.map_leaves(leaf, grads, like)


def mean_over_rows(x: torch.Tensor, split: Optional[shd.RowSplit]
                   ) -> torch.Tensor:
    """The mean of a per-rank scalar over the row blocks of ``split`` (as
    it is without one)."""
    if split is None:
        return x
    return reduce_split(x.clone(), split, "sum") / split.count


def owns(x) -> bool:
    """Whether this rank counts ``x``'s local piece in a sum over the
    mesh: the first rank of every mesh dim that replicates it."""
    if not is_dtensor(x):
        return True
    coord = x.device_mesh.get_coordinate()
    return all(p.is_shard() or coord[i] == 0
               for i, p in enumerate(x.placements))


def local(x):
    """A DTensor's rank-local tensor (its storage); anything else as it
    is."""
    return x.to_local() if is_dtensor(x) else x


def local_tree(tree: Any) -> Any:
    return tree_lib.map_leaves(local, tree)


def world_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce a rank-local sum over every rank of ``mesh`` (as it is
    when the mesh has one rank)."""
    import torch.distributed as dist
    if mesh.size() == 1:
        return x
    y = x.clone()
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(y, group=mesh.get_group(i))
    return y


SERVE_FAMILIES = ("dense", "moe")


def check_mesh_request(model, cim=None, what: str = "this path",
                       path: str = "train") -> None:
    """Raise for what ``path`` ('serve': the engines; 'train': the train
    step) does not run on a mesh yet.  Serving takes the dense and MoE
    families, both domains and exact mode; training takes every family
    and every mode that trains (float and exact; the int8 domain routes
    ternary mode only, so a float or exact config naming it trains as
    its mode does).  Ternary training is refused everywhere, by the
    train step itself, and a ``remat`` other than 'none' and 'full' by
    the model's forward."""
    if path not in ("serve", "train"):
        raise ValueError(f"path must be 'serve' or 'train', got {path!r}")
    if path == "serve" and model.cfg.family not in SERVE_FAMILIES:
        raise NotImplementedError(
            f"{what} on a mesh runs the {' and '.join(SERVE_FAMILIES)} "
            f"families; {model.cfg.name} (family {model.cfg.family!r}) on "
            f"a mesh is ROADMAP queue 1 item 8")
    if cim is not None and cim.fidelity == "device":
        raise NotImplementedError(
            "device fidelity on a mesh is not ported (ROADMAP queue 1 "
            "item 8)")


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()

"""A dispatch-level cost roll-up of a traced step, one rank's share.

The counterpart of the reference's ``roofline.hlo_cost``: there is no
HLO in the port, so a ``TorchDispatchMode`` (:class:`OpCost`) rolls up,
op by op, what the step dispatches, by the reference's rules:

* **FLOPs.** A product (aten ``mm``, ``addmm``, ``bmm``, ``baddbmm``) is
  2·M·N·K from its shapes; an elementwise or reduce op costs the larger
  of its input and output element counts; views, copies and data
  movement cost 0.  A product is placed at a rate as ``chip_smoke.py``'s
  ``step_ops`` places it: at the f32 rate only on f32 inputs called from
  ``models/ssm.py`` (in the backward pass: on the autograd nodes such a
  call made), at the bf16 tensor-core rate otherwise; the embedding
  gradient's one-hot products (``layers.embed_grad``, a sum of rows)
  are left out.  The packed matmuls are charged by their kernel's own
  cost through :func:`charge` (the ``abstract`` backend,
  ``kernels/backends.py``): 2·M·N·K, and the packed data, scale, x and
  y each read or written once.
* **Bytes.** Operands plus result of every op that is not a view or an
  alias; an indexing read (``index``, ``gather``, ``embedding``, ...)
  counts twice its result and an indexed write (``index_put``) twice
  its values, as the reference counts a slice and an update.
* **Collectives.** Each by kind with its result's bytes and its process
  group's size (:func:`.analysis.collective_bytes` turns them into wire
  bytes).
* **Live bytes.** Every storage an op makes is tracked until it dies
  (a weak reference to the storage), rounded to the CUDA caching
  allocator's 512-byte blocks; the storages registered before the trace
  (:meth:`OpCost.register`: params, optimizer state, decode state) count
  from the start.  The peak and its breakdown by category are kept;
  storages made for the gathered params view (``dist.runtime.
  param_view``) count as ``params``, those made inside the autograd
  engine as ``gradients``, the rest as ``temporaries``.

Counts are **per device**.  An op on DTensors is not counted at the
logical op, which is what ``FlopCounterMode`` counts (the global
FLOPs): the mode declines it, DTensor's dispatch runs it, and the mode
counts the local ops and collectives that dispatch issues.  The ops
DTensor's sharding propagation runs on global shapes to infer its
output are not counted.  A Python loop over layers unrolls by itself,
so nothing multiplies a body by a trip count.

``torch.unique`` has a data-dependent size; under fake tensors the mode
answers it with ``unique_count(n)`` distinct values of ``n`` (by default
``n``), which a caller sets to what its data holds.
"""
from __future__ import annotations

import contextvars
import os
import sys
import weakref
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

BLOCK = 512                  # the CUDA caching allocator's smallest block
CATEGORIES = ("params", "optimizer", "gradients", "state", "temporaries")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("op_cost",
                                                         default=None)

aten = torch.ops.aten

_PRODUCTS = {
    aten.mm: (0, lambda a: 2 * a[0].shape[0] * a[0].shape[1]
              * a[1].shape[1]),
    aten.addmm: (1, lambda a: 2 * a[1].shape[0] * a[1].shape[1]
                 * a[2].shape[1]),
    aten.bmm: (0, lambda a: 2 * a[0].shape[0] * a[0].shape[1]
               * a[0].shape[2] * a[1].shape[2]),
    aten.baddbmm: (1, lambda a: 2 * a[1].shape[0] * a[1].shape[1]
                   * a[1].shape[2] * a[2].shape[2]),
}
# ops that move data and compute nothing (FLOPs 0, bytes counted)
_MOVES = {getattr(aten, n) for n in (
    "copy_", "_to_copy", "clone", "cat", "stack", "scatter", "scatter_",
    "slice_scatter", "select_scatter", "as_strided_scatter",
    "constant_pad_nd", "repeat", "expand_copy", "roll", "flip",
    "_unsafe_view", "narrow_copy", "zero_", "fill_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "scalar_tensor", "lift_fresh_copy",
    "masked_fill", "masked_fill_", "tril", "triu") if hasattr(aten, n)}
# indexing reads: twice the result, as the reference counts a slice
_READS = {getattr(aten, n) for n in (
    "index", "index_select", "gather", "embedding", "_unsafe_index")
    if hasattr(aten, n)}
# indexed writes: twice the values written, as the reference counts a
# dynamic-update-slice
_WRITES = {getattr(aten, n) for n in (
    "index_put_", "index_put", "_index_put_impl_", "_unsafe_index_put")
    if hasattr(aten, n)}
_ALLOCS = {getattr(aten, n) for n in (
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "resize_") if hasattr(aten, n)}
_FREE = {getattr(aten, n) for n in (
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
    "set_", "record_stream") if hasattr(aten, n)}
# the functional and the c10d collectives: name -> kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_":
    "all-reduce", "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor_coalesced_":
    "reduce-scatter", "alltoall_": "all-to-all", "alltoall_base_":
    "all-to-all", "send": "collective-permute",
}
_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_MODELS = "repro_torch" + os.sep + "models" + os.sep
_SHARDING_PROP = "_sharding_prop"
_PROP = ("<sharding propagation>",)
_RUNTIME = "repro_torch" + os.sep + "dist" + os.sep + "runtime.py"
_VIEWS = ("param_view", "_packed_view", "full", "gather_tree")


def charge(flops: float = 0.0, moved: float = 0.0, rate: str = "bf16",
           kernel: Optional[str] = None, route: Optional[str] = None,
           weight_bytes: float = 0.0) -> None:
    """Charge a kernel's own cost to the active roll-up (a no-op outside
    one): ``flops`` at ``rate``, ``moved`` bytes, and one call of
    ``kernel`` on ``route``, ``weight_bytes`` of it its packed weight."""
    cost = _ACTIVE.get()
    if cost is not None:
        cost.add_kernel(flops, moved, rate, kernel, route, weight_bytes)


def _storages(tree_) -> list:
    """The tensors whose storages hold a tree: DTensors by their local
    pieces, packed weights by data and scale."""
    from .. import tree as tree_lib
    from ..dist.runtime import local
    from ..kernels.ops import PackedTernary
    out = []
    for leaf in tree_lib.leaves(tree_):
        parts = ([leaf.data, leaf.scale]
                 if isinstance(leaf, PackedTernary) else [leaf])
        out += [local(t) for t in parts if isinstance(t, torch.Tensor)]
    return out


def _block_bytes(st) -> int:
    return -(-st.nbytes() // BLOCK) * BLOCK


def storage_bytes(tree_) -> int:
    """Device bytes of a tree's storages as the roll-up counts them:
    each storage once, in the caching allocator's 512-byte blocks (the
    card's side of a predicted peak counts its inputs so)."""
    seen = {}
    for t in _storages(tree_):
        st = t.untyped_storage()
        seen[st.data_ptr()] = _block_bytes(st)
    return sum(seen.values())


def _tensors(xs) -> list:
    return [x for x in tree_flatten(xs)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args, kwargs) -> int:
    """The size of a collective's process group: its ``group_size``
    argument, or the group named or passed."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    names = [a.name for a in func._schema.arguments]
    given = dict(zip(names, args))
    given.update(kwargs or {})
    if "group_size" in given:
        return int(given["group_size"])
    if given.get("group_name"):
        return c10d._resolve_process_group(given["group_name"]).size()
    for value in given.values():
        if isinstance(value, dist.ProcessGroup):
            return value.size()
    return dist.get_world_size()


_SSM_MARK = "repro_torch.ssm"      # the autograd node metadata's key


class _Mark(TorchFunctionMode):
    """Marks the autograd nodes a torch call from ``models/ssm.py`` adds
    to the graph (those between its outputs and its inputs), so the
    backward pass places their products as the forward did.  The mark
    lives in each node's ``metadata``: holding the nodes here would keep
    a long recurrence's whole graph alive past its backward, and
    releasing it at once overflowed the C stack (xlstm-125m's
    ``train_4k``, 4096 sLSTM steps)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(_TORCH_DIR):
            f = f.f_back
        if f is not None and f.f_code.co_filename.endswith(
                _MODELS + "ssm.py"):
            stop = {x.grad_fn for x in _tensors(args)}
            todo = [x.grad_fn for x in _tensors(out)]
            while todo:
                node = todo.pop()
                if (node is None or node in stop
                        or node.metadata.get(_SSM_MARK)):
                    continue
                node.metadata[_SSM_MARK] = True
                todo.extend(n for n, _ in node.next_functions)
        return out


class OpCost(TorchDispatchMode):
    """Roll-up of one rank's ops while active (see the module's
    docstring).  Use as a context manager around the traced call."""

    def __init__(self, unique_count: Optional[Callable[[int], int]] = None):
        super().__init__()
        self.unique_count = unique_count or (lambda n: n)
        self.flops_by_rate = {"bf16": 0.0, "f32": 0.0, "int8": 0.0,
                              "other": 0.0}
        self.products = {"bf16": 0, "f32": 0, "unplaced": 0}
        self.bytes = 0.0
        self.collectives: list = []
        self.kernels: dict = {}
        self.routes: dict = {}
        self.kernel_bytes = 0.0
        self.weight_bytes = 0.0
        self.ops = 0
        self._mark = _Mark()
        self._live: dict = {}            # storage id -> (ref, bytes, cat)
        self.live = dict.fromkeys(CATEGORIES, 0)
        self.peak = 0
        self.peak_by_category = dict(self.live)
        self._token = None

    # ------------------------------------------------------------ totals
    @property
    def flops(self) -> float:
        return sum(self.flops_by_rate.values())

    def summary(self) -> dict:
        """The roll-up's own counts, beside the wire bytes."""
        return {"flops_by_rate": dict(self.flops_by_rate),
                "products": dict(self.products),
                "kernels": dict(self.kernels), "routes": dict(self.routes),
                "kernel_bytes": self.kernel_bytes,
                "packed_weight_bytes": self.weight_bytes,
                "ops": self.ops}

    def memory_stats(self) -> dict:
        return {"peak_bytes": self.peak,
                "peak_by_category": dict(self.peak_by_category),
                "live_bytes_at_end": sum(self.live.values())}

    # ------------------------------------------------------------ memory
    def register(self, tensors, category: str) -> None:
        """Count the storages of ``tensors`` (any nested container;
        DTensors by their local pieces, packed weights by data and
        scale) as live under ``category`` from now on."""
        if category not in CATEGORIES:
            raise ValueError(f"unknown category {category!r}; expected "
                             f"one of {CATEGORIES}")
        for t in _storages(tensors):
            self._track(t, category)

    def _track(self, t: torch.Tensor, category: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = _block_bytes(st)
        live = self.live

        def gone(_ref, key=key, n=n, category=category, table=self._live):
            if table.pop(key, None) is not None:
                live[category] -= n
        self._live[key] = (weakref.ref(st, gone), n, category)
        live[category] += n
        total = sum(live.values())
        if total > self.peak:
            self.peak = total
            self.peak_by_category = dict(live)

    # ----------------------------------------------------------- kernels
    def add_kernel(self, flops, moved, rate, kernel, route, weight_bytes):
        self.flops_by_rate[rate] += flops
        self.bytes += moved
        self.kernel_bytes += moved
        self.weight_bytes += weight_bytes
        if kernel is not None:
            self.kernels[kernel] = self.kernels.get(kernel, 0) + 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        self._token = _ACTIVE.set(self)
        self._mark.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._mark.__exit__(*exc)
        _ACTIVE.reset(self._token)
        return out

    @staticmethod
    def _site():
        """(site, view): ``site`` the (file, function) of the innermost
        ``repro_torch/models`` frame, None for none, or ``_PROP`` inside
        DTensor's sharding propagation; ``view`` whether the op serves
        ``dist.runtime``'s gathered params view."""
        f = sys._getframe(2)
        site, view = None, False
        while f is not None:
            name = f.f_code.co_filename
            if _SHARDING_PROP in name:
                return _PROP, False
            if site is None and _MODELS in name:
                site = (name.rsplit(_MODELS, 1)[1], f.f_code.co_name)
            elif name.endswith(_RUNTIME) and f.f_code.co_name in _VIEWS:
                view = True
            f = f.f_back
        return site, view

    def _place(self, site, n: int, f32: bool) -> None:
        """A product of ``n`` operations, placed as ``step_ops`` places
        it: by its innermost models frame; in the backward pass by the
        forward's marks; by its dtype (and under ``unplaced``) where
        neither places it; the embedding gradient's left out."""
        if site is None:
            node = torch._C._current_autograd_node()
            if node is not None:
                site = (("ssm.py", "") if node.metadata.get(_SSM_MARK)
                        else ("", ""))
        if site is None:
            self.products["unplaced"] += n
            rate = "f32" if f32 else "bf16"
        elif site == ("layers.py", "embed_grad"):
            return
        else:
            rate = "f32" if f32 and site[0] == "ssm.py" else "bf16"
        self.products[rate] += n
        self.flops_by_rate[rate] += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # counted below DTensor's dispatch
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet is aten._unique2 and _is_fake(args[0]):
            return self._unique(func, args, kwargs)
        out = func(*args, **kwargs)
        if packet in _FREE or func.is_view or func.namespace == "prim":
            return out
        site, view = self._site()
        if site is _PROP:
            return out                 # DTensor's shape inference
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_bytes = sum(map(_nbytes, ins))
        out_bytes = sum(map(_nbytes, outs))
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if func.namespace in ("_c10d_functional", "c10d") and kind:
            size = out_bytes if outs else in_bytes
            if name in ("allreduce_", "allreduce_coalesced_"):
                size = in_bytes
            self.collectives.append((kind, float(size),
                                     _group_size(func, args, kwargs)))
            self.bytes += in_bytes + out_bytes
        elif packet in _PRODUCTS:
            i, ops = _PRODUCTS[packet]
            self.bytes += in_bytes + out_bytes
            self._place(site, ops(args), args[i].dtype == torch.float32)
        elif packet in _ALLOCS or func.namespace == "_c10d_functional":
            pass                       # wait_tensor, allocations
        elif packet in _READS:
            self.bytes += 2 * out_bytes + sum(
                _nbytes(t) for t in ins[1:] if t.dtype in (torch.int64,
                                                           torch.int32))
        elif packet in _WRITES:
            self.bytes += sum(_nbytes(t) for t in ins[1:-1]) \
                + 2 * _nbytes(ins[-1])
        elif packet in _MOVES:
            self.bytes += in_bytes + out_bytes
        else:
            self.bytes += in_bytes + out_bytes
            self.flops_by_rate["other"] += max(
                [t.numel() for t in ins + outs] or [0])
        self._track_outputs(outs, "params" if view else None)
        return out

    def _track_outputs(self, outs, category=None) -> None:
        if category is None:
            category = ("gradients" if torch._C._current_autograd_node()
                        is not None else "temporaries")
        for t in outs:
            self._track(t, category)

    def _unique(self, func, args, kwargs):
        """Fake outputs of ``torch.unique`` (``aten._unique2``):
        ``unique_count(n)`` values."""
        x = args[0]
        n = self.unique_count(x.numel())
        names = [a.name for a in func._schema.arguments]
        given = dict(zip(names, args))
        given.update(kwargs)
        vals = torch.empty((n,), dtype=x.dtype, device=x.device)
        inverse = torch.empty(x.shape if given.get("return_inverse")
                              else (0,), dtype=torch.int64,
                              device=x.device)
        counts = torch.empty((n,) if given.get("return_counts") else (0,),
                             dtype=torch.int64, device=x.device)
        self._track_outputs([vals, inverse, counts])
        return vals, inverse, counts


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor) or (isinstance(x, torch.Tensor)
                                         and x.is_meta)

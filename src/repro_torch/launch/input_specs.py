"""Storage-free stand-ins for every model input, per (arch x shape), as
the reference's ``repro.launch.input_specs``: DTensors of each input's
global shape and dtype, placed on a DeviceMesh through the logical-axis
rules (``dist.sharding``), whose local pieces are fake tensors (under
the caller's ``FakeTensorMode``, else one of their own).  Nothing is
allocated.

``spec_of`` reads a DTensor's placement back as the reference's
``PartitionSpec`` entries (one per dim, trailing replicated dims
trimmed), which the tests hold equal to the reference's.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from ..configs.shapes import ShapeCell
from ..dist import runtime as dist_rt
from ..kernels.ops import PackedTernary
from ..models.config import ParamSpec
from ..models.paged_kv import PagedKVCache
from .. import tree as tree_lib

TRIT2_PER_BYTE = 4
# A fake tensor holds no storage; its device only labels it.  The CPU's
# (a torch built without CUDA cannot index a fake cuda tensor).
DEVICE = "cpu"


@contextlib.contextmanager
def fake_mode():
    """The active ``FakeTensorMode``, or a new one for the block."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    active = torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE)
    if active is not None:
        yield active
        return
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def _spec(shape, dtype, axes, rules, mesh, device):
    with fake_mode():
        return dist_rt.abstract(tuple(shape), tuple(axes), dtype, rules,
                                mesh, device)


def spec_of(x) -> tuple:
    """A DTensor's placement as PartitionSpec entries: per tensor dim
    None, a mesh axis name, or a tuple of them (outermost first), the
    trailing Nones trimmed."""
    names = tuple(x.device_mesh.mesh_dim_names)
    entries: list = [[] for _ in range(x.ndim)]
    for i, p in enumerate(x.placements):
        if p.is_shard():
            entries[p.dim].append(names[i])
    out = [None if not e else (e[0] if len(e) == 1 else tuple(e))
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _extras(cfg, b, rules, mesh, device) -> dict:
    out = {}
    if cfg.family == "audio":
        out["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), cfg.dtype,
                              ("batch", "seq", "act_embed"), rules, mesh,
                              device)
    if cfg.family == "vlm":
        out["patches"] = _spec((b, cfg.encoder_seq, cfg.d_model), cfg.dtype,
                               ("batch", "seq", "act_embed"), rules, mesh,
                               device)
    return out


def train_batch_specs(cfg, cell: ShapeCell, rules, mesh,
                      device=DEVICE) -> dict:
    b, s = cell.global_batch, cell.seq_len
    return {"tokens": _spec((b, s), torch.int32, ("batch", "seq"), rules,
                            mesh, device),
            "labels": _spec((b, s), torch.int32, ("batch", "seq"), rules,
                            mesh, device),
            **_extras(cfg, b, rules, mesh, device)}


def prefill_batch_specs(cfg, cell: ShapeCell, rules, mesh,
                        device=DEVICE) -> dict:
    b, s = cell.global_batch, cell.seq_len
    return {"tokens": _spec((b, s), torch.int32, ("batch", "seq"), rules,
                            mesh, device),
            **_extras(cfg, b, rules, mesh, device)}


def decode_token_spec(cell: ShapeCell, rules, mesh, device=DEVICE):
    return _spec((cell.global_batch, 1), torch.int32, ("batch", "none"),
                 rules, mesh, device)


def decode_loop_specs(cell: ShapeCell, rules, mesh, device=DEVICE):
    """The decode loop's inputs beyond params and state: the prefill's
    sampled token and the per-row max-new and EOS vectors, each (B,)
    int32, batch-sharded like the decode token."""
    b = cell.global_batch
    return tuple(_spec((b,), torch.int32, ("batch",), rules, mesh, device)
                 for _ in range(3))


def packable(d: ParamSpec) -> bool:
    """The reference's dry-run eligibility of a weight for packing: a
    normal-initialised leaf of the model's dtype with two trailing dims
    of 256 or more, not the embedding table (routers, whose dtype is
    pinned to f32, stay float)."""
    return (d.init == "normal" and len(d.shape) >= 2
            and min(d.shape[-2:]) >= 256 and d.axes[0] != "vocab"
            and d.dtype is None)


def abstract_model_params(model, rules, mesh, packed: str | None = None,
                          device=DEVICE) -> dict:
    """Params as storage-free DTensors on ``mesh``.  ``packed='base3' |
    'trit2'`` makes every :func:`packable` weight an abstract
    ``PackedTernary``: uint8 data of the leaf's axes ((K, N) base3, (K/4,
    N) trit2) and f32 per-column scales of ``axes[:-2] + (axes[-1],)``,
    as ``dist.runtime.place_leaf`` places a packed leaf."""
    dtype = model.cfg.dtype

    def leaf(d: ParamSpec):
        if packed is None or not packable(d):
            return _spec(d.shape, d.dtype or dtype, d.axes, rules, mesh,
                         device)
        k, n = d.shape[-2], d.shape[-1]
        lead = tuple(d.shape[:-2])
        rows = -(-k // TRIT2_PER_BYTE) if packed == "trit2" else k
        daxes, saxes = dist_rt.packed_axes(d.axes)
        return PackedTernary(
            _spec(lead + (rows, n), torch.uint8, daxes, rules, mesh, device),
            _spec(lead + (n,), torch.float32, saxes, rules, mesh, device),
            packed)
    return tree_lib.map_specs(leaf, model.param_specs)


def abstract_cache(model, cell: ShapeCell, rules, mesh,
                   device=DEVICE) -> dict:
    """The decode state's leaves (KV caches, SSM states) placed by their
    cache axes.  The port's engines hold a decode state rank-local (each
    rank's rows at every position, ``dist.runtime``): the dry run traces
    that one; these are the reference's placements."""
    specs = model.cache_specs(cell.global_batch, cell.seq_len)
    out = {k: _spec(d.shape, d.dtype or model.cfg.dtype, d.axes, rules,
                    mesh, device) for k, d in specs.items()}
    # the reference's 0-d position leaf (a host int in the port's state)
    out["pos"] = _spec((), torch.int32, (), rules, mesh, device)
    return out


def slot_pool_specs(model, cell: ShapeCell, rules, mesh, slots: int,
                    device=DEVICE):
    """The slot pool's inputs beyond params: the pooled decode state
    (per-slot batch-1 states stacked on a leading 'slot' axis) and the
    per-slot control lanes (tok, live, made, fresh, max_new, eos)."""
    specs = model.cache_specs(1, cell.seq_len)
    pool = {k: _spec((slots,) + tuple(d.shape), d.dtype or model.cfg.dtype,
                     ("slot",) + tuple(d.axes), rules, mesh, device)
            for k, d in specs.items()}
    pool["pos"] = _spec((slots,), torch.int32, ("slot",), rules, mesh,
                        device)
    lane = lambda dt: _spec((slots,), dt, ("slot",), rules, mesh, device)
    return (pool, lane(torch.int32), lane(torch.bool), lane(torch.int32),
            lane(torch.bool), lane(torch.int32), lane(torch.int32))


def paged_pool_specs(model, cell: ShapeCell, rules, mesh, slots: int,
                     page_size: int, num_pages: int, device=DEVICE):
    """The paged pool's inputs beyond params: the KV block pool (a
    ``PagedKVCache``, pages on a leading 'page' axis), the per-slot page
    tables, and the lanes (pos, tok, live, made, fresh, max_new, eos)."""
    cfg = model.cfg
    n_layers, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    int8 = cfg.kv_cache_dtype == "int8"
    kvdt = torch.int8 if int8 else cfg.dtype
    pshape = (n_layers, num_pages, page_size, kv, hd)
    paxes = ("layers", "page", "none", "kv", "none")
    scales = ([_spec(pshape[:-1], torch.float32, paxes[:-1], rules, mesh,
                     device) for _ in range(2)] if int8 else [None, None])
    pool = PagedKVCache(_spec(pshape, kvdt, paxes, rules, mesh, device),
                        _spec(pshape, kvdt, paxes, rules, mesh, device),
                        *scales)
    pages_per_slot = -(-cell.seq_len // page_size)
    table = _spec((slots, pages_per_slot), torch.int32, ("slot", "none"),
                  rules, mesh, device)
    lane = lambda dt: _spec((slots,), dt, ("slot",), rules, mesh, device)
    return (pool, table, lane(torch.int32), lane(torch.int32),
            lane(torch.bool), lane(torch.int32), lane(torch.bool),
            lane(torch.int32), lane(torch.int32))


def global_tensor(x) -> Any:
    """A fake plain tensor of a DTensor's global shape and dtype (the
    whole batch, which every rank of the port draws and cuts)."""
    with fake_mode():
        return torch.empty(tuple(x.shape), dtype=x.dtype,
                           device=x.to_local().device)

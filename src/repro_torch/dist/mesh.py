"""Device-mesh specifications and construction, as the reference's
``repro.dist.mesh``.

A ``MeshSpec`` is a declarative mesh (shape + axis names) that can be
reasoned about without any process group: the ``shard`` analysis pass
and the sharding tests resolve rules against specs long before a card
exists.  ``make_mesh`` turns a spec into a ``torch.distributed``
``DeviceMesh`` over an initialised process group; ``init_process_group``
starts that group (NCCL on the cards, gloo on the CPU for tests), and
``init_fake_process_group`` a fake one of any size, whose collectives
move nothing (the dry run's).

Axis conventions (shared with dist.sharding):

  pod    - outermost data-parallel axis
  data   - data-parallel / FSDP axis
  model  - tensor-parallel axis (heads / mlp / vocab / experts)
"""
from __future__ import annotations

import datetime
import math
import os
from typing import NamedTuple, Optional

import torch

# Axes over which the global batch is folded (outermost first).
DP_AXES = ("pod", "data")

# the backend each device type runs its collectives on
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class MeshSpec(NamedTuple):
    """Shape + axis names; construction-free mesh description."""
    shape: tuple
    axes: tuple

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def dp_axes(self) -> tuple:
        """The data-parallel axes this mesh actually has."""
        return tuple(a for a in self.axes if a in DP_AXES)

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axes, self.shape))


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


def _pow2_factor(n: int, cap: int) -> int:
    """Largest power-of-two divisor of n, capped at `cap`."""
    f = 1
    while n % (f * 2) == 0 and f * 2 <= cap:
        f *= 2
    return f


def spec_for(n: int, *, multi_pod: bool = False) -> MeshSpec:
    """A MeshSpec for exactly `n` devices.

    The model (TP) axis takes the largest power-of-two factor of n (up to
    16); the data axis absorbs the rest, so non-power-of-two device
    counts still give a valid mesh.  `multi_pod` peels a pod axis of 2
    off first when n is even.
    """
    if n <= 0:
        raise ValueError(f"device count must be positive, got {n}")
    if multi_pod:
        pod = 2 if n % 2 == 0 else 1
        rest = n // pod
        model = _pow2_factor(rest, 16)
        return MeshSpec((pod, rest // model, model),
                        ("pod", "data", "model"))
    model = _pow2_factor(n, 16)
    return MeshSpec((n // model, model), ("data", "model"))


def init_process_group(device_type: str = "cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout_s: float = 300.0) -> None:
    """Start the default process group for ``device_type`` (its backend
    from ``BACKENDS``): one rank on ``tcp://localhost`` at a free port
    when nothing is given, or ``world_size`` ranks on ``init_method``
    (a ``file://`` store in the CPU tests).  Asking for ``cuda`` without
    a card raises: the mesh never moves to the CPU by itself.  A no-op
    when a group is already up."""
    import torch.distributed as dist
    if device_type not in BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}; expected "
                         f"one of {sorted(BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh was requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device_type='cpu' for a gloo mesh")
    if dist.is_initialized():
        return
    rank = 0 if rank is None else rank
    world_size = 1 if world_size is None else world_size
    if init_method is None:
        if world_size != 1:
            raise ValueError("more than one rank needs an init_method")
        init_method = f"tcp://localhost:{_free_port()}"
    kw = {}
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda",
                                       rank % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def init_fake_process_group(world_size: int) -> None:
    """Start a fake default group of ``world_size`` ranks, this process
    rank 0 (``torch.distributed``'s ``fake`` backend on a ``FakeStore``):
    its collectives return at once and move nothing, so one process can
    trace what a rank of a production mesh runs (``launch/dryrun.py``).
    Raises when a group is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; destroy it "
                           "before starting a fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_process_group() -> None:
    """Tear the default group down (a no-op when none is up), with the
    host group made beside it."""
    import torch.distributed as dist
    _HOST_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


_HOST_GROUPS: dict = {}


def host_group(mesh):
    """A process group for the host schedulers' agreement on their
    clock: the world on gloo, a gloo group beside an NCCL world, made
    once per world (None when the mesh has one rank)."""
    import torch.distributed as dist
    if mesh.size() == 1:
        return None
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if world not in _HOST_GROUPS:
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def agree_max(value: float, group) -> float:
    """The largest of every rank's host ``value`` (a host collective on
    ``group``, no device sync); ``value`` itself without a group."""
    import torch.distributed as dist
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t[0])


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``spec``'s shape and axis names over the
    initialised process group, whose world size must be
    ``spec.num_devices``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "dist.mesh.init_process_group first")
    if dist.get_world_size() != spec.num_devices:
        raise ValueError(f"mesh {spec.shape} needs {spec.num_devices} "
                         f"ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(spec.shape),
                            mesh_dim_names=tuple(spec.axes))


def axis_sizes(mesh) -> dict:
    """{axis name: size} for a DeviceMesh, a MeshSpec, or any duck-typed
    object with .axis_names + .devices (the tests' FakeMesh)."""
    if isinstance(mesh, MeshSpec):
        return mesh.axis_sizes
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))

"""Production meshes for the dry run, as the reference's
``repro.launch.mesh``: the 16x16 single pod (256 cards) or the 2x16x16
multi-pod (512) over a fake process group of that many ranks
(``dist.mesh.init_fake_process_group``), this process its rank 0.
Functions, not module-level constants: importing this module starts no
group."""
from __future__ import annotations

from ..dist import mesh as mesh_lib


def fake_mesh(spec: mesh_lib.MeshSpec):
    """A ``DeviceMesh`` of ``spec`` over a fake group of its size, which
    this call starts when no group is up."""
    import torch.distributed as dist
    if not dist.is_initialized():
        mesh_lib.init_fake_process_group(spec.num_devices)
    return mesh_lib.make_mesh(spec, "cpu")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 cards) or 2x16x16 multi-pod (512 cards)."""
    return fake_mesh(mesh_lib.MULTI_POD if multi_pod
                     else mesh_lib.SINGLE_POD)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.mesh.shape))

"""PyTorch + CUDA port of the packed-ternary serving path.

The JAX package ``repro`` is the reference this package is held against;
this package imports neither ``repro`` nor ``jax``.  Entry points run on
``cuda`` unless the caller asks for ``device="cpu"``; on a CPU tensor a
kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches the hand-written kernel (``csrc/``) or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA without a
    card raises: there is no silent switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions")
    return dev

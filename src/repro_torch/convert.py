"""Carry the reference package's parameters across into this port.

The reference keeps its parameters as a nested dict whose packed leaves
are ``PackedTernary`` objects (``data``, ``scale``, ``mode``).  Given that
tree with every array turned into numpy (``jax.tree.map(np.asarray,
params)`` keeps the packed objects and converts their arrays), this
module returns the port's params dict: float arrays become tensors of
the same dtype, and packed bytes and scales are copied as they are.
Nothing here imports the reference: a packed leaf is recognised by its
attributes.  ``state_from_reference`` carries a whole training state
(``repro.train.TrainState`` as numpy) across the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device
from .kernels.ops import PackedTernary


def to_tensor(a: Any, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) -> tensor of
    the same dtype and values on `device` (``cuda`` unless the caller
    asks for ``cpu``)."""
    device = resolve_device(device)
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_packed(x: Any) -> bool:
    # numpy arrays have a ``data`` attribute too (and reading it raises
    # for bfloat16), so they are ruled out first
    return not isinstance(x, np.ndarray) and hasattr(x, "mode")


def params_from_reference(tree: Any, device="cuda") -> Any:
    """The reference's (numpy) params tree -> the port's params dict on
    `device` (``cuda`` unless the caller asks for ``cpu``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if _is_packed(tree):
        return PackedTernary(to_tensor(tree.data, device),
                             to_tensor(tree.scale, device), tree.mode)
    return to_tensor(tree, device)


def state_from_reference(state: Any, device="cuda"):
    """The reference's ``TrainState`` (``jax.tree.map(np.asarray,
    state)``: params, optimizer state, the int32 step, the error-feedback
    residual or None) -> the port's ``TrainState`` on `device`."""
    from .train.step import TrainState
    device = resolve_device(device)
    return TrainState(
        params_from_reference(state.params, device),
        params_from_reference(state.opt_state, device),
        to_tensor(np.asarray(state.step, dtype=np.int32), device),
        None if state.ef_residual is None
        else params_from_reference(state.ef_residual, device))

"""The training step: loss -> grads -> (compressed) sync -> update, as
the reference's ``repro.train.step``.

* **Microbatches** accumulate the gradients in f32 zeros, then scale
  them by ``1 / microbatches`` (the optimizer then sees f32 grads; with
  one microbatch it sees them in the params' dtype, as in the
  reference).
* **In place.** The optimizer updates the params and its state in place
  under ``torch.no_grad()``: the counterpart of the reference's donated
  jit, so params and optimizer state are held once.  The returned
  ``TrainState`` holds the same tensors and a new step counter.
* **Gradients** are taken with respect to detached aliases of the params
  (sharing their storage), so the params stay plain tensors.
* **Compression** follows the reference's gate: with ``compress_grads``
  and a mesh the grads go through ``int8_allgather_sync`` (error
  feedback on one card; a mesh axis of more devices raises), without a
  mesh nothing is compressed.
* **Ternary mode cannot train.** The ternary matmul kernels have no
  backward (the CUDA extension call carries no autograd formula, so
  every gradient before it would silently be missing); the reference's
  ``jax.grad`` raises in ``_pallas_call_jvp_rule`` for its Pallas kernel
  (``src/repro/kernels/ternary_matmul.py:184``).  ``make_train_step``
  refuses a ternary config at construction and a ``PackedTernary`` leaf
  before the step runs.  Exact mode trains, as in the reference: its
  gradient reaches the weights and the activations only through the
  quantization scales (the MAC's integer codes carry none).

The metrics are ``{loss, grad_norm, lr}``, 0-d tensors on the device.
``make_abstract_state`` and the sharded ``jit_train_step`` are XLA and
mesh tooling (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from .. import resolve_device, tree
from ..kernels.ops import PackedTernary
from ..optim import Optimizer, ef_init, int8_allgather_sync

TERNARY_REFUSAL = (
    "mode='ternary' cannot be trained: the ternary_matmul kernels have no "
    "backward, so every gradient before them would be missing (the "
    "reference's jax.grad raises in _pallas_call_jvp_rule for its Pallas "
    "ternary_matmul); train in float or exact mode")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor              # 0-d int32, on the params' device
    ef_residual: Any = None         # error-feedback buffers (optional)


def init_state(model, optimizer: Optimizer, generator: torch.Generator,
               device="cuda", dtype=None,
               error_feedback: bool = False) -> TrainState:
    device = resolve_device(device)
    params = model.init(generator, device, dtype)
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device),
                      ef_init(params) if error_feedback else None)


def refuse_ternary(cim=None, params=None) -> None:
    """Raise if the config is ternary or a params leaf is packed."""
    if cim is not None and cim.mode == "ternary":
        raise ValueError(TERNARY_REFUSAL)
    if params is not None:
        packed = ["/".join(path) for path, leaf in
                  tree.flatten_with_path(params)
                  if isinstance(leaf, PackedTernary)]
        if packed:
            raise ValueError(f"{TERNARY_REFUSAL} (packed leaves: "
                             f"{', '.join(packed[:4])}"
                             f"{' ...' if len(packed) > 4 else ''})")


def value_and_grad(model, params, batch, cim=None):
    """(loss, grads): the loss of ``batch`` and its gradient with respect
    to every leaf of ``params`` (same tree), taken through detached
    aliases that share the params' storage."""
    flat = tree.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    # the CIM plan request, resolved for the device the params are on
    plan = None if cim is None else cim.resolve(flat[0].device.type)
    with torch.enable_grad():
        loss = model.loss(tree.unflatten_like(params, live), batch,
                          cim=plan)
        # a leaf the loss does not reach gets zeros, as in jax.grad
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree.unflatten_like(params, grads)


def make_train_step(model, optimizer: Optimizer, cim=None,
                    microbatches: int = 1,
                    mesh: Optional[Mapping[str, int]] = None,
                    compress_grads: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves have a leading dim of the global batch, which
    ``microbatches`` must divide.  ``mesh`` maps axis names to sizes
    (``{"data": 1}`` is one card)."""
    refuse_ternary(cim)

    def compute_grads(params, batch):
        if microbatches <= 1:
            return value_and_grad(model, params, batch, cim)
        acc = tree.map_leaves(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        loss_acc = None
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, -1) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, grads = value_and_grad(model, params, mb, cim)
            tree.map_leaves(lambda a, g: a.add_(g.to(a.dtype)), acc, grads)
            loss_acc = loss if loss_acc is None else loss_acc + loss
        inv = 1.0 / microbatches
        tree.map_leaves(lambda a: a.mul_(inv), acc)
        return loss_acc * inv, acc

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        refuse_ternary(params=state.params)
        loss, grads = compute_grads(state.params, batch)
        residual = state.ef_residual
        if compress_grads and mesh is not None:
            grads, residual = int8_allgather_sync(
                grads, mesh, axes=("pod", "data"), residual=residual)
        params, opt_state, om = optimizer.update(
            grads, state.opt_state, state.params, state.step)
        return (TrainState(params, opt_state, state.step + 1, residual),
                {"loss": loss, **om})

    return train_step

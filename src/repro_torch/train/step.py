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
  and a mesh the grads go through ``int8_allgather_sync`` over
  ``("pod", "data")``, without a mesh nothing is compressed.
* **On a DeviceMesh** (``rules=``, ``mesh=``; ``dist.runtime``) the
  params and the optimizer state are DTensors placed by the train rules
  (:func:`place_state`); each step cuts this rank's rows of the global
  batch (``("batch", "none", ...)``), gathers every param whole on every
  rank before the forward (``param_view``), takes this rank's whole
  gradient with the unmeshed code, averages it over the DP shards into
  each leaf's placement (a reduce-scatter, or the int8 all-gather with
  ``compress_grads``), and updates each rank's pieces in place.  The
  forward and backward run inside ``dist.runtime.row_block``: what
  couples rows across ranks sees the whole call through collectives
  that carry gradients (the exact mode's per-call input amax, the MoE
  router's groups and aux loss, the cross-entropy's label count), so
  every family, Adafactor and exact mode train as unmeshed.  This is
  not FSDP or tensor parallelism: the mesh shards the state at rest
  only (like ZeRO-1), each rank's peak holds the whole params and
  gradients besides its shards, so no model that misses one card trains
  this way, and the ranks along ``model`` compute the same rows with
  the same weights (redundant compute).  Per-layer gathers and real TP
  of the float matmuls are ROADMAP queue 1 item 8.  The loss is the
  mean of the ranks' losses.  On a one-card mesh nothing moves and the
  step is the unmeshed step, op for op.
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
``make_abstract_state`` gives the state's placements as meta DTensors
(nothing is allocated); the reference's ``jit_train_step`` is XLA
tooling with no counterpart.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import resolve_device, tree
from ..dist import runtime as dist_rt
from ..dist import sharding as shd
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


def make_abstract_state(model, optimizer: Optimizer, rules, mesh,
                        dtype=None, device="meta") -> TrainState:
    """The state's placements on ``mesh`` under ``rules``: params and
    optimizer state as storage-free DTensors of each leaf's global
    shape, dtype and placements, built from the ParamSpecs alone (meta
    pieces, or fake ones on ``device`` under a ``FakeTensorMode``: the
    dry run's)."""
    specs = model.param_specs
    params = dist_rt.placement_tree(specs, rules, mesh,
                                    dtype or model.cfg.dtype, device)
    opt = dist_rt.placement_tree(optimizer.state_defs(specs), rules, mesh,
                                 device=device)
    return TrainState(params, opt,
                      torch.empty((), dtype=torch.int32, device=device))


def place_state(state: TrainState, model, optimizer: Optimizer, rules,
                mesh) -> TrainState:
    """A state held whole on every rank (the same on each) placed on
    ``mesh``: params and optimizer state by their specs' axes, each rank
    keeping its pieces.  The step counter and the error-feedback
    residuals (each rank's own) stay plain tensors."""
    specs = model.param_specs
    return TrainState(
        dist_rt.place_tree(state.params, specs, rules, mesh),
        dist_rt.place_tree(state.opt_state, optimizer.state_defs(specs),
                           rules, mesh),
        state.step, state.ef_residual)


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


def _local_rows(x: torch.Tensor, split, microbatches: int) -> torch.Tensor:
    """This rank's rows of the global batch ``x``: its block of each
    global microbatch, in microbatch order, so that the rank's i-th
    microbatch holds its rows of the unmeshed step's i-th (the calls
    whose rows couple, the MoE groups and the exact scale, are then the
    unmeshed ones).  With one microbatch, its block of the batch."""
    if split is None or microbatches <= 1:
        return dist_rt.shard_rows(x, split)
    parts = x.reshape((microbatches, -1) + tuple(x.shape[1:]))
    return torch.cat([dist_rt.shard_rows(m, split) for m in parts])


def make_train_step(model, optimizer: Optimizer, cim=None,
                    microbatches: int = 1, rules=None, mesh=None,
                    compress_grads: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves have a leading dim of the global batch, which
    ``microbatches`` must divide (each rank's rows, on a mesh).
    ``mesh`` is a DeviceMesh (``rules`` default to the model's train
    rules; the state must be placed, :func:`place_state`), or a mapping
    of axis names to sizes (``{"data": 1}`` is one card)."""
    refuse_ternary(cim)
    meshed = dist_rt.is_mesh(mesh)
    if meshed:
        dist_rt.check_mesh_request(model, cim, "training")
        rules = rules or shd.rules_for(model.cfg, "train")

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

    def meshed_grads(state: TrainState, batch):
        """(mean loss, grads placed as the params, new residual)."""
        split = dist_rt.batch_split(rules, mesh,
                                    next(iter(batch.values())).shape[0])
        local = {k: _local_rows(v, split, microbatches)
                 for k, v in batch.items()}
        with shd.activation_context(rules, mesh), dist_rt.row_block(split):
            loss, grads = compute_grads(dist_rt.param_view(state.params),
                                        local)
        residual = state.ef_residual
        if compress_grads:
            grads, residual = int8_allgather_sync(
                grads, mesh, axes=("pod", "data"), residual=residual)
            grads = tree.map_leaves(dist_rt.distribute_like, grads,
                                    state.params)
        else:
            grads = dist_rt.reduce_grads(grads, state.params, mesh, split)
        return dist_rt.mean_over_rows(loss, split), grads, residual

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        refuse_ternary(params=state.params)
        if meshed:
            loss, grads, residual = meshed_grads(state, batch)
        else:
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

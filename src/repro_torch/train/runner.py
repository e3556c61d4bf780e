"""The fault-tolerant training runner, as the reference's
``repro.train.runner``.

* **checkpoint/restart**: atomic periodic checkpoints
  (``repro_torch.checkpoint``); on a failure the runner rolls back to the
  latest complete checkpoint and replays.  The data pipeline is a
  function of the step, and the step is deterministic on either device
  (``layers.embed``'s gradient sums without atomics), so the replay is
  bitwise identical.
* **failure injection**: a ``FailurePlan`` schedules simulated crashes
  before an update and in the middle of a checkpoint save; the runner
  treats them as a preemption: tear down, restore, continue.
* **straggler tracking**: per-step wall time in a rolling window; steps
  slower than ``straggler_factor`` times the median are counted, and
  every ``straggler_patience`` of them the mitigation hook fires.

A checkpoint found in ``ckpt_dir`` wins over a fresh ``init`` (drawn
from a ``torch.Generator`` seeded with ``seed``), as in the reference:
a checkpoint the reference wrote starts the port from the same state.
The step counter stays on the device; the runner keeps the host's copy
and moves each step's three metrics to the host in one transfer.

On a DeviceMesh (``rules=``, ``mesh=``) the fresh state is drawn whole
on every rank from the same seed and placed (``step.place_state``), a
checkpoint is restored straight onto the mesh's placements
(``checkpoint.restore(placements=)``), and a save gathers the leaves and
the first rank writes: a checkpoint of one mesh restarts on another.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch

from .. import checkpoint as ckpt_lib
from .. import resolve_device, tree
from ..data import DataConfig, batch_for
from ..optim import Optimizer
from ..dist import runtime as dist_rt
from ..dist import sharding as shd
from .step import (TrainState, init_state, make_abstract_state,
                   make_train_step, place_state)

METRICS = ("loss", "grad_norm", "lr")


class SimulatedFailure(RuntimeError):
    """Raised by the failure injector to emulate a node crash."""


@dataclasses.dataclass
class FailurePlan:
    """crash_at: steps that die before the update is applied;
    crash_in_save: steps whose checkpoint save dies halfway through."""
    crash_at: tuple = ()
    crash_in_save: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.crash_at and ("c", step) not in self._fired:
            self._fired.add(("c", step))
            raise SimulatedFailure(f"injected crash at step {step}")

    def save_hook(self, step: int) -> Optional[int]:
        if step in self.crash_in_save and ("s", step) not in self._fired:
            self._fired.add(("s", step))
            return 1           # fail after writing 1 leaf file
        return None


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_interval: int = 20
    ckpt_keep: int = 3
    log_interval: int = 10
    microbatches: int = 1
    straggler_factor: float = 3.0
    straggler_window: int = 20
    straggler_patience: int = 3
    seed: int = 0
    error_feedback: bool = False


class Trainer:
    def __init__(self, model, optimizer: Optimizer, data_cfg: DataConfig,
                 cfg: TrainerConfig, cim=None, rules=None, mesh=None,
                 failure_plan: Optional[FailurePlan] = None,
                 step_time_fn: Optional[Callable] = None, device="cuda"):
        self.model = model
        self.optimizer = optimizer
        self.data_cfg = data_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.failure_plan = failure_plan or FailurePlan()
        self.step_time_fn = step_time_fn        # test hook: fake durations
        self.manager = ckpt_lib.CheckpointManager(
            cfg.ckpt_dir, cfg.ckpt_interval, cfg.ckpt_keep)
        self.mesh = mesh if dist_rt.is_mesh(mesh) else None
        if self.mesh is not None:
            rules = rules or shd.rules_for(model.cfg, "train")
        self.rules = rules
        self._step_fn = make_train_step(model, optimizer, cim=cim,
                                        microbatches=cfg.microbatches,
                                        rules=rules, mesh=mesh)
        self.history: list[dict] = []
        self.restarts = 0
        self.straggler_events = 0
        self.mitigations = 0
        self._durations: list[float] = []

    # ------------------------------------------------------------------
    def _fresh_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        state = init_state(self.model, self.optimizer, gen, self.device,
                           error_feedback=self.cfg.error_feedback)
        if self.mesh is None:
            return state
        return place_state(state, self.model, self.optimizer, self.rules,
                           self.mesh)

    def _target(self) -> TrainState:
        """The state's structure, for restore (nothing is allocated)."""
        skeleton = lambda specs: tree.map_specs(lambda _: 0, specs)
        params = skeleton(self.model.param_specs)
        return TrainState(params,
                          skeleton(self.optimizer.state_defs(
                              self.model.param_specs)), 0,
                          params if self.cfg.error_feedback else None)

    def _restore_or_init(self) -> TrainState:
        target = self._target()
        placements = None
        if self.mesh is not None:
            placements = make_abstract_state(
                self.model, self.optimizer, self.rules,
                self.mesh)._replace(ef_residual=target.ef_residual)
        got = self.manager.restore_or_none(target=target,
                                           device=self.device,
                                           placements=placements)
        if got is None:
            return self._fresh_state()
        return got[0]

    def _save(self, state: TrainState, step: int, force: bool = False):
        fail = self.failure_plan.save_hook(step)
        if fail is not None:
            # crash mid-save: the atomic writer leaves only .tmp wreckage
            try:
                ckpt_lib.save(self.cfg.ckpt_dir, step, state,
                              _fail_after_files=fail)
            finally:
                raise SimulatedFailure(f"crash during save at step {step}")
        self.manager.maybe_save(step, state, force=force)

    def _track_straggler(self, dt: float) -> bool:
        self._durations.append(dt)
        win = self._durations[-self.cfg.straggler_window:]
        if len(win) < 5:
            return False
        med = statistics.median(win[:-1])
        if dt > self.cfg.straggler_factor * max(med, 1e-9):
            self.straggler_events += 1
            if self.straggler_events % self.cfg.straggler_patience == 0:
                self.mitigations += 1       # re-shard / reissue hook
            return True
        return False

    # ------------------------------------------------------------------
    def run(self) -> TrainState:
        """Run to total_steps, surviving every injected failure."""
        state = self._restore_or_init()
        while int(state.step) < self.cfg.total_steps:
            try:
                state = self._run_segment(state)
            except SimulatedFailure:
                self.restarts += 1
                state = self._restore_or_init()
        self._save(state, int(state.step), force=True)
        return state

    def _run_segment(self, state: TrainState) -> TrainState:
        step = int(state.step)
        while step < self.cfg.total_steps:
            self.failure_plan.check(step)
            batch = batch_for(self.model.cfg, self.data_cfg, step,
                              device=self.device)
            t0 = time.monotonic()
            state, metrics = self._step_fn(state, batch)
            values = torch.stack([metrics[k].to(torch.float32)
                                  for k in METRICS]).tolist()
            dt = (self.step_time_fn(step) if self.step_time_fn
                  else time.monotonic() - t0)
            record = dict(zip(METRICS, values))
            record["step"] = step
            record["straggler"] = self._track_straggler(dt)
            self.history.append(record)
            step += 1
            self._save(state, step)
        return state

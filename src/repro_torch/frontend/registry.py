"""Model registry: several architectures behind one submit path.

Each registered :class:`ModelSpec` names an architecture of
``repro_torch.configs`` and owns its own scheduler pool (slots, chunk
size, KV capacity), while ``FrontendServer.submit(model=...)`` is the
single entry point.

Building is lazy: registering a spec is free; the model is built, its
parameters made and its scheduler allocated the first time a request
targets it (:meth:`ModelRegistry.entry`).  ``capacity_report`` sums up
every registered model, built or not.

The pools serve float weights (no ``cim``), as the reference's
front-end does: a ``paged`` spec builds a :class:`PagedScheduler` whose
decode reads the page pool through the resolved attention plan
(``fused_attn='auto'``: the ``paged_attn`` kernel on the card, its plain
version on the CPU; a card whose fused read cannot resolve raises), a
``dense`` spec a :class:`Scheduler`.

The registry runs on ``cuda`` unless it is given ``device="cpu"``.
Parameters come from a seeded ``torch.Generator`` on that device;
``params_fn(spec, cfg, model)``, when given, makes them instead (the
parity tests carry the reference's parameters across through it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One servable model: an architecture name and its pool geometry.
    ``capacity`` bounds one request's prompt plus decode budget (a
    request over it is rejected at submit with ``over-capacity``, never
    mid-decode).  ``overrides`` is a tuple of ``(field, value)`` pairs
    applied to the resolved ModelConfig (hashable, so specs stay
    frozen); ``dtype`` names a torch dtype (``float32`` by default)."""

    name: str
    arch: str
    smoke: bool = True               # configs.smoke vs configs.get
    kind: str = "paged"              # 'paged' | 'dense' scheduler pool
    capacity: int = 64
    slots: int = 4
    chunk: int = 4
    page_size: int = 16
    num_pages: Optional[int] = None
    seed: int = 0
    dtype: str = "float32"
    overrides: tuple = ()


@dataclasses.dataclass
class ModelEntry:
    """A built model: config, model, parameters and scheduler."""

    spec: ModelSpec
    cfg: object
    model: object
    params: object
    scheduler: object


def param_count(model) -> int:
    """Parameters of a built model, from its parameter specs."""
    def walk(tree):
        return sum(walk(v) if isinstance(v, dict) else math.prod(v.shape)
                   for v in tree.values())
    return walk(model.param_specs)


class ModelRegistry:
    """Named :class:`ModelSpec`s with lazy scheduler instantiation."""

    def __init__(self, device="cuda",
                 params_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        self._params_fn = params_fn
        self._specs: dict[str, ModelSpec] = {}
        self._entries: dict[str, ModelEntry] = {}
        self._cfgs: dict[str, object] = {}

    def register(self, spec: ModelSpec) -> None:
        if spec.name in self._specs:
            raise ValueError(f"model {spec.name!r} already registered")
        if spec.kind not in ("paged", "dense"):
            raise ValueError(f"model {spec.name!r}: kind must be "
                             f"'paged' or 'dense', got {spec.kind!r}")
        self._specs[spec.name] = spec

    def names(self) -> list[str]:
        return sorted(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def spec(self, name: str) -> ModelSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{self.names()}") from None

    def is_instantiated(self, name: str) -> bool:
        return name in self._entries

    def config(self, name: str):
        """The resolved ModelConfig of a registered model (no weights);
        cached, so the submit path's vocab lookups resolve it once."""
        if name not in self._cfgs:
            from .. import configs
            spec = self.spec(name)
            cfg = (configs.smoke(spec.arch) if spec.smoke
                   else configs.get(spec.arch))
            fields = dict(spec.overrides)
            fields.setdefault("dtype", getattr(torch, spec.dtype))
            self._cfgs[name] = dataclasses.replace(cfg, **fields)
        return self._cfgs[name]

    def entry(self, name: str) -> ModelEntry:
        """The live scheduler of a model, built on first use."""
        if name not in self._entries:
            from ..models import registry as model_registry
            from ..serve import PagedScheduler, Scheduler
            spec = self.spec(name)
            cfg = self.config(name)
            model = model_registry.build(cfg)
            if self._params_fn is not None:
                params = self._params_fn(spec, cfg, model)
            else:
                gen = torch.Generator(self.device).manual_seed(spec.seed)
                params = model.init(gen, device=self.device)
            if spec.kind == "paged":
                sched = PagedScheduler(
                    model, params, capacity=spec.capacity,
                    slots=spec.slots, chunk=spec.chunk,
                    page_size=spec.page_size, num_pages=spec.num_pages,
                    fused_attn="auto", device=self.device)
            else:
                sched = Scheduler(model, params, capacity=spec.capacity,
                                  slots=spec.slots, chunk=spec.chunk,
                                  device=self.device)
            self._entries[name] = ModelEntry(
                spec=spec, cfg=cfg, model=model, params=params,
                scheduler=sched)
        return self._entries[name]

    def capacity_report(self) -> dict:
        """Per-model capacity summary: every registered model, built or
        not; a live pool adds its accounting."""
        report = {}
        for name in self.names():
            spec = self._specs[name]
            row = {"arch": spec.arch, "kind": spec.kind,
                   "slots": spec.slots, "chunk": spec.chunk,
                   "capacity": spec.capacity,
                   "instantiated": name in self._entries}
            if name in self._entries:
                ent = self._entries[name]
                sched = ent.scheduler
                row.update(
                    family=ent.cfg.family,
                    params_m=round(param_count(ent.model) / 1e6, 2),
                    vocab_size=ent.cfg.vocab_size,
                    kv_bytes_pool=sched.kv_bytes(),
                    host_transfers=sched.host_transfers,
                    chunks=sched.chunks_run)
                if spec.kind == "paged":
                    row.update(page_size=sched.page_size,
                               num_pages=sched.num_pages,
                               pages_in_use=sched.pages_in_use)
            report[name] = row
        return report

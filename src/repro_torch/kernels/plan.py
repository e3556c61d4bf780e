"""Capability-based execution planning for the ternary matmul.

Every packed matmul resolves once into a frozen, hashable
:class:`ExecutionPlan` (what to compute, and which backend computes it)
and runs through :func:`execute`.  Backends declare their capabilities
in a :class:`BackendSpec`; ``backend='auto'`` picks the highest-priority
backend that supports the request on the operand's platform, and an
explicit backend that lacks a capability raises.

The platform is the operand's device type (``cpu`` or ``cuda``), passed
in by the caller: there is no global probe.  On a CUDA tensor ``auto``
resolves to the hand-written ``cuda`` backend only; the plain ``torch``
backend runs there only when it is named.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

OPS = ("ternary",)
DOMAINS = ("float", "int8")
PACKINGS = ("base3", "trit2")
PLATFORMS = ("cpu", "cuda")

PLAN_CACHE_SIZE = 4096


def check_choice(kind: str, value: Any, choices) -> None:
    if value not in choices:
        raise ValueError(f"unknown {kind} {value!r}; expected one of "
                         f"{sorted(choices)}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A resolved matmul: produced by :func:`plan_matmul`, consumed by
    :func:`execute`."""
    op: str
    backend: str                  # resolved name, never 'auto'
    domain: str                   # float | int8
    packing: str                  # base3 | trit2
    m: int
    k: int
    n: int
    platform: str                 # cpu | cuda

    @property
    def shape(self) -> tuple:
        return (self.m, self.k, self.n)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability declaration and runner ``runner(plan, x, w) -> y``."""
    name: str
    ops: frozenset
    domains: frozenset
    packings: frozenset
    platforms: frozenset
    priority: int
    runner: Callable

    def supports(self, op: str, domain: str, packing: str,
                 platform: str) -> bool:
        return (op in self.ops and domain in self.domains
                and packing in self.packings and platform in self.platforms)


_REGISTRY: dict[str, BackendSpec] = {}


def _ensure_builtin_backends() -> None:
    if not _REGISTRY:
        from . import backends  # noqa: F401  (registers on import)


def register_backend(spec: BackendSpec) -> None:
    if spec.name in _REGISTRY:
        raise ValueError(f"backend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    _resolve.cache_clear()


def backend_names() -> list:
    _ensure_builtin_backends()
    return sorted(_REGISTRY)


def get_backend(name: str) -> BackendSpec:
    _ensure_builtin_backends()
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{backend_names()}")
    return _REGISTRY[name]


def platform_of(x) -> str:
    """The plan platform of a tensor: its device type."""
    platform = x.device.type
    check_choice("platform", platform, PLATFORMS)
    return platform


def resolve_backend(op: str = "ternary", backend: str = "auto",
                    domain: str = "float", packing: str = "base3",
                    platform: str = "cuda") -> BackendSpec:
    """'auto' picks the highest-priority capable backend on `platform`;
    an explicit name is checked against its declared capabilities."""
    _ensure_builtin_backends()
    check_choice("platform", platform, PLATFORMS)
    if backend in (None, "auto"):
        cands = [s for s in _REGISTRY.values()
                 if s.supports(op, domain, packing, platform)]
        if not cands:
            raise ValueError(
                f"no registered backend supports op={op!r} "
                f"domain={domain!r} packing={packing!r} on platform "
                f"{platform!r}; registered: {backend_names()}")
        return max(cands, key=lambda s: s.priority)
    spec = get_backend(backend)
    for kind, value, have in (("op", op, spec.ops),
                              ("domain", domain, spec.domains),
                              ("packing mode", packing, spec.packings),
                              ("platform", platform, spec.platforms)):
        if value not in have:
            raise ValueError(
                f"backend {backend!r} does not support {kind} {value!r} "
                f"(supports {sorted(have)}); registered backends: "
                f"{backend_names()}")
    return spec


def shape_of(x, w) -> tuple:
    """(M, K, N) of ``x (..., K) @ w (K, N)``: M is the flattened
    leading extent."""
    m = 1
    for d in x.shape[:-1]:
        m *= int(d)
    return (m, int(x.shape[-1]), int(w.shape[-1]))


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
def _resolve(op, m, k, n, backend, domain, packing,
             platform) -> ExecutionPlan:
    check_choice("op", op, OPS)
    check_choice("domain", domain, DOMAINS)
    check_choice("packing mode", packing, PACKINGS)
    spec = resolve_backend(op, backend, domain, packing, platform)
    return ExecutionPlan(op=op, backend=spec.name, domain=domain,
                         packing=packing, m=m, k=k, n=n,
                         platform=platform)


def plan_matmul(shape, cfg: Any = None, *, platform: str,
                op: str = "ternary",
                backend: Optional[str] = None,
                domain: Optional[str] = None,
                packing: Optional[str] = None) -> ExecutionPlan:
    """Resolve a plan for an (M, K, N) matmul on `platform`.  ``cfg`` is
    any object with ``backend``/``domain``/``packing`` attributes (a
    ``CIMConfig``); explicit keywords override it."""
    m, k, n = (int(s) for s in shape)
    if cfg is not None:
        backend = backend if backend is not None else cfg.backend
        domain = domain if domain is not None else cfg.domain
        packing = packing if packing is not None else cfg.packing
    _ensure_builtin_backends()
    return _resolve(op, m, k, n, "auto" if backend is None else backend,
                    "float" if domain is None else domain,
                    "base3" if packing is None else packing, platform)


def execute(plan: ExecutionPlan, x, w):
    """Run a resolved plan: ``x (..., K) @ w -> (..., N)``.  The operands
    must match the plan's shape, packing and platform."""
    got = shape_of(x, w)
    if got != plan.shape:
        raise ValueError(f"operand shape {got} does not match plan "
                         f"{plan.shape}; call plan_matmul for this shape")
    if w.mode != plan.packing:
        raise ValueError(f"weight packing {w.mode!r} does not match plan "
                         f"packing {plan.packing!r}")
    if platform_of(x) != plan.platform:
        raise ValueError(f"operand on {platform_of(x)!r} but the plan was "
                         f"resolved for {plan.platform!r}")
    return get_backend(plan.backend).runner(plan, x, w)

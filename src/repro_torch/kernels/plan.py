"""Capability-based execution planning for the kernel layer.

Every packed matmul, every macro-exact CIM MAC (``op='cim'``), and every
paged-attention read resolves once into
a frozen, hashable :class:`ExecutionPlan` (what to compute, and which
backend computes it) and runs through :func:`execute`.  Backends declare
their capabilities in a :class:`BackendSpec`; ``backend='auto'`` picks
the highest-priority backend that supports the request on the operand's
platform, and an explicit backend that lacks a capability raises.

The platform is the operand's device type (``cpu`` or ``cuda``), passed
in by the caller: there is no global probe.  On a CUDA tensor ``auto``
resolves to a hand-written kernel only (``cuda`` for the ternary and cim
ops, ``paged_attn`` for attention); the plain versions run there only
when named.  A fake or meta tensor (the dry run's, which holds no
storage) is on the ``abstract`` platform: only the ``abstract`` backend
serves it, returning the output's shape and dtype and charging the
kernel's cost to the active roll-up (``roofline.op_cost``), and no
backend of a real platform matches it.

``kv_layout`` names the KV-cache layout the serving loop feeds a plan
from (``dense`` slot caches or the ``paged`` page pool); backends
declare the layouts they can be planned under, so paged serving is a
registered capability, not a keyword threaded through call sites.

``fidelity`` is the execution fidelity: ``exact`` (the kernels' bitwise
contract) or ``device`` (the fault-injected analog MAC of
``repro_torch.faults``, which registers a device-only backend).  A
request is first routed per phase (:func:`route_fidelity`: prefill runs
exact even under a device request), then matched like any capability,
so a device backend never serves an exact request and an exact backend
never a device one.

A ternary plan of the ``cuda`` backend also carries the route plan its
kernel runs (``blocks``, with ``block_source``): pinned by the caller,
measured (the autotune table, ``kernels/autotune.py``), or None, and the
wrapper applies its rule (``heuristic``).  :func:`plan_cache_info` counts
the plans resolved, which the analysis sanitizer reads.

Whether the rows of a call are separate calls (:func:`rows_as_calls`) is
not part of a plan: it follows from how the caller batches.  The
schedulers batch slots that the reference decodes one slot per call;
inside the context, the backends whose result depends on the call's
extent (the exact cim plans' input scale, the device MAC's input scale
and ADC noise) treat every row of x as its own call.  Nor is the mesh
a call is split over: inside :func:`call_amax_reducer` x holds one
rank's rows of a call, and the exact cim plans take the whole call's
activation amax from :func:`call_amax`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

OPS = ("ternary", "cim", "attention")
DOMAINS = ("float", "int8")
PACKINGS = ("base3", "trit2")
PLATFORMS = ("cpu", "cuda", "abstract")
KV_LAYOUTS = ("dense", "paged")
PHASES = ("auto", "decode", "prefill")
FIDELITIES = ("exact", "device")

PLAN_CACHE_SIZE = 4096

_ROWS_AS_CALLS = contextvars.ContextVar("rows_as_calls", default=False)


@contextlib.contextmanager
def rows_as_calls(on: bool = True):
    """Within the block, a backend whose result depends on the call's
    extent runs each row of x as its own call: the exact cim plans
    quantize each row with its own scale, and the device MAC also takes
    a one-row call's ADC noise.  The schedulers enter it where they
    batch slots that the reference decodes one slot per call (its dense
    pool and paged gather read); its fused paged read is one call over
    every slot, and so is the bucket engine's decode."""
    token = _ROWS_AS_CALLS.set(bool(on))
    try:
        yield
    finally:
        _ROWS_AS_CALLS.reset(token)


def rows_are_calls() -> bool:
    """Whether the current context runs each row as its own call."""
    return _ROWS_AS_CALLS.get()


_CALL_AMAX = contextvars.ContextVar("call_amax", default=None)


@contextlib.contextmanager
def call_amax_reducer(reduce: Optional[Callable]):
    """Within the block, x holds one mesh rank's rows of a call, and
    ``reduce(|x|)`` is the whole call's activation amax (the meshed
    engines and train step install the max over the ranks that split
    the call's rows, ``dist.runtime.max_rows``, which carries the
    gradient to the maximal elements of every rank).  None: the rows
    are the whole call."""
    token = _CALL_AMAX.set(reduce)
    try:
        yield
    finally:
        _CALL_AMAX.reset(token)


def get_call_amax_reducer() -> Optional[Callable]:
    """The reducer :func:`call_amax_reducer` installed (None outside)."""
    return _CALL_AMAX.get()


def call_amax(x2):
    """The activation amax of the whole call that ``x2`` holds rows of,
    where a reducer is installed and the call is one call (not
    :func:`rows_as_calls`); else None: the quantizer takes x2's own."""
    reduce = _CALL_AMAX.get()
    if reduce is None or rows_are_calls():
        return None
    return reduce(x2.abs())


def check_choice(kind: str, value: Any, choices) -> None:
    if value not in choices:
        raise ValueError(f"unknown {kind} {value!r}; expected one of "
                         f"{sorted(choices)}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A resolved matmul or attention read: produced by
    :func:`plan_matmul`, consumed by :func:`execute`."""
    op: str                       # ternary | cim | attention
    backend: str                  # resolved name, never 'auto'
    domain: str                   # float | int8
    packing: str                  # base3 | trit2
    m: int
    k: int
    n: int
    platform: str                 # cpu | cuda | abstract
    kv_layout: str = "dense"      # dense | paged
    adc_bits: Optional[int] = None    # cim and device plans: ADC bits
    num_trits: Optional[int] = None   # cim and device plans: trits
    phase: str = "auto"           # auto | decode | prefill
    fidelity: str = "exact"       # exact | device, after routing
    blocks: Optional[tuple] = None    # the route plan the cuda backend
                                      # hands the kernel; None: its rule
    block_source: str = "heuristic"   # heuristic | autotune | pinned

    @property
    def shape(self) -> tuple:
        return (self.m, self.k, self.n)

    def describe(self) -> dict:
        """JSON-friendly record of the resolved plan."""
        return {"backend": self.backend, "domain": self.domain,
                "packing": self.packing, "phase": self.phase,
                "platform": self.platform,
                "blocks": list(self.blocks) if self.blocks else None,
                "kv_layout": self.kv_layout, "fidelity": self.fidelity,
                "block_source": self.block_source}


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
    kv_layouts: frozenset = frozenset({"dense"})
    fidelities: frozenset = frozenset({"exact"})

    def supports(self, op: str, domain: str, packing: str,
                 platform: str, kv_layout: str = "dense",
                 fidelity: str = "exact") -> bool:
        return (op in self.ops and domain in self.domains
                and packing in self.packings and platform in self.platforms
                and kv_layout in self.kv_layouts
                and fidelity in self.fidelities)


_REGISTRY: dict[str, BackendSpec] = {}


def _ensure_builtin_backends() -> None:
    if not _REGISTRY:
        from . import backends  # noqa: F401  (registers on import)


def register_backend(spec: BackendSpec, *, override: bool = False) -> None:
    """Register a backend; replacing a registered name needs
    ``override=True``."""
    if spec.name in _REGISTRY and not override:
        raise ValueError(f"backend {spec.name!r} already registered; "
                         f"pass override=True to replace it")
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


def is_abstract(x) -> bool:
    """Whether ``x`` holds no storage: a FakeTensor or a meta tensor."""
    if type(x) is torch.Tensor:     # no subclass, so no fake: one check
        return x.is_meta            # on the serving path's every call
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x) or x.is_meta


def platform_of(x) -> str:
    """The plan platform of a tensor: ``abstract`` for a fake or meta
    tensor, else its device type."""
    platform = "abstract" if is_abstract(x) else x.device.type
    check_choice("platform", platform, PLATFORMS)
    return platform


def route_fidelity(fidelity: str, phase: str) -> str:
    """The fidelity a phase runs: ``exact`` stays exact; ``device`` runs
    the fault-injected path for the error-tolerant phases (``decode``,
    ``auto``) and exact for ``prefill``, whose mistakes would corrupt the
    whole KV prefix (a decode upset perturbs one sampled token)."""
    check_choice("fidelity", fidelity, FIDELITIES)
    check_choice("phase", phase, PHASES)
    if fidelity == "device" and phase == "prefill":
        return "exact"
    return fidelity


def resolve_backend(op: str = "ternary", backend: str = "auto",
                    domain: str = "float", packing: str = "base3",
                    platform: str = "cuda", kv_layout: str = "dense",
                    fidelity: str = "exact") -> BackendSpec:
    """'auto' picks the highest-priority capable backend on `platform`;
    an explicit name is checked against its declared capabilities."""
    _ensure_builtin_backends()
    check_choice("platform", platform, PLATFORMS)
    check_choice("kv layout", kv_layout, KV_LAYOUTS)
    check_choice("fidelity", fidelity, FIDELITIES)
    if backend in (None, "auto"):
        cands = [s for s in _REGISTRY.values()
                 if s.supports(op, domain, packing, platform, kv_layout,
                               fidelity)]
        if not cands:
            raise ValueError(
                f"no registered backend supports op={op!r} "
                f"domain={domain!r} packing={packing!r} "
                f"kv_layout={kv_layout!r} fidelity={fidelity!r} on "
                f"platform {platform!r}; registered: {backend_names()}")
        return max(cands, key=lambda s: s.priority)
    spec = get_backend(backend)
    for kind, value, have in (("op", op, spec.ops),
                              ("domain", domain, spec.domains),
                              ("packing mode", packing, spec.packings),
                              ("kv layout", kv_layout, spec.kv_layouts),
                              ("fidelity", fidelity, spec.fidelities),
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


# the backend whose kernels take a route plan (``ExecutionPlan.blocks``)
TILED_BACKEND = "cuda"


def _tiles(op, m, k, n, backend, domain, packing, platform, blocks):
    """(blocks, block_source) of a plan: pinned ``blocks`` first (checked
    against the kernel's contract), else the measured autotune table for
    a ternary plan of the cuda backend, else None (the wrapper's rule).
    The table is keyed by the phase the kernel route implies and the K
    the kernel sees (trit2 x is zero-padded to a multiple of 4)."""
    from . import autotune
    from .ternary_matmul import TRIT2_PER_BYTE, plan_violations
    tiled = op == "ternary" and backend == TILED_BACKEND
    kdim = k + (-k % TRIT2_PER_BYTE) if packing == "trit2" else k
    if blocks is not None:
        if not tiled:
            raise ValueError(f"backend {backend!r} ({op}) takes no tiles; "
                             f"only {TILED_BACKEND!r} ternary plans do")
        bad = plan_violations(autotune.route_of(m), m, kdim, n, packing,
                              domain, tuple(blocks))
        if bad:
            raise ValueError(f"pinned tiles {tuple(blocks)} at "
                             f"{(m, kdim, n)} {packing}/{domain}: "
                             + "; ".join(msg for _, msg in bad))
        return tuple(blocks), "pinned"
    if tiled:
        tuned = autotune.lookup_blocks(m, kdim, n, autotune.route_phase(m),
                                       platform, packing, domain)
        if tuned is not None:
            return tuned, "autotune"
    return None, "heuristic"


@functools.lru_cache(maxsize=PLAN_CACHE_SIZE)
def _resolve(op, m, k, n, phase, backend, domain, packing, platform,
             kv_layout, fidelity, adc_bits, num_trits,
             blocks=None) -> ExecutionPlan:
    check_choice("op", op, OPS)
    check_choice("domain", domain, DOMAINS)
    check_choice("packing mode", packing, PACKINGS)
    # routed BEFORE the capability match: a device request for prefill
    # resolves against the exact backends
    fidelity = route_fidelity(fidelity, phase)
    spec = resolve_backend(op, backend, domain, packing, platform,
                           kv_layout, fidelity)
    tiles, source = _tiles(op, m, k, n, spec.name, domain, packing,
                           platform, blocks)
    return ExecutionPlan(op=op, backend=spec.name, domain=domain,
                         packing=packing, m=m, k=k, n=n,
                         platform=platform, kv_layout=kv_layout,
                         adc_bits=adc_bits, num_trits=num_trits,
                         phase=phase, fidelity=fidelity, blocks=tiles,
                         block_source=source)


def plan_cache_info():
    """Hits, misses (new plans) and size of the resolution cache."""
    return _resolve.cache_info()


def plan_cache_clear() -> None:
    _resolve.cache_clear()


def plan_matmul(shape, cfg: Any = None, *, platform: str,
                phase: str = "auto", op: str = "ternary",
                backend: Optional[str] = None,
                domain: Optional[str] = None,
                packing: Optional[str] = None,
                kv_layout: Optional[str] = None,
                fidelity: Optional[str] = None,
                adc_bits: Optional[int] = None,
                num_trits: Optional[int] = None,
                blocks: Optional[tuple] = None) -> ExecutionPlan:
    """Resolve a plan for an (M, K, N) problem on `platform`.  ``cfg`` is
    any object with ``backend``/``domain``/``packing``/``kv_layout``/
    ``fidelity`` attributes (a ``CIMConfig``); explicit keywords override
    it.  A cim plan, and a device-fidelity plan (whose ADC model needs
    them), carries ``adc_bits`` and ``num_trits`` (5 and 5 unless given).
    An attention plan's shape is ``(S*KV*rep, hd, W*page_size)``: every
    slot's grouped queries against the per-slot page capacity.

    A ternary plan of the cuda backend carries the route plan its kernel
    runs (``blocks``): ``blocks`` pins one (``block_source='pinned'``),
    else the measured autotune table's for the cell (``'autotune'``),
    else None, and the wrapper applies its rule (``'heuristic'``; the
    miss is logged once per cell).  Other backends take no tiles."""
    m, k, n = (int(s) for s in shape)
    if cfg is not None:
        backend = backend if backend is not None else cfg.backend
        domain = domain if domain is not None else cfg.domain
        packing = packing if packing is not None else cfg.packing
        kv_layout = kv_layout if kv_layout is not None else cfg.kv_layout
        fidelity = fidelity if fidelity is not None else cfg.fidelity
    fidelity = "exact" if fidelity is None else fidelity
    if op == "cim" or fidelity == "device":
        adc_bits = 5 if adc_bits is None else adc_bits
        num_trits = 5 if num_trits is None else num_trits
    _ensure_builtin_backends()
    return _resolve(op, m, k, n, phase,
                    "auto" if backend is None else backend,
                    "float" if domain is None else domain,
                    "base3" if packing is None else packing, platform,
                    "dense" if kv_layout is None else kv_layout, fidelity,
                    adc_bits, num_trits,
                    None if blocks is None else tuple(int(b) for b in blocks))


def execute(plan: ExecutionPlan, x, w):
    """Run a resolved plan: ``x (..., K) @ w -> (..., N)`` for a ternary
    plan (``w`` a ``PackedTernary``) or a cim plan (``w`` a float (K, N)
    tensor or a base3 ``PackedTernary``), ``(acc, m, l)`` of the queries
    ``x`` against a ``PagedAttentionKV`` ``w`` for an attention plan.
    The operands must match the plan's shape, packing and platform."""
    got = shape_of(x, w)
    if got != plan.shape:
        raise ValueError(f"operand shape {got} does not match plan "
                         f"{plan.shape}; call plan_matmul for this shape")
    if plan.op == "ternary" and w.mode != plan.packing:
        raise ValueError(f"weight packing {w.mode!r} does not match plan "
                         f"packing {plan.packing!r}")
    if platform_of(x) != plan.platform:
        raise ValueError(f"operand on {platform_of(x)!r} but the plan was "
                         f"resolved for {plan.platform!r}")
    return get_backend(plan.backend).runner(plan, x, w)

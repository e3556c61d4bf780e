"""Pass ``sanitize``: the serving loops' transfer and re-plan contract.

:func:`sanitize` is a context manager that turns the engines' accounting
claims into enforced invariants:

  * **device-to-host transfers**: every explicit sync goes through the
    engines' counted chokepoint, ``_EngineBase._device_get``; the
    sanitizer wraps it to count calls.  On a CUDA device it also turns
    on ``torch.cuda.set_sync_debug_mode("error")`` for the region, all
    but inside the chokepoint, so any other synchronizing operation (a
    pageable copy either way, ``.item()``, a data-dependent shape)
    raises: the torch counterpart of ``jax.transfer_guard``.
  * **new plans and builds**: what takes the place of the reference's
    compiles.  A plan-cache miss (``kernels.plan.plan_cache_info``) means
    a matmul met a new (shape, request) key; a library loaded by
    ``kernels/build.py`` means a kernel was built or loaded.  After a
    warm-up at the same shapes both must stay 0.

Usage (as ``chip_smoke.py`` and the tests drive it)::

    with sanitize() as rep:
        scheduler.run()
    assert rep.transfers == scheduler.chunks_run    # one per chunk
    assert rep.new_plans == rep.builds == 0

Budgets given at entry are enforced at exit with :class:`SanitizeError`.
``run()`` is the pass: the bucket ``ServeEngine``, the dense
``Scheduler`` and the ``PagedScheduler`` (gather and fused reads) on the
smoke model with packed base3 weights, warmed, then replayed under
``sanitize`` (SAN001: one transfer per chunk, or per bucket, and no other
sync; SAN002: no new plan and no build after warm-up).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional

from .base import Finding

PASS = "sanitize"
ARCH = "internlm2-1.8b"
_FRESH_N = itertools.count(100_003)     # N of the 'replan' injection


class SanitizeError(AssertionError):
    """A sanitized region broke its transfer, plan or build budget."""


@dataclasses.dataclass
class SanitizeReport:
    """What one ``sanitize()`` region counted."""
    transfers: int = 0       # calls of the engines' _device_get
    new_plans: int = 0       # plan-cache misses (new plans resolved)
    builds: int = 0          # kernel libraries built or loaded
    sync_guard: bool = False     # set_sync_debug_mode was on


@contextlib.contextmanager
def sanitize(*, max_transfers: Optional[int] = None,
             max_new_plans: Optional[int] = None,
             max_builds: Optional[int] = None, sync_guard: str = "error"):
    """Count transfers, new plans and builds inside the region; on a
    CUDA device every synchronizing operation outside the chokepoint
    raises (``sync_guard="warn"`` only warns, ``""`` checks nothing).
    Budgets, when given, raise :class:`SanitizeError` at exit."""
    import torch

    from ..kernels import build
    from ..kernels import plan as plan_mod
    from ..serve import engine
    rep = SanitizeReport()
    guard = sync_guard if torch.cuda.is_available() else ""
    orig = engine._EngineBase._device_get

    def counted(self, x):
        rep.transfers += 1
        if not guard:
            return orig(self, x)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig(self, x)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    plans0 = plan_mod.plan_cache_info().misses
    libs0 = len(build._LIBS)
    engine._EngineBase._device_get = counted
    prev = torch.cuda.get_sync_debug_mode() if guard else None
    if guard:
        torch.cuda.set_sync_debug_mode(sync_guard)
        rep.sync_guard = True
    try:
        yield rep
    finally:
        if guard:
            torch.cuda.set_sync_debug_mode(prev)
        engine._EngineBase._device_get = orig
        rep.new_plans = plan_mod.plan_cache_info().misses - plans0
        rep.builds = len(build._LIBS) - libs0
    for name, got, budget in (("device-to-host transfers", rep.transfers,
                               max_transfers),
                              ("new plans", rep.new_plans, max_new_plans),
                              ("kernel builds", rep.builds, max_builds)):
        if budget is not None and got > budget:
            raise SanitizeError(f"sanitized region made {got} {name}; "
                                f"budget is {budget}")


# ----------------------------------------------------- the CLI pass

def smoke_requests(vocab: int, uids, prompt_len: int = 8,
                   max_new: int = 6, seed: int = 0) -> list:
    """Requests of the pass: each prompt drawn by numpy from (seed, uid)."""
    import numpy as np

    from ..serve import Request
    return [Request(uid=u, prompt=np.random.default_rng((seed, u)).integers(
                0, vocab, size=prompt_len, dtype=np.int32),
                    max_new=max_new) for u in uids]


def smoke_model(device: str):
    """(cfg, model, packed base3 params, cim) of the smoke model in f32."""
    import torch

    from .. import configs
    from ..core.cim_linear import CIMConfig, ternarize_params
    from ..models import registry
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype=torch.float32)
    model = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing="base3")
    params = ternarize_params(
        model.init(torch.Generator(device).manual_seed(0), device=device),
        cim)
    return cfg, model, params, cim


ENGINES = ("bucket", "dense", "gather", "fused")


def make_engine(kind: str, model, params, cim, device: str,
                capacity: int = 64, slots: int = 2, chunk: int = 4,
                page_size: int = 16):
    from ..serve import PagedScheduler, Scheduler, ServeEngine
    if kind == "bucket":
        return ServeEngine(model, params, capacity=capacity, max_batch=3,
                           cim=cim, device=device)
    if kind == "dense":
        return Scheduler(model, params, capacity=capacity, slots=slots,
                         chunk=chunk, cim=cim, device=device)
    return PagedScheduler(model, params, capacity=capacity, slots=slots,
                          chunk=chunk, page_size=page_size, cim=cim,
                          fused_attn="auto" if kind == "fused" else False,
                          device=device)


def check_engine(eng, label: str, warm: list, measured: list,
                 inject=(), counts: Optional[dict] = None) -> list:
    """Warm ``eng`` on ``warm``, then serve ``measured`` (the same
    shapes) under ``sanitize``: SAN001 one transfer per chunk (bucket)
    and no other sync, SAN002 no new plan and no build.  ``counts``, when
    given, receives what the region counted."""
    import torch

    from ..kernels import plan_matmul
    for r in warm:
        eng.submit(r)
    eng.run()
    bucketed = not hasattr(eng, "chunks_run")
    done0 = len(eng.completed)
    chunks0 = 0 if bucketed else eng.chunks_run
    transfers0 = eng.host_transfers
    findings = []
    try:
        with sanitize() as rep:
            for r in measured:
                eng.submit(r)
            eng.run()
            if "transfer" in inject:
                # seeded violation: a transfer besides the rounds' own
                eng._device_get(torch.zeros(1, device=eng.device))
            if "replan" in inject:
                # seeded violation: a shape nothing resolved before
                plan_matmul((3, 5, next(_FRESH_N)), platform=eng.device.type)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return [Finding(PASS, "SAN001", label,
                        f"a synchronizing operation outside the transfer "
                        f"chokepoint: {e}")]
    engine_transfers = eng.host_transfers - transfers0
    if bucketed:
        buckets = -(-len(measured) // eng.max_batch)
        chunks = buckets
    else:
        chunks = eng.chunks_run - chunks0
    if counts is not None:
        counts.update(transfers=rep.transfers, chunks=chunks,
                      engine_transfers=engine_transfers,
                      new_plans=rep.new_plans, builds=rep.builds,
                      sync_guard=rep.sync_guard,
                      completed=len(eng.completed) - done0)
    if len(eng.completed) - done0 != len(measured):
        findings.append(Finding(PASS, "SAN001", label,
                                f"{len(eng.completed) - done0} of "
                                f"{len(measured)} requests completed"))
    if rep.transfers != chunks:
        findings.append(Finding(
            PASS, "SAN001", label,
            f"{rep.transfers} device-to-host transfers over {chunks} "
            f"{'buckets' if bucketed else 'chunks'}; the contract is "
            f"exactly one each"))
    if engine_transfers != chunks:
        findings.append(Finding(
            PASS, "SAN001", label,
            f"engine accounting drifted: host_transfers counted "
            f"{engine_transfers}, {'buckets' if bucketed else 'chunks'} "
            f"{chunks}"))
    if rep.new_plans or rep.builds:
        findings.append(Finding(
            PASS, "SAN002", label,
            f"{rep.new_plans} new plans and {rep.builds} kernel builds "
            f"after warm-up (a matmul met a shape the warm-up did not)"))
    return findings


def run(inject=(), device: str = "cuda", engines=ENGINES) -> list:
    """The pass on ``device`` (the card by default; without one it
    raises, it never moves to the CPU by itself).  ``inject`` seeds
    violations ('transfer', 'replan') for the CLI's
    ``--inject-sanitize``."""
    from .. import resolve_device
    device = str(resolve_device(device))
    cfg, model, params, cim = smoke_model(device)
    findings = []
    for kind in engines:
        eng = make_engine(kind, model, params, cim, device)
        label = ("serve.ServeEngine[bucket]" if kind == "bucket" else
                 f"serve.{type(eng).__name__}[{kind}]")
        findings += check_engine(
            eng, label, smoke_requests(cfg.vocab_size, range(3)),
            smoke_requests(cfg.vocab_size, range(10, 13)), inject)
    return findings

"""Pass ``frontend``: the serving front-end's dynamic contracts.

Three checks over ``repro_torch.frontend`` on the smoke model, each one
of the contracts ``src/repro_torch/frontend/README.md`` states (the
reference's FE rules):

  FE001  streaming transfer contract: a warmed front-end replay under
         :func:`~.sanitizer.sanitize` makes exactly one device-to-host
         transfer per scheduler chunk and no other sync (on a card the
         sanitizer's sync guard is on), the server's own
         ``host_transfers`` / ``chunks`` agree, and nothing is planned or
         built after warm-up.
  FE002  bounded queue and explicit backpressure: a burst against a
         ``queue_limit=2`` server never holds more than 2 pending
         requests, and ``submitted == completed + rejected`` with every
         reject carrying a reason.
  FE003  deterministic admission: one overload trace replayed twice
         under a virtual clock (priorities, deadlines, a shedding SLO
         policy) gives identical admission logs, tokens and shed sets.

``inject`` seeds violations for the CLI self-test (``--inject-frontend``):
'transfer' adds a transfer inside the sanitized replay (FE001), 'drop'
loses a rejected request from the books (FE002), 'order' replays the
second FE003 epoch under a policy with a perturbed tie-break.
"""
from __future__ import annotations


from .base import Finding

PASS = "frontend"
ARCH = "internlm2-1.8b"


def _registry(device: str):
    from ..frontend import ModelRegistry, ModelSpec
    reg = ModelRegistry(device=device)
    reg.register(ModelSpec(name="m", arch=ARCH, smoke=True, kind="paged",
                           capacity=64, slots=2, chunk=4, page_size=16))
    return reg


def _records(reg, *, deadlines=None, priorities=None, arrivals=None,
             n: int = 6):
    from ..frontend import trace_requests
    from ..serve import make_trace
    trace = make_trace(arrivals if arrivals is not None else [0.0] * n,
                       [8, 12], [6, 8], priorities=priorities,
                       deadlines=deadlines)
    return trace_requests(trace, reg, ["m"], seed=0)


def _check_streaming(device: str, inject=()) -> list:
    """FE001: warm, then replay the same shapes under sanitize."""
    import torch

    from ..frontend import FIFOAdmission, FrontendServer, replay
    from .sanitizer import sanitize
    where = "frontend.replay[streaming]"
    reg = _registry(device)
    server = FrontendServer(reg, FIFOAdmission(), queue_limit=16)
    records = _records(reg)
    replay(server, records)              # warm-up: every shape planned
    try:
        with sanitize() as rep:
            r = replay(server, records)
            if "transfer" in inject:
                # seeded violation: a transfer streaming must not add
                sched = reg.entry("m").scheduler
                sched._device_get(torch.zeros(1, device=sched.device))
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        return [Finding(PASS, "FE001", where,
                        f"a synchronizing operation outside the transfer "
                        f"chokepoint: {e}")]
    findings = []
    if rep.transfers != r["chunks"]:
        findings.append(Finding(
            PASS, "FE001", where,
            f"{rep.transfers} device-to-host transfers over {r['chunks']} "
            f"chunks; streaming must consume the schedulers' per-chunk "
            f"payload, exactly one per chunk"))
    if r["host_transfers"] != r["chunks"]:
        findings.append(Finding(
            PASS, "FE001", where,
            f"server accounting drifted: host_transfers "
            f"{r['host_transfers']}, chunks {r['chunks']}"))
    if rep.new_plans or rep.builds:
        findings.append(Finding(
            PASS, "FE001", where,
            f"{rep.new_plans} new plans and {rep.builds} builds after "
            f"warm-up (the front-end replayed shapes the pool had seen)"))
    return findings


def _check_backpressure(device: str, inject=()) -> list:
    """FE002: a burst into a queue_limit=2 server, bounded and counted."""
    from ..frontend import FIFOAdmission, FrontendServer, replay
    where = "frontend.replay[backpressure]"
    findings = []
    reg = _registry(device)
    server = FrontendServer(reg, FIFOAdmission(), queue_limit=2)
    r = replay(server, _records(reg, n=8))
    if "drop" in inject:
        server.rejected.pop()           # seeded violation: a lost reject
    if server.max_pending_seen > server.queue_limit:
        findings.append(Finding(
            PASS, "FE002", where,
            f"pending queue reached {server.max_pending_seen} with "
            f"queue_limit={server.queue_limit}"))
    accounted = len(server.completed) + len(server.rejected)
    if server.submitted != accounted or server.in_flight:
        findings.append(Finding(
            PASS, "FE002", where,
            f"accounting hole: {server.submitted} submitted but {accounted} "
            f"accounted ({len(server.completed)} completed + "
            f"{len(server.rejected)} rejected, {server.in_flight} in "
            f"flight); requests must never be dropped silently"))
    unreasoned = sum(1 for s in server.rejected if not s.reason)
    if unreasoned:
        findings.append(Finding(PASS, "FE002", where,
                                f"{unreasoned} rejected request(s) carry "
                                f"no reason"))
    if r["rejected"] and not r["rejects_by_reason"]:
        findings.append(Finding(PASS, "FE002", where,
                                "rejects_by_reason empty despite rejects"))
    return findings


def _replay_virtual(reg, records, policy):
    from ..frontend import FrontendServer, VirtualClock, replay
    clock = VirtualClock()
    server = FrontendServer(reg, policy, queue_limit=4, clock=clock)
    r = replay(server, records, sleep=clock.advance,
               tick=lambda: clock.advance(0.02), collect_tokens=True)
    return r, list(server.admission_log)


def _check_determinism(device: str, inject=()) -> list:
    """FE003: two virtual-clock replays of one overload trace agree
    decision for decision and token for token."""
    from ..frontend import SLOAdmission, deadline_at
    where = "frontend.replay[determinism]"
    findings = []
    reg = _registry(device)
    records = _records(reg, n=8,
                       arrivals=[round(0.01 * i, 3) for i in range(8)],
                       priorities=[0, 1], deadlines=[0.08, None])
    policy = SLOAdmission(service_floor_s=0.02)
    _replay_virtual(reg, records, policy)          # warm the pool
    r1, log1 = _replay_virtual(reg, records, policy)
    if "order" in inject:
        class _Jittered(SLOAdmission):
            # seeded violation: an order that flips whenever several
            # requests are pending at once
            def sort_key(self, req, now):
                return (req.priority, deadline_at(req), -req.arrival_s,
                        -req.uid)
        policy = _Jittered(service_floor_s=0.02)
    r2, log2 = _replay_virtual(reg, records, policy)
    if log1 != log2:
        i = next((i for i, (a, b) in enumerate(zip(log1, log2)) if a != b),
                 min(len(log1), len(log2)))
        findings.append(Finding(
            PASS, "FE003", where,
            f"admission logs diverge at decision #{i} "
            f"({log1[i] if i < len(log1) else '<end>'} vs "
            f"{log2[i] if i < len(log2) else '<end>'}); admission must be "
            f"a pure function of (trace, seed)"))
    if r1.get("out_tokens") != r2.get("out_tokens"):
        findings.append(Finding(PASS, "FE003", where,
                                "per-request tokens differ between "
                                "identical replays"))
    if (r1["shed"], r1["deadline_met"]) != (r2["shed"], r2["deadline_met"]):
        findings.append(Finding(
            PASS, "FE003", where,
            f"shed/deadline accounting differs: "
            f"{(r1['shed'], r1['deadline_met'])} vs "
            f"{(r2['shed'], r2['deadline_met'])}"))
    return findings


def run(inject=(), device: str = "cuda") -> list:
    """The pass on ``device`` (the card by default; without one it
    raises, it never moves to the CPU by itself).  ``inject`` seeds
    violations ('transfer', 'drop', 'order') for the CLI's
    ``--inject-frontend``."""
    from .. import resolve_device
    device = str(resolve_device(device))
    return (_check_streaming(device, inject)
            + _check_backpressure(device, inject)
            + _check_determinism(device, inject))

"""In-process serving front-end over the continuous schedulers.

``FrontendServer`` is the request/response layer the schedulers do not
have: one ``submit()`` path over every model of a
:class:`~.registry.ModelRegistry`, a BOUNDED pending queue with explicit
backpressure, SLO-aware admission (:mod:`.admission`), and per-request
incremental token streaming.  No sockets, no threads: the caller pumps
it (``poll`` / ``drain``), and the load generator (:mod:`.loadgen`)
replays arrival traces against it open-loop.

Contracts (``tests/test_torch_frontend.py``):

  * **Token parity**: the server never schedules on its own; it drives
    each model's scheduler through the pump API (``try_admit`` /
    ``step_round``), the machinery ``Scheduler.run()`` uses, so
    per-request tokens equal those of driving the scheduler directly.
  * **Bounded queue, explicit backpressure**: at most ``queue_limit``
    requests wait for admission; past that ``submit`` REJECTS with a
    reason (``queue-full``), never drops silently.  Every submitted
    request is accounted for: ``submitted == len(completed) +
    len(rejected) + in_flight`` at all times.
  * **Streaming adds no transfers**: a scheduler round already lands
    every new token on the host in its ONE per-chunk transfer
    (``Request.out_tokens`` grows as the chunk's buffer is absorbed);
    streaming drains that growth into the request's :class:`Stream`
    after each round.  ``host_transfers == chunks`` holds through the
    front-end; this package reads no device tensor.
  * **Deterministic admission**: the server reads time ONLY through the
    injected ``clock`` (seconds; ``time.monotonic`` by default, a
    virtual clock under test), and every admit / shed / reject decision
    is appended to ``admission_log`` in decision order, so two replays
    of one (trace, seed) give identical logs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..serve import Request
from .admission import FIFOAdmission
from .registry import ModelRegistry


@dataclasses.dataclass
class Stream:
    """Per-request handle: incremental tokens and a terminal status.

    ``status`` walks queued -> running -> done, or ends at rejected (at
    submit) or shed (a queued request whose deadline became
    unmeetable).  ``tokens`` grows per scheduler round (per chunk);
    ``ttft_s`` is stamped when the first tokens land.  ``on_tokens``,
    when set, is called as ``on_tokens(stream, new_tokens)`` on every
    increment: the delivery hook a transport adapter would attach.
    """

    uid: int
    model: str
    req: Optional[Request]
    status: str = "queued"
    reason: Optional[str] = None
    tokens: list = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    on_tokens: Optional[Callable] = None

    @property
    def accepted(self) -> bool:
        return self.status not in ("rejected", "shed")

    @property
    def finished(self) -> bool:
        return self.status in ("done", "rejected", "shed")


class FrontendServer:
    def __init__(self, registry: ModelRegistry, admission=None,
                 queue_limit: int = 64, clock=time.monotonic):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1 (the queue is "
                             f"bounded by contract), got {queue_limit}")
        self.registry = registry
        self.admission = (admission if admission is not None
                          else FIFOAdmission())
        self.queue_limit = queue_limit
        self._clock = clock
        self._t0: Optional[float] = None
        self._next_uid = 0
        self._pending: list[Stream] = []
        self._running: dict[str, list[Stream]] = {}
        self._rr = 0                    # round-robin cursor over models
        # accounting: every submit ends in exactly one of these
        self.submitted = 0
        self.completed: list[Stream] = []
        self.rejected: list[Stream] = []
        self.rejects_by_reason: dict[str, int] = {}
        self.max_pending_seen = 0
        self.admission_log: list[tuple] = []

    # ------------------------------------------------------ serve clock

    def begin(self) -> None:
        """Start (or restart) the serve epoch: ``now()`` reads 0 here.
        A replay calls it per epoch, so arrival stamps stay comparable."""
        self._t0 = self._clock()

    def now(self) -> float:
        if self._t0 is None:
            self.begin()
        return self._clock() - self._t0

    # -------------------------------------------------------- interface

    def submit(self, model: str, prompt, max_new: int = 16,
               eos_id: int = -1, arrival_s: Optional[float] = None,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_tokens: Optional[Callable] = None) -> Stream:
        """Offer one request; returns its :class:`Stream`, already
        terminal (``status == 'rejected'``) when backpressure or
        validation rejects it.  ``arrival_s`` defaults to ``now()`` (an
        open-loop replayer passes the trace's stamp)."""
        now = self.now()
        uid = self._next_uid
        self._next_uid += 1
        self.submitted += 1
        arrival = now if arrival_s is None else float(arrival_s)
        stream = Stream(uid=uid, model=model, req=None,
                        on_tokens=on_tokens)
        if model not in self.registry:
            return self._reject(stream, "unknown-model", "rejected")
        spec = self.registry.spec(model)
        if len(prompt) + max_new > spec.capacity:
            return self._reject(stream, "over-capacity", "rejected")
        if len(self._pending) >= self.queue_limit:
            return self._reject(stream, "queue-full", "rejected")
        stream.req = Request(uid=uid, prompt=prompt, max_new=max_new,
                             eos_id=eos_id, arrival_s=arrival,
                             priority=priority, deadline_s=deadline_s)
        self._pending.append(stream)
        self.max_pending_seen = max(self.max_pending_seen,
                                    len(self._pending))
        return stream

    def poll(self) -> bool:
        """One pump iteration: shed doomed pending requests, admit in
        policy order, then advance ONE busy model by one scheduler round
        and stream its new tokens.  True while the server still holds
        work (pending or running)."""
        now = self.now()
        self._shed(now)
        self._admit_pending(now)
        stepped = self._step_one_round()
        return stepped or bool(self._pending)

    def drain(self) -> None:
        """Pump until every accepted request completed (no new arrivals;
        an open-loop replayer interleaves submits with ``poll``)."""
        while self.poll():
            pass

    # ------------------------------------------------------- accounting

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        return len(self._pending) + sum(len(v)
                                        for v in self._running.values())

    def _live_schedulers(self) -> list:
        return [self.registry.entry(m).scheduler
                for m in self.registry.names()
                if self.registry.is_instantiated(m)]

    @property
    def host_transfers(self) -> int:
        """Device-to-host syncs over every built pool (streaming adds
        none: this equals ``chunks``)."""
        return sum(s.host_transfers for s in self._live_schedulers())

    @property
    def chunks(self) -> int:
        return sum(s.chunks_run for s in self._live_schedulers())

    # --------------------------------------------------------- internals

    def _reject(self, stream: Stream, reason: str, status: str) -> Stream:
        stream.status = status
        stream.reason = reason
        self.rejected.append(stream)
        self.rejects_by_reason[reason] = \
            self.rejects_by_reason.get(reason, 0) + 1
        self.admission_log.append(("reject", stream.uid, reason))
        return stream

    def _shed(self, now: float) -> None:
        doomed = []
        for stream in self._pending:
            reason = self.admission.shed_reason(stream.req, now)
            if reason is not None:
                doomed.append((stream, reason))
        for stream, reason in doomed:
            self._pending.remove(stream)
            self._reject(stream, reason, "shed")

    def _admit_pending(self, now: float) -> None:
        """Offer pending streams to their schedulers in policy order.
        Per model, the first deferral (pool full, pages short) stops
        further offers to THAT model this poll: admission order within a
        model follows the policy, never skips ahead."""
        self._pending.sort(
            key=lambda s: self.admission.sort_key(s.req, now))
        deferred_models: set[str] = set()
        admitted = []
        for stream in self._pending:
            if stream.model in deferred_models:
                continue
            sched = self.registry.entry(stream.model).scheduler
            if sched.try_admit(stream.req, now):
                stream.status = "running"
                self._running.setdefault(stream.model, []).append(stream)
                self.admission_log.append(
                    ("admit", stream.uid, stream.model))
                admitted.append(stream)
            else:
                deferred_models.add(stream.model)
        for stream in admitted:
            self._pending.remove(stream)

    def _step_one_round(self) -> bool:
        """Advance one busy model by one scheduling round (one chunk, one
        transfer), round-robin over busy models so no model's traffic
        starves another's, then stream the round's tokens."""
        busy = [m for m in sorted(self._running) if self._running[m]]
        if not busy:
            return False
        model = busy[self._rr % len(busy)]
        self._rr += 1
        self.registry.entry(model).scheduler.step_round(self.now)
        self._stream_round(model)
        return True

    def _stream_round(self, model: str) -> None:
        """Drain the round's new tokens out of each running request.
        They are ALREADY on the host (the scheduler's one per-chunk
        transfer put them in ``req.out_tokens``): list slicing, not a
        device read."""
        now = self.now()
        still = []
        for stream in self._running[model]:
            new = stream.req.out_tokens[len(stream.tokens):]
            if new:
                if stream.ttft_s is None:
                    stream.ttft_s = now - stream.req.arrival_s
                stream.tokens.extend(new)
                if stream.on_tokens is not None:
                    stream.on_tokens(stream, new)
            if stream.req.done:
                stream.status = "done"
                self.completed.append(stream)
            else:
                still.append(stream)
        self._running[model] = still

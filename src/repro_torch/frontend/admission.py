"""Admission policies for the serving front-end.

A policy answers two questions each time the server polls, both as pure
functions of a pending request and the server's clock value ``now``
(seconds since the serve epoch):

  * in what ORDER pending requests are offered to free slots
    (``sort_key``; Python's sort is stable, so equal keys keep
    submission order);
  * which pending requests are SHED instead of admitted
    (``shed_reason``: a reason string rejects the request; the server
    counts it, it is never silently dropped).

Policies take the clock VALUE as an argument and carry no RNG and no
clock of their own, so admission is reproducible given (trace, seed):
``tests/test_torch_frontend.py`` replays a trace twice under a virtual
clock and compares the admission logs.

Deadlines are RELATIVE: ``Request.deadline_s`` is a completion budget
from the request's ``arrival_s``; :func:`deadline_at` converts it to the
absolute serve-clock deadline the policies compare against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def deadline_at(req) -> float:
    """Absolute serve-clock deadline (arrival + relative budget); +inf
    when the request carries no deadline."""
    if req.deadline_s is None:
        return float("inf")
    return req.arrival_s + req.deadline_s


class FIFOAdmission:
    """Admit in (arrival, uid) order and never shed: the baseline the
    SLO policy's goodput is measured against."""

    name = "fifo"

    def sort_key(self, req, now: float):
        return (req.arrival_s, req.uid)

    def shed_reason(self, req, now: float) -> Optional[str]:
        return None


@dataclasses.dataclass(frozen=True)
class SLOAdmission:
    """Priority classes, then earliest deadline first, then shedding.

    Order (``sort_key``): ``priority`` first (lower is more urgent; an
    urgent class goes ahead at ADMISSION, running slots are never
    revoked), then the absolute deadline (EDF), then (arrival, uid).

    Shedding (``shed_reason``): a pending request whose deadline can no
    longer be met is rejected instead of taking a slot another request
    could still use: ``deadline-passed`` once ``now`` reaches the
    deadline, and ``deadline-unmeetable`` when ``now + service_floor_s``
    (an estimate of the least time a request needs once admitted)
    overshoots it.  Requests without a deadline are never shed.
    """

    service_floor_s: float = 0.0
    name: str = "slo"

    def sort_key(self, req, now: float):
        return (req.priority, deadline_at(req), req.arrival_s, req.uid)

    def shed_reason(self, req, now: float) -> Optional[str]:
        dl = deadline_at(req)
        if dl == float("inf"):
            return None
        if now >= dl:
            return "deadline-passed"
        if now + self.service_floor_s > dl:
            return "deadline-unmeetable"
        return None

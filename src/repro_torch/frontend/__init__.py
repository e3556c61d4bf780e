"""SLO-aware serving front-end over the continuous schedulers.

Layered on ``repro_torch.serve`` through the schedulers' pump API
(``free_slots`` / ``is_busy`` / ``try_admit`` / ``step_round``): a
bounded-queue in-process server with explicit backpressure and per-chunk
token streaming (:mod:`.server`), priority/deadline admission with load
shedding (:mod:`.admission`), a lazy multi-model registry
(:mod:`.registry`), and an open-loop trace-replay load harness
(:mod:`.loadgen`).  Contracts and overload semantics: ``README.md``
beside this file.
"""
from .admission import FIFOAdmission, SLOAdmission, deadline_at  # noqa: F401
from .registry import ModelEntry, ModelRegistry, ModelSpec  # noqa: F401
from .server import FrontendServer, Stream  # noqa: F401
from .loadgen import (VirtualClock, replay, replay_direct,  # noqa: F401
                      trace_requests)

"""Open-loop trace replay against the front-end.

Open loop: arrivals never wait on completions.  The replay submits every
request whose ``arrival_s`` has passed on every iteration, however far
behind the schedulers are: the load model under which backpressure,
shedding and goodput mean anything (a closed loop throttles itself and
never overloads the server).

The replay is paced by the SERVER's injected clock: on a real clock it
sleeps between arrivals; under a :class:`VirtualClock` the caller passes
``sleep=clock.advance`` and a per-poll ``tick``, so an overload scenario
replays deterministically (same admissions, sheds and tokens).

Reported: p50/p99/p999 latency with the queue-wait / service split
(``serve.latency_stats``), time-to-first-token percentiles, tok/s, and
goodput: DEADLINE-MET tokens per second, the throughput that counts
under overload (the tokens of a request that missed its deadline, or
was shed, earn nothing).
"""
from __future__ import annotations

import time

import numpy as np

from ..core.seeding import stable_seed
from ..serve import Request, latency_stats, percentile, validate_trace


class VirtualClock:
    """A callable clock advanced by hand: ``clock()`` reads the virtual
    time, ``advance`` / ``sleep`` move it (never backwards).  Give it to
    both :class:`~.server.FrontendServer` (``clock=``) and :func:`replay`
    (``sleep=clock.advance``), so pacing and latency stamps share one
    timeline."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += max(float(dt), 0.0)

    sleep = advance


def trace_requests(trace, registry, models, seed: int = 0) -> list[dict]:
    """A ``serve.trace`` as submit records: each request's prompt from
    its own seeded generator (``stable_seed`` of (tag, seed, index):
    editing the trace never reshuffles a neighbour's prompt), the model
    cycling over ``models`` unless a record names its own ``"model"``.
    The SAME records feed the front-end replay and the direct-scheduler
    baseline, so their prompts are shared."""
    records = []
    for i, rec in enumerate(validate_trace(trace)):
        model = rec.get("model") or models[i % len(models)]
        vocab = registry.config(model).vocab_size
        rng = np.random.default_rng(
            stable_seed("frontend-loadgen", seed, i))
        prompt = rng.integers(0, vocab, size=rec["prompt_len"],
                              dtype=np.int32)
        records.append({"uid": i, "model": model, "prompt": prompt,
                        "max_new": rec["max_new"],
                        "eos_id": rec["eos_id"],
                        "arrival_s": rec["arrival_s"],
                        "priority": rec["priority"],
                        "deadline_s": rec["deadline_s"]})
    return records


def replay(server, records, *, sleep=time.sleep, tick=None,
           collect_tokens: bool = False) -> dict:
    """One open-loop epoch: submit each record at its arrival offset,
    pump the server between arrivals, drain, report.

    ``sleep(dt)`` is called only when the server is idle and the next
    arrival lies ahead; ``tick()``, when given, after every busy poll
    (a virtual clock charges its per-round cost there).  Counters are
    reported as DELTAS over this epoch, so one warm server can be
    replayed again."""
    base_completed = len(server.completed)
    base_rejected = len(server.rejected)
    base_submitted = server.submitted
    base_rejects = dict(server.rejects_by_reason)
    base_transfers = server.host_transfers
    base_chunks = server.chunks
    server.max_pending_seen = 0
    server.begin()

    i = 0
    while True:
        now = server.now()
        while i < len(records) and records[i]["arrival_s"] <= now:
            rec = records[i]
            server.submit(rec["model"], rec["prompt"],
                          max_new=rec["max_new"], eos_id=rec["eos_id"],
                          arrival_s=rec["arrival_s"],
                          priority=rec["priority"],
                          deadline_s=rec["deadline_s"])
            i += 1
        busy = server.poll()
        if busy:
            if tick is not None:
                tick()
            continue
        if i < len(records):
            delay = records[i]["arrival_s"] - server.now()
            if delay > 0:
                sleep(delay)
            continue
        break

    wall = server.now()
    completed = server.completed[base_completed:]
    rejected = server.rejected[base_rejected:]
    reqs = [s.req for s in completed]
    tokens = sum(len(s.tokens) for s in completed)
    good_tokens = sum(len(s.tokens) for s in completed
                      if s.req.deadline_met)
    with_deadline = [s for s in completed if s.req.deadline_s is not None]
    shed = [s for s in rejected if s.status == "shed"]
    met = sum(1 for s in with_deadline if s.req.deadline_met)
    deadline_total = len(with_deadline) + len(shed)
    ttfts = sorted(s.ttft_s for s in completed if s.ttft_s is not None)
    rejects_by_reason = {
        k: v - base_rejects.get(k, 0)
        for k, v in server.rejects_by_reason.items()
        if v - base_rejects.get(k, 0)}
    out = {
        "submitted": server.submitted - base_submitted,
        "completed": len(completed),
        "rejected": len(rejected),
        "shed": len(shed),
        "rejects_by_reason": rejects_by_reason,
        "max_pending_seen": server.max_pending_seen,
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tok_per_s": round(tokens / max(wall, 1e-9), 1),
        "goodput_tokens": good_tokens,
        "tok_per_s_goodput": round(good_tokens / max(wall, 1e-9), 1),
        "deadline_met": met,
        "deadline_total": deadline_total,
        "ttft_p50_s": round(percentile(ttfts, 0.50), 4) if ttfts else 0.0,
        "ttft_p99_s": round(percentile(ttfts, 0.99), 4) if ttfts else 0.0,
        "host_transfers": server.host_transfers - base_transfers,
        "chunks": server.chunks - base_chunks,
        **latency_stats(reqs),
    }
    if collect_tokens:
        out["out_tokens"] = {s.uid: list(s.tokens) for s in completed}
    return out


def replay_direct(registry, records, clock=time.perf_counter
                  ) -> tuple[dict, dict]:
    """Parity baseline: the same records driven straight into each
    model's scheduler (``Scheduler.run()``'s own arrival pump, no
    front-end), per model, on the SAME scheduler the registry serves, so
    the comparison isolates the front-end layer.  Returns ``(stats,
    {uid: tokens})``."""
    per_model: dict[str, list] = {}
    for rec in records:
        per_model.setdefault(rec["model"], []).append(rec)
    t0 = clock()
    tokens_by_uid: dict[int, list] = {}
    total_tokens = 0
    for model in sorted(per_model):
        sched = registry.entry(model).scheduler
        done0, tok0 = len(sched.completed), sched.generated_tokens
        for rec in per_model[model]:
            sched.submit(Request(
                uid=rec["uid"], prompt=rec["prompt"],
                max_new=rec["max_new"], eos_id=rec["eos_id"],
                arrival_s=rec["arrival_s"], priority=rec["priority"],
                deadline_s=rec["deadline_s"]))
        sched.run()
        total_tokens += sched.generated_tokens - tok0
        for r in sched.completed[done0:]:
            tokens_by_uid[r.uid] = list(r.out_tokens)
    wall = clock() - t0
    stats = {"wall_s": round(wall, 3), "tokens": total_tokens,
             "tok_per_s": round(total_tokens / max(wall, 1e-9), 1)}
    return stats, tokens_by_uid

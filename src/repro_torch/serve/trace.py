"""Arrival traces for the serving engines.

A trace is a list of per-request dicts ``{"arrival_s", "prompt_len",
"max_new", "eos_id", "priority", "deadline_s"}``: what
``ServeEngine.run_trace`` and the continuous ``Scheduler`` consume.  The
last two fields encode SLO classes (``priority``: lower is more urgent,
default 0; ``deadline_s``: a relative completion budget from the
request's arrival, or None); the schedulers carry them through
untouched.

The generators are deterministic (``random.Random(seed)``), so the same
seed gives the same arrivals as the reference package's generators.
``load_trace`` reads the same shape from a JSON file and validates it
(:class:`TraceError`): records must be objects with the required keys,
arrivals non-negative and sorted, lengths and budgets positive.
"""
from __future__ import annotations

import json
import random
from typing import Optional


class TraceError(ValueError):
    """A trace violated the record contract (malformed file, missing
    key, unsorted or negative arrivals)."""


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0
                     ) -> list[float]:
    """n arrival offsets with exponential inter-arrival gaps (a Poisson
    stream of `rate_per_s` requests/second)."""
    if rate_per_s <= 0:
        return [0.0] * n
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_per_s)
        out.append(round(t, 6))
    return out


def bursty_arrivals(n: int, bursts: int = 2, gap_s: float = 0.25,
                    spread_s: float = 0.02, seed: int = 0) -> list[float]:
    """n arrivals in `bursts` tight clusters `gap_s` apart — the adverse
    pattern for bucket-at-a-time serving: a whole burst queues behind
    the bucket currently draining."""
    rng = random.Random(seed)
    out = []
    per = -(-n // bursts)
    for i in range(n):
        base = (i // per) * gap_s
        out.append(round(base + rng.uniform(0.0, spread_s), 6))
    return sorted(out)


def make_trace(arrivals: list[float], prompt_lens, max_news,
               eos_id: int = -1, priorities=None,
               deadlines=None) -> list[dict]:
    """Zip arrival offsets with cycled prompt-length / max-new menus
    into the canonical trace records.  ``priorities`` / ``deadlines``
    are optional cycled menus for the SLO fields (defaults: priority 0,
    no deadline); a ``deadlines`` entry of None means that class
    carries no deadline."""
    return [{"arrival_s": a,
             "prompt_len": prompt_lens[i % len(prompt_lens)],
             "max_new": max_news[i % len(max_news)],
             "eos_id": eos_id,
             "priority": (priorities[i % len(priorities)]
                          if priorities else 0),
             "deadline_s": (deadlines[i % len(deadlines)]
                            if deadlines else None)}
            for i, a in enumerate(arrivals)]


REQUIRED_KEYS = ("arrival_s", "prompt_len", "max_new")


def validate_trace(trace, where: str = "trace") -> list[dict]:
    """Check a list of records against the trace contract; returns the
    canonicalized records (defaults filled, numeric types coerced) or
    raises :class:`TraceError` naming the offending record.

    Contract: every record is an object carrying ``arrival_s`` (>= 0,
    non-decreasing across the trace), ``prompt_len`` (>= 1) and
    ``max_new`` (>= 1); ``eos_id`` defaults to -1 (never), ``priority``
    to 0, ``deadline_s`` to None (no deadline; else a positive relative
    budget)."""
    if not isinstance(trace, list):
        raise TraceError(f"{where}: expected a JSON list, got "
                         f"{type(trace).__name__}")
    out = []
    prev_arrival = 0.0
    for i, rec in enumerate(trace):
        at = f"{where}[{i}]"
        if not isinstance(rec, dict):
            raise TraceError(f"{at}: expected an object, got "
                             f"{type(rec).__name__}")
        missing = [k for k in REQUIRED_KEYS if k not in rec]
        if missing:
            raise TraceError(f"{at}: missing required keys {missing}")
        try:
            arrival = float(rec["arrival_s"])
            prompt_len = int(rec["prompt_len"])
            max_new = int(rec["max_new"])
            eos_id = int(rec.get("eos_id", -1))
            priority = int(rec.get("priority", 0))
            deadline: Optional[float] = (
                None if rec.get("deadline_s") is None
                else float(rec["deadline_s"]))
        except (TypeError, ValueError) as e:
            raise TraceError(f"{at}: non-numeric field ({e})") from e
        if arrival < 0:
            raise TraceError(f"{at}: negative arrival_s {arrival}")
        if arrival < prev_arrival:
            raise TraceError(f"{at}: arrival_s {arrival} is before the "
                             f"previous record's {prev_arrival} (traces "
                             f"must be sorted by arrival)")
        if prompt_len < 1:
            raise TraceError(f"{at}: prompt_len must be >= 1, got "
                             f"{prompt_len}")
        if max_new < 1:
            raise TraceError(f"{at}: max_new must be >= 1, got {max_new}")
        if deadline is not None and deadline <= 0:
            raise TraceError(f"{at}: deadline_s must be positive (a "
                             f"relative budget from arrival) or null, "
                             f"got {deadline}")
        prev_arrival = arrival
        out.append({"arrival_s": arrival, "prompt_len": prompt_len,
                    "max_new": max_new, "eos_id": eos_id,
                    "priority": priority, "deadline_s": deadline})
    return out


def load_trace(path: str) -> list[dict]:
    """JSON trace file: a validated list of request records
    (:func:`validate_trace`; optional fields get the generator
    defaults).  Raises :class:`TraceError` on a malformed file instead
    of KeyError-ing mid-replay."""
    with open(path) as f:
        try:
            raw = json.load(f)
        except ValueError as e:
            raise TraceError(f"trace file {path}: unparseable JSON "
                             f"({e})") from e
    return validate_trace(raw, where=f"trace file {path}")


def save_trace(path: str, trace: list[dict]) -> None:
    """Validate and write a trace (round-trips through
    :func:`load_trace`)."""
    canonical = validate_trace(trace)
    with open(path, "w") as f:
        json.dump(canonical, f, indent=1)
        f.write("\n")

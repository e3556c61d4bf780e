"""Serving: the bucket engine, the continuous Scheduler and the paged
PagedScheduler, plus arrival traces."""
from .engine import (PagedScheduler, Request, Scheduler,  # noqa: F401
                     ServeEngine, greedy_sample, latency_stats, percentile)
from .trace import (TraceError, bursty_arrivals, load_trace,  # noqa: F401
                    make_trace, poisson_arrivals, save_trace,
                    validate_trace)

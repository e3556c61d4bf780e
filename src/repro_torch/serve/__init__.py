"""Serving: the bucket engine with the on-device decode loop."""
from .engine import (Request, ServeEngine, greedy_sample,  # noqa: F401
                     latency_stats, percentile)

"""Shared abstract cache for the ``shard`` pass, as the reference's
``repro.analysis.abscache``.

The pass works on ``ParamSpec`` trees only, and needs the same objects
per architecture on every run (and on every injection rerun in tests):
the configs, the model definitions, and their parameter and decode-state
leaves.  This module memoises them so one ``python -m
repro_torch.analysis`` run builds each once; ``stats()`` reports the
hit counts.  Nothing here builds a tensor: a model object holds only its
config and its specs.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

from ..models.config import ParamSpec

# The reduced architecture the serving passes drive (in f32).
SMOKE_ARCH = "internlm2-1.8b"


@lru_cache(maxsize=None)
def config(arch: str):
    from .. import configs
    return configs.get(arch)


@lru_cache(maxsize=None)
def model(arch: str):
    """Full-size model object (specs only; no weights)."""
    from ..models import registry
    return registry.build(config(arch))


@lru_cache(maxsize=None)
def smoke_model():
    import torch

    from .. import configs
    from ..models import registry
    cfg = dataclasses.replace(configs.smoke(SMOKE_ARCH),
                              dtype=torch.float32)
    return registry.build(cfg)


def _named_leaves(specs: dict, path: str = "") -> tuple:
    """((keypath, ParamSpec), ...) in the reference's keystr form."""
    out = []
    for k in sorted(specs):
        v = specs[k]
        key = f"{path}['{k}']"
        if isinstance(v, dict):
            out.extend(_named_leaves(v, key))
        elif isinstance(v, ParamSpec):
            out.append((key, v))
    return tuple(out)


@lru_cache(maxsize=None)
def param_leaves(arch: str) -> tuple:
    """((keypath, ParamSpec), ...) for one architecture's parameters."""
    return _named_leaves(model(arch).param_specs)


@lru_cache(maxsize=None)
def cache_leaves(arch: str, batch: int, capacity: int) -> tuple:
    """((keypath, ParamSpec), ...) for the decode-state specs."""
    return _named_leaves(model(arch).cache_specs(batch, capacity))


_CACHED = (config, model, smoke_model, param_leaves, cache_leaves)


def stats() -> dict:
    """Per-entry lru_cache counters (the CLI's cache-sharing report)."""
    out = {}
    for fn in _CACHED:
        info = fn.cache_info()
        out[fn.__name__] = {"hits": info.hits, "misses": info.misses,
                            "size": info.currsize}
    return out


def clear() -> None:
    for fn in _CACHED:
        fn.cache_clear()

"""Architecture registry: ``--arch <id>`` resolves here.  Each module
defines CONFIG (the published configuration) and SMOKE (a reduced
same-family configuration for CPU tests)."""
from __future__ import annotations

import importlib

ARCHS = ("internlm2-1.8b",)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _mod(name).CONFIG


def smoke(name: str):
    return _mod(name).SMOKE

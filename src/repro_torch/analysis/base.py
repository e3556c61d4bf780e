"""Shared types of the analysis passes (``repro_torch.analysis``).

Every pass returns a flat list of :class:`Finding` records; the CLI
(``python -m repro_torch.analysis``) prints them and exits nonzero when a
pass found anything.  A finding names its pass, a stable rule id (the
reference's where the check is the same) and where it points: a
``file:line``, a lattice cell or a tile plan.
"""
from __future__ import annotations

import dataclasses
import os

# src/repro_torch/analysis/ -> the repository root
REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation found by a pass."""
    passname: str          # capability | blockmap | autotune | shard |
                           # sanitize | frontend
    rule: str              # stable rule id
    where: str             # file:line, lattice cell or plan
    message: str

    def __str__(self) -> str:
        return f"[{self.passname}:{self.rule}] {self.where}: {self.message}"


def rel(path: str) -> str:
    """The repository-relative form of a path."""
    try:
        return os.path.relpath(path, REPO_ROOT)
    except ValueError:
        return path

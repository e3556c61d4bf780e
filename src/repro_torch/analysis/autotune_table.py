"""Pass ``autotune``: the measured tile table plan resolution reads.

The table (``src/repro_torch/kernels/autotune_table.json``, written by
``python -m repro_torch.kernels.autotune`` on the card) puts measured
route plans into every packed matmul the cuda backend runs.  The runtime
loader is lenient by design: a doctored or stale table degrades to the
``gemv_plan`` / ``mma_plan`` rules with a warning, and serving goes on.
This pass is the loud half:

  * AT001 / AT002 / AT003: ``kernels.autotune.validate_table`` (structure
    and enums; each plan keeps the kernel's contract, the same
    ``ternary_matmul.plan_violations`` the wrappers and the ``blockmap``
    pass read; duplicate cells);
  * AT004: the table exists and covers every sweep cell (the reference's
    sweep and the main path's full-width cells, both packings, both
    domains) for the tracked card, ``autotune.TRACKED_DEVICE``;
  * AT005: the file is byte-identical to ``canonical_bytes`` of its own
    entries.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .base import Finding, rel

PASS = "autotune"


def run(table_path: Optional[str] = None) -> list:
    """Check the tracked table (or ``table_path``: violation injection);
    the default is the tracked file, never ``$REPRO_TORCH_AUTOTUNE_TABLE``
    (a test pointing the variable at a fixture must not mask it)."""
    from ..kernels import autotune
    path = table_path or autotune.DEFAULT_TABLE
    where = rel(path)
    if not os.path.exists(path):
        return [Finding(PASS, "AT004", where,
                        "autotune table is missing; measure it on the card "
                        "with `python -m repro_torch.kernels.autotune`")]
    try:
        with open(path) as f:
            text = f.read()
        payload = json.loads(text)
    except (OSError, ValueError) as e:
        return [Finding(PASS, "AT001", where,
                        f"table is not readable JSON: {e}")]
    findings = [Finding(PASS, rule, f"{where} {cell}", message)
                for rule, cell, message in autotune.validate_table(payload)]
    if findings:
        return findings          # coverage and bytes would only echo it
    entries = payload["entries"]
    have = {autotune._entry_key(e) for e in entries}
    for key in autotune.sweep_cells(autotune.TRACKED_DEVICE):
        if key not in have:
            m, k, n, phase, _, packing, domain, device = key
            findings.append(Finding(
                PASS, "AT004", where,
                f"stale table: sweep cell ({m},{k},{n}) {phase} "
                f"{packing}/{domain} has no measurement for {device!r}; "
                f"measure it with `python -m repro_torch.kernels.autotune`"))
    if text != autotune.canonical_bytes(entries):
        findings.append(Finding(
            PASS, "AT005", where,
            "table is not in canonical serialization (sorted cells, sorted "
            "keys, 2-space indent, trailing newline); `python -m "
            "repro_torch.kernels.autotune` writes it canonically"))
    return findings

"""Contract checks of the port: ``python -m repro_torch.analysis``.

The passes of the reference's ``repro.analysis`` that have a torch
meaning, each a ``run() -> list[Finding]``, with the reference's rule ids
where the check is the same:

  * ``capability``: the (op x backend x domain x packing x kv_layout x
    fidelity x platform) lattice of the live plan registry; declared
    cells resolve (and execute on the CPU, and on a card where there is
    one), undeclared cells fail loudly, ``auto`` picks the
    highest-priority backend, and the matrix in
    ``src/repro_torch/kernels/README.md`` matches (CAP001-CAP006).
  * ``blockmap``: the tile plans of ``ternary_matmul``'s routes over a
    shape sweep: tile sizes, K coverage, the float chain, shared memory
    (BM001-BM004).
  * ``autotune``: the measured tile table (AT001-AT005).
  * ``sanitize``: one transfer per chunk (per bucket) and no other sync,
    no new plan and no build after warm-up, on the four serving engines
    (SAN001-SAN002).  :func:`sanitize` is importable for tests and
    ``chip_smoke.py``.
  * ``frontend``: the serving front-end's transfer, backpressure and
    determinism contracts (FE001-FE003).
  * ``shard``: the placement contracts of ``repro_torch.dist`` over
    every (rules variant x mesh x config) cell, the logical axes named
    anywhere in ``src/repro_torch/``, and the axis table of
    ``src/repro_torch/dist/README.md`` (SD001-SD006), on the configs,
    models and leaves ``abscache`` memoises.

The reference's ``lint`` pass already scans this package (its
``rules.toml`` lints ``src``); ``jaxpr`` checks XLA artefacts whose
torch counterpart is not ported yet (ROADMAP queue 1 item 8).

``sanitize`` and ``frontend`` serve on the card by default and raise
without one; the tests pass ``device="cpu"``.
"""
from .base import Finding, rel  # noqa: F401
from .sanitizer import (SanitizeError, SanitizeReport,  # noqa: F401
                        sanitize)
from . import (abscache, autotune_table, blockmap,  # noqa: F401
               capability, frontend, sanitizer, shardspec)

# run order: the static passes first, the serving drivers last
PASSES = (("capability", capability.run),
          ("blockmap", blockmap.run),
          ("autotune", autotune_table.run),
          ("shard", shardspec.run),
          ("sanitize", sanitizer.run),
          ("frontend", frontend.run))

# pass name -> wall seconds of its last run in this process
LAST_TIMINGS: dict = {}


def run_all() -> list:
    """Every pass with its defaults; the findings of all."""
    findings = []
    for _, fn in PASSES:
        findings.extend(fn())
    return findings

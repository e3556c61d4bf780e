"""Pass ``capability``: the backend lattice of the port's plan registry.

Walks op x backend x domain x packing x kv_layout x fidelity x platform
(``cpu``, ``cuda``) over the LIVE registry of ``repro_torch.kernels`` and
proves, cell by cell (the reference's CAP rules):

  * CAP001: every declared cell resolves through ``plan_matmul`` to the
    backend it names;
  * CAP002: every declared ``cpu`` cell executes through ``execute`` at a
    tiny shape and returns (M, N) f32 (an attention plan: its (acc, m,
    l) f32 statistics).  ``cuda`` cells are resolved only where there is
    no card; with one (the chip phase) they execute too;
  * CAP003: every undeclared cell raises the loud "does not support"
    error of ``resolve_backend``;
  * CAP004: ``auto`` picks the highest-priority capable backend, and an
    empty cell raises "no registered backend";
  * CAP005: a packed trit2 weight under a ``cim`` plan is refused, naming
    base3 (the lattice has no axis for it: cim plans take float weights
    under any packing, packed ones in base3 only);
  * CAP006: the matrix committed in ``src/repro_torch/kernels/README.md``
    equals the one rendered from the registry (``--emit-matrix``).
"""
from __future__ import annotations

import os
import re
from typing import Optional

from .base import REPO_ROOT, Finding, rel

PASS = "capability"
README_PATH = os.path.join(REPO_ROOT, "src", "repro_torch", "kernels",
                           "README.md")

EVAL_SHAPE = (8, 64, 128)   # attention: 2 slots x 2 KV x 2 grouped queries,
                            # hd 64, 8 windows of 16 positions
MATRIX_COLUMNS = ("ops", "domains", "packings", "platforms", "kv layouts",
                  "fidelities")


def _registry():
    from ..kernels import plan as plan_mod
    plan_mod._ensure_builtin_backends()
    return dict(plan_mod._REGISTRY)


def _lattice_axes():
    from ..kernels.plan import (DOMAINS, FIDELITIES, KV_LAYOUTS, OPS,
                                PACKINGS, PLATFORMS)
    return OPS, DOMAINS, PACKINGS, KV_LAYOUTS, FIDELITIES, PLATFORMS


def _cell(name, op, domain, packing, kv_layout, fidelity, platform):
    return (f"op={op} backend={name} domain={domain} packing={packing} "
            f"kv_layout={kv_layout} fidelity={fidelity} platform={platform}")


def eval_operands(op: str, packing: str, device: str, shape=EVAL_SHAPE):
    """Seeded operands of one execution at ``shape`` on ``device`` (the
    ``abstract`` platform's are meta tensors)."""
    import torch
    from ..kernels import ops
    m, k, n = shape
    if device == "abstract":
        device = "meta"
    gen = torch.Generator().manual_seed(0)
    if op == "attention":
        from ..kernels.paged_attention import PagedAttentionKV
        s, kvh, rep, ps = 2, 2, 2, 16
        w = n // ps
        q = torch.randn(s, kvh, rep, k, generator=gen)
        pages = 1 + s * w
        kp = torch.randn(pages, ps, kvh, k, generator=gen)
        vp = torch.randn(pages, ps, kvh, k, generator=gen)
        table = torch.arange(1, pages, dtype=torch.int32).reshape(s, w)
        pos = torch.tensor([37, n], dtype=torch.int32)
        return q.to(device), PagedAttentionKV(kp.to(device), vp.to(device),
                                              table.to(device),
                                              pos.to(device))
    x = torch.randn(m, k, generator=gen).to(device)
    w = (0.05 * torch.randn(k, n, generator=gen)).to(device)
    if op == "cim":
        return x, w              # ternarized by the runner, any packing
    return x, ops.pack_weights(w, packing)


def _check_output(cell, op, out, shape) -> Optional[Finding]:
    import torch
    m, k, n = shape
    if op == "attention":
        got = tuple(tuple(o.shape) for o in out)
        want = ((2, 2, 2, k), (2, 2, 2), (2, 2, 2))
        if got != want or any(o.dtype != torch.float32 for o in out):
            return Finding(PASS, "CAP002", cell,
                           f"execute returned {got} "
                           f"{[str(o.dtype) for o in out]}, expected {want} "
                           f"float32 (acc, m, l)")
        return None
    if tuple(out.shape) != (m, n) or out.dtype != torch.float32:
        return Finding(PASS, "CAP002", cell,
                       f"execute returned {tuple(out.shape)} {out.dtype}, "
                       f"expected ({m}, {n}) float32")
    return None


def _check_declared_cell(name, op, domain, packing, kv_layout, fidelity,
                         platform, run_cuda: bool) -> Optional[Finding]:
    """A declared cell resolves; on the CPU (and on a card, where there
    is one) it executes."""
    from ..kernels import execute, plan_matmul
    cell = _cell(name, op, domain, packing, kv_layout, fidelity, platform)
    try:
        plan = plan_matmul(EVAL_SHAPE, platform=platform, op=op,
                           backend=name, domain=domain, packing=packing,
                           kv_layout=kv_layout, fidelity=fidelity)
    except (ValueError, TypeError) as e:
        return Finding(PASS, "CAP001", cell,
                       f"declared cell failed to resolve: {e!r}")
    if plan.backend != name:
        return Finding(PASS, "CAP001", cell,
                       f"resolved to backend {plan.backend!r}")
    if platform == "cuda" and not run_cuda:
        return None
    try:
        x, w = eval_operands(op, packing, platform)
        out = execute(plan, x, w)
    except (ValueError, TypeError, RuntimeError) as e:
        return Finding(PASS, "CAP002", cell,
                       f"declared cell failed to execute: {e!r}")
    return _check_output(cell, op, out, EVAL_SHAPE)


def _check_undeclared_cell(name, op, domain, packing, kv_layout, fidelity,
                           platform) -> Optional[Finding]:
    from ..kernels.plan import resolve_backend
    cell = _cell(name, op, domain, packing, kv_layout, fidelity, platform)
    try:
        resolve_backend(op, name, domain, packing, platform, kv_layout,
                        fidelity)
    except ValueError as e:
        if "does not support" not in str(e):
            return Finding(PASS, "CAP003", cell,
                           f"capability rejection lost the loud 'does not "
                           f"support' message: {e}")
        return None
    return Finding(PASS, "CAP003", cell,
                   "undeclared cell resolved without a capability error")


def _check_auto_cell(registry, op, domain, packing, kv_layout, fidelity,
                     platform) -> Optional[Finding]:
    from ..kernels.plan import resolve_backend
    cell = _cell("auto", op, domain, packing, kv_layout, fidelity, platform)
    capable = [s for s in registry.values()
               if s.supports(op, domain, packing, platform, kv_layout,
                             fidelity)]
    try:
        spec = resolve_backend(op, "auto", domain, packing, platform,
                               kv_layout, fidelity)
    except ValueError as e:
        if capable:
            return Finding(PASS, "CAP004", cell,
                           f"auto failed on a capable cell: {e}")
        if "no registered backend" not in str(e):
            return Finding(PASS, "CAP004", cell,
                           f"empty cell lost the loud no-capable-backend "
                           f"message: {e}")
        return None
    if not capable:
        return Finding(PASS, "CAP004", cell,
                       f"auto resolved {spec.name!r} on an empty cell")
    best = max(capable, key=lambda s: s.priority)
    if spec.name != best.name:
        return Finding(PASS, "CAP004", cell,
                       f"auto picked {spec.name!r} (priority "
                       f"{spec.priority}) over {best.name!r} (priority "
                       f"{best.priority})")
    return None


def _check_cim_packed_trit2_rejection() -> list:
    import torch
    from ..kernels import execute, ops, plan_matmul
    m, k, n = EVAL_SHAPE
    plan = plan_matmul(EVAL_SHAPE, platform="cpu", op="cim")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=gen)
    w = ops.pack_weights(torch.randn(k, n, generator=gen), "trit2")
    try:
        execute(plan, x, w)
    except ValueError as e:
        if "base3" in str(e):
            return []
        return [Finding(PASS, "CAP005", "op=cim packed=trit2",
                        f"rejection does not name base3: {e}")]
    return [Finding(PASS, "CAP005", "op=cim packed=trit2",
                    "a trit2-packed weight was accepted by a cim plan")]


# ----------------------------------------------------- the README matrix

def render_capability_matrix(notes: Optional[dict] = None) -> str:
    """The markdown capability table of the live registry, highest
    priority first (the order ``auto`` prefers).  ``notes`` maps a
    backend to its notes cell."""
    notes = notes or {}
    head = ("| backend | ops | domains | packings | platforms "
            "| kv layouts | fidelities | notes |")
    sep = ("|---------|-----|---------|----------|-----------"
           "|------------|------------|-------|")
    rows = [head, sep]
    for spec in sorted(_registry().values(),
                       key=lambda s: (-s.priority, s.name)):
        cells = [f"`{spec.name}`"]
        for vals in (spec.ops, spec.domains, spec.packings, spec.platforms,
                     spec.kv_layouts, spec.fidelities):
            cells.append(", ".join(sorted(vals)))
        cells.append(notes.get(spec.name, ""))
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def parse_capability_matrix(text: str) -> dict:
    """backend -> {column -> frozenset} of the machine-checked columns of
    the first table whose header starts with 'backend'; ValueError where
    there is none."""
    lines = text.splitlines()
    header = None
    for i, line in enumerate(lines):
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if cells and cells[0].lower() == "backend":
            header, start = [c.lower() for c in cells], i
            break
    if header is None:
        raise ValueError("no capability matrix table (header row starting "
                         "with 'backend') found")
    missing = [c for c in MATRIX_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"capability matrix is missing columns {missing}; "
                         f"has {header}")
    out = {}
    for line in lines[start + 2:]:
        if not line.strip().startswith("|"):
            break
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) < len(header):
            break
        row = dict(zip(header, cells))
        out[row["backend"].strip("`")] = {
            col: frozenset(v.strip() for v in row[col].split(",")
                           if v.strip())
            for col in MATRIX_COLUMNS}
    if not out:
        raise ValueError("capability matrix table has no backend rows")
    return out


def parse_matrix_notes(text: str) -> dict:
    """backend -> notes cell of a committed matrix (to render it again)."""
    notes = {}
    for line in text.splitlines():
        m = re.match(r"\|\s*`([a-z0-9_]+)`\s*\|", line)
        if m:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            notes[m.group(1)] = cells[-1]
    return notes


def check_readme_matrix(registry, readme_path: str) -> list:
    findings = []
    where = rel(readme_path)
    try:
        with open(readme_path) as f:
            table = parse_capability_matrix(f.read())
    except (OSError, ValueError) as e:
        return [Finding(PASS, "CAP006", where,
                        f"cannot check the capability matrix: {e}")]
    for name in sorted(set(registry) - set(table)):
        findings.append(Finding(PASS, "CAP006", where,
                                f"registered backend {name!r} missing from "
                                f"the capability matrix"))
    for name in sorted(set(table) - set(registry)):
        findings.append(Finding(PASS, "CAP006", where,
                                f"matrix documents unregistered backend "
                                f"{name!r}"))
    attr = {"ops": "ops", "domains": "domains", "packings": "packings",
            "platforms": "platforms", "kv layouts": "kv_layouts",
            "fidelities": "fidelities"}
    for name in sorted(set(table) & set(registry)):
        for col, field in attr.items():
            want = frozenset(getattr(registry[name], field))
            got = table[name][col]
            if want != got:
                findings.append(Finding(
                    PASS, "CAP006", where,
                    f"backend {name!r} column {col!r} drifted: matrix says "
                    f"{sorted(got)}, registry says {sorted(want)}"))
    return findings


# ------------------------------------------------------------- runner

def run(readme_path: Optional[str] = None, registry: Optional[dict] = None,
        run_cuda: Optional[bool] = None) -> list:
    """The whole pass; findings (empty = clean).  ``run_cuda`` executes
    the declared ``cuda`` cells too (default: where a card is present)."""
    import torch
    registry = registry if registry is not None else _registry()
    if run_cuda is None:
        run_cuda = torch.cuda.is_available()
    ops_, domains, packings, kv_layouts, fidelities, platforms = \
        _lattice_axes()
    findings = []
    for op in ops_:
        for domain in domains:
            for packing in packings:
                for kv_layout in kv_layouts:
                    for fidelity in fidelities:
                        for platform in platforms:
                            for name, spec in sorted(registry.items()):
                                if spec.supports(op, domain, packing,
                                                 platform, kv_layout,
                                                 fidelity):
                                    f = _check_declared_cell(
                                        name, op, domain, packing,
                                        kv_layout, fidelity, platform,
                                        run_cuda)
                                else:
                                    f = _check_undeclared_cell(
                                        name, op, domain, packing,
                                        kv_layout, fidelity, platform)
                                if f:
                                    findings.append(f)
                            f = _check_auto_cell(registry, op, domain,
                                                 packing, kv_layout,
                                                 fidelity, platform)
                            if f:
                                findings.append(f)
    findings += _check_cim_packed_trit2_rejection()
    findings += check_readme_matrix(registry, readme_path or README_PATH)
    return findings

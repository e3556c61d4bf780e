"""`shard` - the sharding-contract prover (SD001-SD006), as the
reference's ``repro.analysis.shardspec``.

Every parameter, cache, slot pool and page pool of the port carries
logical axis names (``ParamSpec.axes``) that resolve to physical mesh
axes through one rules engine (``repro_torch.dist``).  This pass proves
the placement contracts over the live lattice - every ``(rules variant
x mesh x model config)`` cell enumerated from ``dist.variants`` -
entirely abstractly: ``Rules`` and ``MeshSpec`` carry no devices, and
nothing is allocated.

| rule  | contract |
|-------|----------|
| SD001 | every axes tuple on every sharding surface resolves through ``logical_to_spec`` without raising (unknown axes, rank mismatches) |
| SD002 | each resolved spec independently re-verifies: physical axes exist, no axis reused across dims, divisibility holds, quantum units never split, zero-size dims never shard |
| SD003 | no parameter above ``REPLICATION_FLOOR`` elements is fully replicated on a multi-card mesh under an fsdp variant (pure-dp variants are exempt by design - see ``dist.variants.REPLICATING_VARIANTS``) |
| SD004 | ``slot_spmd_axes``/``page_spmd_axes`` agree with ``logical_to_spec`` on the pool axis for every variant, mesh and pool size |
| SD005 | every logical axis named in a ``ParamSpec``/``constrain_act``/``constrain``/``logical_to_spec``/``place`` call anywhere in ``src/repro_torch/`` is known to the rules engine (AST sweep - catches typo'd axes that would silently replicate) |
| SD006 | the logical-axis table in ``src/repro_torch/dist/README.md`` matches the live ``train_rules``/``serve_rules`` maps (CAP006-style drift check; regenerate with ``--emit-axes``) |

Violation injection (tests / ``--inject-shard``): ``resolve``,
``spec``, ``replicate``, ``mirror``, ``axis``, ``drift`` - each trips
exactly its rule against the otherwise-clean tree.
"""
from __future__ import annotations

import ast
import math
import os
from typing import Iterator, Optional

from .base import REPO_ROOT, Finding, rel
from . import abscache

PASS = "shard"

# Fully-replicated parameters at or above this many elements on a
# multi-card mesh are findings (SD003).  The floor sits above the
# largest deliberate replication (xlstm's per-head recurrent weight
# `wr`, ~3.5M elements, whose output reshapes across any axis we could
# shard) and below every real weight matrix.
REPLICATION_FLOOR = 1 << 22

# Synthetic cell the non-parameter surfaces are sized with.  Sizes are
# arbitrary (resolution must hold for ANY size by the folding policy);
# these are chosen DP-divisible so SD003-adjacent replication noise
# does not mask findings.
_BATCH, _SEQ, _SLOTS, _PAGE_SIZE = 32, 256, 32, 16

# Call targets of the SD005 axis sweep: callable terminal name -> the
# positional index / keyword of its logical-axes argument.
_AXIS_CALL_SITES = {
    "ParamSpec": (3, "axes"),
    "constrain_act": (1, "axes"),
    "constrain": (1, "axes"),
    "logical_to_spec": (0, "axes"),
    "place": (1, "axes"),
}


def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _known_axes() -> frozenset:
    from ..dist import sharding as shd
    return frozenset(shd.train_rules().axis_map) | \
        frozenset(shd.serve_rules().axis_map)


# ---------------------------------------------------------------------
# surfaces: every (axes, shape) pair a config puts through the engine
# ---------------------------------------------------------------------

def _surfaces(arch: str) -> Iterator[tuple[str, tuple, tuple]]:
    """Yield (label, axes, shape) for every sharding surface of one
    architecture: parameters, decode caches, the pooled slot state,
    the paged block pool, and the activation-constraint layouts."""
    cfg = abscache.config(arch)
    for key, d in abscache.param_leaves(arch):
        yield f"params{key}", d.axes, d.shape
    for key, d in abscache.cache_leaves(arch, _BATCH, _SEQ):
        yield f"cache{key}", d.axes, d.shape
    # continuous-batching slot pool: batch-1 caches stacked on 'slot'
    # (the Scheduler's pool layout)
    for key, d in abscache.cache_leaves(arch, 1, _SEQ):
        yield (f"slot_pool{key}", ("slot",) + d.axes,
               (_SLOTS,) + d.shape)
    yield "slot_pool.lanes", ("slot",), (_SLOTS,)
    # paged-KV block pool (the PagedScheduler's pool layout)
    pages = 1 + _SLOTS * (-(-_SEQ // _PAGE_SIZE))
    pshape = (cfg.num_layers, pages, _PAGE_SIZE, cfg.num_kv_heads,
              cfg.hd)
    paxes = ("layers", "page", "none", "kv", "none")
    yield "page_pool.kv_pages", paxes, pshape
    yield "page_pool.scale_pages", paxes[:-1], pshape[:-1]
    yield ("page_pool.table", ("slot", "none"),
           (_SLOTS, -(-_SEQ // _PAGE_SIZE)))
    # activation constraint layouts (constrain_act default + the batch
    # spec layouts train/prefill/decode anchor)
    d = cfg.d_model
    yield "act.residual", ("batch", "seq", "none"), (_BATCH, _SEQ, d)
    yield "act.tokens", ("batch", "seq"), (_BATCH, _SEQ)
    yield ("act.frontend", ("batch", "seq", "act_embed"),
           (_BATCH, _SEQ, d))
    yield "act.decode_token", ("batch", "none"), (_BATCH, 1)
    yield "act.row_lane", ("batch",), (_BATCH,)


# ---------------------------------------------------------------------
# SD002: independent spec re-verification
# ---------------------------------------------------------------------

def check_spec(axes: tuple, shape: tuple, spec, sizes: dict,
               quantum: Optional[dict]) -> list[str]:
    """Re-verify one resolved spec against the invariants the
    engine promises, WITHOUT consulting the engine's own resolution
    code - the arithmetic here is the proof, logical_to_spec is the
    subject.  Returns human-readable problems (empty = holds)."""
    problems = []
    entries = tuple(spec)
    if len(entries) > len(shape):
        problems.append(f"spec {spec} has more entries than rank "
                        f"{len(shape)}")
        return problems
    used: dict[str, int] = {}
    for i, entry in enumerate(entries):
        if entry is None:
            continue
        axs = (entry,) if isinstance(entry, str) else tuple(entry)
        dim = shape[i]
        for a in axs:
            if a not in sizes:
                problems.append(f"dim {i} sharded over {a!r} which is "
                                f"not a mesh axis {sorted(sizes)}")
            used.setdefault(a, 0)
            used[a] += 1
        if dim == 0:
            problems.append(f"dim {i} has size 0 but spec shards it "
                            f"over {axs}")
            continue
        prod = math.prod(sizes.get(a, 1) for a in axs)
        q = (quantum or {}).get(axes[i], 1)
        if dim % q:
            problems.append(
                f"dim {i} ({axes[i]!r}, size {dim}) is not whole in "
                f"quantum units of {q} yet shards over {axs}")
        elif (dim // q) % prod:
            problems.append(
                f"dim {i} ({axes[i]!r}, size {dim}, quantum {q}) does "
                f"not divide over {axs} (fold size {prod})")
    for a, n in sorted(used.items()):
        if n > 1:
            problems.append(f"mesh axis {a!r} reused across {n} dims")
    return problems


# ---------------------------------------------------------------------
# SD001/SD002/SD003: the lattice walk
# ---------------------------------------------------------------------

def _walk_lattice(archs, inject: Optional[str]) -> list[Finding]:
    from ..dist import mesh as mesh_lib
    from ..dist import sharding as shd
    from ..dist import variants as var

    findings = []
    for arch in archs:
        cfg = abscache.config(arch)
        surfaces = list(_surfaces(arch))
        if inject == "resolve" and arch == archs[0]:
            surfaces.append(("injected.bogus", ("sequence",), (8,)))
        if inject == "replicate" and arch == archs[0]:
            surfaces.append(("injected.big_replicated",
                             ("none", "none"), (2048, 2048)))
        for cell in var.enumerate_variants(cfg):
            for mesh in var.MESHES:
                sizes = mesh_lib.axis_sizes(mesh)
                where_cell = f"{arch} {cell.tag} @ {_mesh_tag(mesh)}"
                for label, axes, shape in surfaces:
                    try:
                        spec = shd.logical_to_spec(axes, shape,
                                                   cell.rules, mesh)
                    except Exception as e:
                        findings.append(Finding(
                            PASS, "SD001", f"{where_cell} {label}",
                            f"axes {axes} x shape {shape} does not "
                            f"resolve: {type(e).__name__}: {e}"))
                        continue
                    if inject == "spec" and label == "act.tokens":
                        spec = ("model", "model")
                    for problem in check_spec(axes, shape, spec, sizes,
                                              cell.rules.quantum):
                        findings.append(Finding(
                            PASS, "SD002", f"{where_cell} {label}",
                            f"resolved spec {spec} violates the "
                            f"engine's invariants: {problem}"))
                    if (cell.fsdp
                            and cell.variant not in
                            var.REPLICATING_VARIANTS
                            and label.startswith(("params",
                                                  "injected."))
                            and not len(spec)
                            and math.prod(shape) >= REPLICATION_FLOOR):
                        findings.append(Finding(
                            PASS, "SD003", f"{where_cell} {label}",
                            f"parameter of {math.prod(shape)} elements "
                            f"(shape {shape}, axes {axes}) is fully "
                            f"replicated on a "
                            f"{math.prod(mesh.shape)}-card mesh"))
    return findings


# ---------------------------------------------------------------------
# SD004: the spmd-axes mirrors
# ---------------------------------------------------------------------

def _norm_entry(entry):
    if entry is None or isinstance(entry, str):
        return entry
    return tuple(entry)


def _check_mirrors(inject: Optional[str]) -> list[Finding]:
    from ..dist import sharding as shd
    from ..dist import variants as var

    cfg = abscache.config(abscache.SMOKE_ARCH)
    findings = []
    mirrors = (("slot", shd.slot_spmd_axes),
               ("page", shd.page_spmd_axes))
    for cell in var.enumerate_variants(cfg):
        for mesh in var.MESHES:
            for count in (1, 2, 8, 32, 512, 544):
                for axis, fn in mirrors:
                    spec = shd.logical_to_spec((axis,), (count,),
                                               cell.rules, mesh)
                    want = _norm_entry(spec[0] if len(spec) else None)
                    got = _norm_entry(fn(cell.rules, mesh, count))
                    if inject == "mirror" and axis == "slot" \
                            and got is None:
                        got = "model"
                    if want != got:
                        findings.append(Finding(
                            PASS, "SD004",
                            f"{cell.tag} @ {_mesh_tag(mesh)} "
                            f"{axis}={count}",
                            f"{fn.__name__} returned {got!r} but "
                            f"logical_to_spec resolves the {axis!r} "
                            f"axis to {want!r}"))
    return findings


# ---------------------------------------------------------------------
# SD005: the AST axis sweep
# ---------------------------------------------------------------------

def _call_name(func) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _axes_strings(node) -> Iterator[tuple[int, str]]:
    """(lineno, name) for every string element of a tuple literal
    anywhere inside an axes-argument expression - handles the
    ``("batch",) + d.axes`` / ``("none",) * k`` composition idioms."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Tuple, ast.List)):
            for elt in sub.elts:
                if isinstance(elt, ast.Constant) \
                        and isinstance(elt.value, str):
                    yield elt.lineno, elt.value


def sweep_axes(paths: tuple, known: frozenset) -> list[Finding]:
    """Walk python files for axis-bearing call sites and prove every
    literal logical-axis name is known to the rules engine."""
    findings = []
    files = []
    for root in paths:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, _dirs, names in os.walk(root):
            files.extend(os.path.join(dirpath, n)
                         for n in sorted(names) if n.endswith(".py"))
    for path in files:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        findings.extend(sweep_axes_source(source, rel(path), known))
    return findings


def sweep_axes_source(source: str, rel_path: str,
                      known: frozenset) -> list[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(PASS, "SD005", f"{rel_path}:{e.lineno}",
                        f"cannot sweep axes: {e.msg}")]
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name not in _AXIS_CALL_SITES:
            continue
        pos, kw = _AXIS_CALL_SITES[name]
        arg = None
        if len(node.args) > pos:
            arg = node.args[pos]
        else:
            for k in node.keywords:
                if k.arg == kw:
                    arg = k.value
        if arg is None:
            continue
        for lineno, axis in _axes_strings(arg):
            if axis not in known:
                findings.append(Finding(
                    PASS, "SD005", f"{rel_path}:{lineno}",
                    f"{name}() names logical axis {axis!r} unknown to "
                    f"the rules engine (known: {sorted(known)}) - a "
                    f"typo here silently replicates"))
    return findings


# ---------------------------------------------------------------------
# SD006: the dist/README.md axis table
# ---------------------------------------------------------------------

_AXIS_TABLE_COLUMNS = ("logical axis", "train", "serve")


def _fmt_physical(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, str):
        return f"`{v}`"
    return "`" + ", ".join(v) + "`"


def _parse_physical(cell: str):
    cell = cell.strip().strip("`")
    if cell in ("-", ""):
        return None
    if "," in cell:
        return tuple(a.strip() for a in cell.split(","))
    return cell


def render_axis_table(notes: Optional[dict] = None) -> str:
    """The markdown logical-axis table, generated from the live rule
    sets (``--emit-axes``).  ``notes`` maps axis -> prose cell."""
    from ..dist import sharding as shd
    notes = notes or {}
    train = shd.train_rules().axis_map
    serve = shd.serve_rules().axis_map
    rows = ["| logical axis | train | serve | notes |",
            "|--------------|-------|-------|-------|"]
    for axis in train:       # insertion order groups act/param axes
        rows.append("| " + " | ".join(
            (f"`{axis}`", _fmt_physical(train[axis]),
             _fmt_physical(serve[axis]), notes.get(axis, ""))) + " |")
    return "\n".join(rows)


def parse_axis_table(text: str) -> dict:
    """axis -> {"train": ..., "serve": ...} out of README markdown."""
    lines = text.splitlines()
    header = None
    for i, line in enumerate(lines):
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if cells and cells[0].lower() == "logical axis":
            header = [c.lower() for c in cells]
            start = i
            break
    if header is None:
        raise ValueError("no logical-axis table (header row starting "
                         "with 'logical axis') found")
    missing = [c for c in _AXIS_TABLE_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"logical-axis table is missing columns "
                         f"{missing}; has {header}")
    out = {}
    for line in lines[start + 2:]:
        if not line.strip().startswith("|"):
            break
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) < len(_AXIS_TABLE_COLUMNS):
            break
        row = dict(zip(header, cells))
        out[row["logical axis"].strip("`")] = {
            "train": _parse_physical(row["train"]),
            "serve": _parse_physical(row["serve"])}
    if not out:
        raise ValueError("logical-axis table has no axis rows")
    return out


def parse_axis_notes(text: str) -> dict:
    """axis -> notes cell of an existing table (for re-rendering)."""
    lines = text.splitlines()
    notes = {}
    for line in lines:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) >= 4 and cells[0].startswith("`") \
                and not cells[0].startswith("`logical"):
            notes[cells[0].strip("`")] = cells[3]
    return notes


DIST_README = os.path.join(REPO_ROOT, "src", "repro_torch", "dist",
                           "README.md")


def _check_readme_axes(readme_path: str) -> list[Finding]:
    from ..dist import sharding as shd
    where = rel(readme_path)
    try:
        with open(readme_path, encoding="utf-8") as f:
            table = parse_axis_table(f.read())
    except (OSError, ValueError) as e:
        return [Finding(PASS, "SD006", where,
                        f"cannot check logical-axis table: {e}")]
    findings = []
    live = {"train": shd.train_rules().axis_map,
            "serve": shd.serve_rules().axis_map}
    documented = set(table)
    for axis in sorted(set(live["train"]) - documented):
        findings.append(Finding(
            PASS, "SD006", where,
            f"logical axis {axis!r} missing from the README table"))
    for axis in sorted(documented - set(live["train"])):
        findings.append(Finding(
            PASS, "SD006", where,
            f"README table documents unknown logical axis {axis!r}"))
    for axis in sorted(documented & set(live["train"])):
        for mode in ("train", "serve"):
            want = live[mode][axis]
            want = tuple(want) if isinstance(want, (list, tuple)) \
                else want
            got = table[axis][mode]
            if want != got:
                findings.append(Finding(
                    PASS, "SD006", where,
                    f"axis {axis!r} {mode} mapping drifted: README "
                    f"says {got!r}, engine says {want!r} (regenerate "
                    f"with --emit-axes)"))
    return findings


# ------------------------------------------------------------- runner

def run(inject: Optional[str] = None,
        readme_path: Optional[str] = None,
        scan_paths: Optional[tuple] = None,
        archs: Optional[tuple] = None) -> list[Finding]:
    """Run the full shard pass; returns findings (empty = clean).

    ``inject`` seeds one violation (resolve/spec/replicate/mirror/
    axis/drift) for the gate-gates-itself tests; ``scan_paths``
    overrides the SD005 sweep roots (default: ``src/repro_torch/``)."""
    from .. import configs

    archs = tuple(archs if archs is not None else configs.ARCHS)
    findings = _walk_lattice(archs, inject)
    findings.extend(_check_mirrors(inject))

    known = _known_axes()
    paths = tuple(scan_paths) if scan_paths is not None \
        else (os.path.join(REPO_ROOT, "src", "repro_torch"),)
    findings.extend(sweep_axes(paths, known))
    if inject == "axis":
        findings.extend(sweep_axes_source(
            'w = ParamSpec((4, 4), axes=("embeddd", "mlp"))\n',
            "<injected>", known))

    readme = readme_path or DIST_README
    if inject == "drift":
        with open(readme, encoding="utf-8") as f:
            text = f.read().replace("| `embed` | `data` |",
                                    "| `embed` | `model` |")
        import tempfile
        with tempfile.NamedTemporaryFile(
                "w", suffix=".md", delete=False) as tmp:
            tmp.write(text)
            readme = tmp.name
        try:
            findings.extend(_check_readme_axes(readme))
        finally:
            os.unlink(readme)
    else:
        findings.extend(_check_readme_axes(readme))
    return findings

"""CLI of the port's analysis passes: ``python -m repro_torch.analysis``.

The exit status is the number of findings (at most 125), so any
violation fails.  The ``--inject-*`` options (and ``--pin-blocks``,
``--readme``, ``--autotune-table``) seed violations on purpose, so a
test, or a reader, can watch each pass catch its kind of fault.
``--format json`` / ``--out PATH`` give the findings as a document.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import (LAST_TIMINGS, PASSES, abscache, autotune_table, blockmap,
               capability, frontend, sanitizer, shardspec)

# --inject-blockmap: a plan pinned over the sweep that breaks one rule
BLOCKMAP_PINS = {"tile": (96, 2, 512),           # BM001 (and coverage)
                 "coverage": (128, 1, 64),       # BM002
                 "chain": (128, 1, 32768)}       # BM003


def _report_doc(per_pass: list, findings: list) -> dict:
    return {"passes": [{"name": name, "findings": n,
                        "seconds": round(dt, 3)}
                       for name, n, dt in per_pass],
            "findings": [{"pass": f.passname, "rule": f.rule,
                          "where": f.where, "message": f.message}
                         for f in findings],
            "ok": not findings}


def _doctored_readme(tmp: str, how: str) -> str:
    """A copy of the capability matrix with one seeded drift."""
    text = capability.render_capability_matrix()
    if how == "drift":
        text = text.replace("cpu, cuda", "cpu", 1)
    else:                                        # missing: drop a row
        text = "\n".join(ln for ln in text.splitlines() if "`ref`" not in ln)
    path = os.path.join(tmp, "README.md")
    with open(path, "w") as f:
        f.write("# doctored\n\n" + text + "\n")
    return path


def _doctored_table(tmp: str, how: str) -> str:
    """A copy of the tracked autotune table with one seeded fault."""
    from ..kernels import autotune
    entries = autotune.load_entries(autotune.DEFAULT_TABLE)
    payload = json.loads(autotune.canonical_bytes(entries))
    if how == "structure":
        payload["version"] = 99
    elif how == "invariant":
        payload["entries"][0]["blocks"] = [100, 3, 100]
    elif how == "duplicate":
        payload["entries"].append(dict(payload["entries"][0]))
    elif how == "coverage":
        payload["entries"] = payload["entries"][1:]
    text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
    if how == "canonical":
        text = json.dumps(payload)
    path = os.path.join(tmp, "autotune_table.json")
    with open(path, "w") as f:
        f.write(text)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract checks of the PyTorch port")
    names = [name for name, _ in PASSES]
    p.add_argument("--passes", default=None,
                   help=f"comma-separated subset of {','.join(names)}; "
                        f"default all")
    p.add_argument("--list", action="store_true",
                   help="list the passes (with their wall times when run in "
                        "this process) and exit")
    p.add_argument("--format", default="text", choices=("text", "json"),
                   dest="fmt")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the findings JSON document here")
    p.add_argument("--emit-matrix", action="store_true",
                   help="print the registry's capability matrix (for "
                        "src/repro_torch/kernels/README.md) and exit")
    p.add_argument("--emit-axes", action="store_true",
                   help="print the rules engine's logical-axis table (for "
                        "src/repro_torch/dist/README.md) and exit")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="sanitize / frontend: where to serve (default: the "
                        "card; raises without one)")
    p.add_argument("--readme", default=None, metavar="PATH",
                   help="capability: check this README's matrix")
    p.add_argument("--autotune-table", default=None, metavar="PATH",
                   help="autotune: check this table")
    p.add_argument("--pin-blocks", default=None, metavar="A,B,C",
                   help="blockmap: pin this plan over the sweep")
    p.add_argument("--inject-capability", default=None,
                   choices=("drift", "missing"),
                   help="capability: check a matrix with a drifted column "
                        "or a missing backend (CAP006)")
    p.add_argument("--inject-blockmap", default=None,
                   choices=sorted(BLOCKMAP_PINS),
                   help="blockmap: pin a plan with a bad tile size (BM001), "
                        "K coverage (BM002) or float chain (BM003)")
    p.add_argument("--inject-autotune", default=None,
                   choices=("structure", "invariant", "duplicate",
                            "coverage", "canonical"),
                   help="autotune: check a copy of the tracked table with "
                        "one fault (AT001-AT005)")
    p.add_argument("--inject-sanitize", default=None,
                   choices=("transfer", "replan"),
                   help="sanitize: an extra transfer (SAN001) or a new "
                        "plan after warm-up (SAN002)")
    p.add_argument("--inject-shard", default=None,
                   choices=("resolve", "spec", "replicate", "mirror",
                            "axis", "drift"),
                   help="shard: an unresolvable axis (SD001), a bad spec "
                        "(SD002), a big replicated leaf (SD003), a mirror "
                        "disagreement (SD004), a typo'd axis (SD005), a "
                        "drifted README table (SD006)")
    p.add_argument("--inject-frontend", default=None,
                   choices=("transfer", "drop", "order"),
                   help="frontend: an extra streaming transfer (FE001), a "
                        "lost reject (FE002), a perturbed order (FE003)")
    args = p.parse_args(argv)

    if args.list:
        for name in names:
            dt = LAST_TIMINGS.get(name)
            print(f"{name:12s}" + (f"{dt:8.2f}s" if dt is not None
                                   else "       -"))
        return 0
    if args.emit_matrix:
        print(capability.render_capability_matrix(
            capability.parse_matrix_notes(open(capability.README_PATH).read())
            if os.path.exists(capability.README_PATH) else None))
        return 0
    if args.emit_axes:
        readme = shardspec.DIST_README
        print(shardspec.render_axis_table(
            shardspec.parse_axis_notes(open(readme).read())
            if os.path.exists(readme) else None))
        return 0
    selected = ([s.strip() for s in args.passes.split(",") if s.strip()]
                if args.passes else names)
    unknown = [s for s in selected if s not in names]
    if unknown:
        p.error(f"unknown pass(es) {unknown}; choose from {names}")
    pin = None
    if args.pin_blocks:
        try:
            pin = tuple(int(v) for v in args.pin_blocks.split(","))
            if len(pin) != 3:
                raise ValueError(args.pin_blocks)
        except ValueError:
            p.error("--pin-blocks wants three ints: A,B,C")
    if args.inject_blockmap:
        pin = BLOCKMAP_PINS[args.inject_blockmap]

    with tempfile.TemporaryDirectory() as tmp:
        readme = (_doctored_readme(tmp, args.inject_capability)
                  if args.inject_capability else args.readme)
        table = (_doctored_table(tmp, args.inject_autotune)
                 if args.inject_autotune else args.autotune_table)
        runners = {
            "capability": lambda: capability.run(readme_path=readme),
            "blockmap": lambda: blockmap.run(pin_blocks=pin),
            "autotune": lambda: autotune_table.run(table_path=table),
            "shard": lambda: shardspec.run(inject=args.inject_shard),
            "sanitize": lambda: sanitizer.run(
                inject=(args.inject_sanitize,) if args.inject_sanitize
                else (), device=args.device),
            "frontend": lambda: frontend.run(
                inject=(args.inject_frontend,) if args.inject_frontend
                else (), device=args.device),
        }
        text = args.fmt == "text"
        findings, per_pass = [], []
        for name in names:
            if name not in selected:
                continue
            t0 = time.monotonic()
            got = runners[name]()
            dt = time.monotonic() - t0
            LAST_TIMINGS[name] = dt
            per_pass.append((name, len(got), dt))
            if text:
                print(f"[{name}] {len(got)} finding(s) ({dt:.2f}s)",
                      flush=True)
            findings.extend(got)
    if text and "shard" in selected:
        hits = sum(v["hits"] for v in abscache.stats().values())
        print(f"[abscache] {hits} hit(s)", flush=True)
    doc = _report_doc(per_pass, findings)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    if text:
        for f in findings:
            print(f" {f}")
        print(f"FAIL: {len(findings)} finding(s)" if findings
              else "OK: all passes clean")
    else:
        json.dump(doc, sys.stdout, indent=1)
        print()
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())

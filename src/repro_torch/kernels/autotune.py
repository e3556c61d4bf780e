"""Measured tile autotuner for the tensor-core routes of ``ternary_matmul``.

``gemv_plan`` and ``mma_plan`` (``kernels/ternary_matmul.py``) are fixed
rules: they reckon from M, K, N and the SM count but never run anything.
This module closes the loop: :func:`tune` races the plans each route's
kernel takes, per ``(shape, phase, platform, packing, domain)`` cell, on
the card that will serve them, and writes the winners to a
schema-checked JSON table, ``autotune_table.json`` beside this file
(tracked in the repository).

A table entry's ``blocks`` is the route plan the wrapper hands its
launcher:

  * ``gemv`` (M <= 8, decode): ``(block_n, cluster, k_per_split)``, every
    ``GEMV_BLOCK_NS`` x ``GEMV_CLUSTERS`` pair whose cluster leaves no
    rank empty;
  * ``mma`` (M > 8, prefill): ``(block_m, splits, k_per_split)``, block_m
    128 or 256, split counts from 1 up to K's stages (powers of two, and
    the rule's own) while the grid stays within 4 blocks an SM, none past
    ``MMA_FLOAT_CHAIN`` in the float domain.

The rule's plan is always raced first and kept unless a candidate beats
it by more than the spread of the timings.  The cuda_core route (f32 x)
and the other kernels keep their rules.  An entry also names the card
(``device``, ``torch.cuda.get_device_name()``), so a table measured on
one card never steers another, and keeps the rule's plan and time
(``heuristic_blocks``, ``heuristic_time_s``).

Plan resolution (``plan._resolve``) reads the table through
:func:`lookup_blocks` for ternary plans of the cuda backend, keyed by the
phase the route implies (:func:`route_phase`) and the K the kernel sees.
A hit puts the measured plan into ``ExecutionPlan.blocks``
(``block_source='autotune'``); a miss leaves ``blocks=None``, so the
wrapper applies its rule, and is logged once per cell.  An invalid table
degrades to the rules with a warning; the ``autotune`` analysis pass
(``python -m repro_torch.analysis``) is where it fails loudly (AT001
structure, AT002 the kernels' invariants, AT003 duplicate cells, AT004
coverage of the sweep on the tracked card, AT005 canonical bytes).

``python -m repro_torch.kernels.autotune [--out PATH] [--fast]`` measures
on the current card and writes the canonical table (entries of other
cells and cards are kept); it needs a CUDA device.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
from typing import Optional

TABLE_VERSION = 1
ENV_VAR = "REPRO_TORCH_AUTOTUNE_TABLE"
DEFAULT_TABLE_BASENAME = "autotune_table.json"
DEFAULT_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             DEFAULT_TABLE_BASENAME)

PLATFORMS = ("cuda",)                 # only the cuda backend takes tiles
TABLE_PHASES = ("decode", "prefill")  # the phase each route implies
TRACKED_DEVICE = "NVIDIA H100 80GB HBM3"    # the card the tracked table
                                            # must cover (AT004)

# the reference's sweep (src/repro/kernels/autotune.py), keyed here by the
# phase the route implies: its (16, 1024, 1024) "decode" cell is an mma
# (prefill) cell on the card
DECODE_SHAPES = ((1, 1024, 1024), (4, 1024, 1024), (8, 1024, 1024),
                 (16, 1024, 1024))
PREFILL_SHAPES = ((128, 1024, 1024), (256, 512, 1024))
# the main path's cells: every packed weight of the served model at a
# decode step of 8 slots and a prefill of 8 x 128 tokens
MAIN_ARCH = "internlm2-1.8b"
MAIN_DECODE_M = 8
MAIN_PREFILL_M = 1024

ENTRY_KEYS = ("m", "k", "n", "phase", "platform", "packing", "domain",
              "blocks", "time_s", "heuristic_blocks", "heuristic_time_s",
              "device")

SPIN_CYCLES = 2_000_000       # ~1 ms of device time ahead of each launch
FLUSH_BYTES = 256 * 2**20     # zeroed before each launch: a cold L2
FLOAT_TOL = 1e-4              # a candidate vs the rule's plan, of max|y|
MMA_MAX_WAVES = 4             # mma candidates: splits x tiles <= 4 x SMs

_LOG = logging.getLogger("repro_torch.kernels.autotune")

# path -> {cell key: blocks}; misses logged once per cell
_TABLE_CACHE: dict = {}
_MISSES_LOGGED: set = set()
_DEVICE_NAMES: dict = {}


def route_of(m: int) -> str:
    """The tensor-core route of M rows (bf16 or int8 x)."""
    from .ternary_matmul import GEMV_MAX_M
    return "gemv" if m <= GEMV_MAX_M else "mma"


def route_phase(m: int) -> str:
    """The phase a table cell is keyed by: ``decode`` for the gemv route,
    ``prefill`` for the mma route (the port's layers resolve their plans
    with ``phase='auto'``)."""
    return "decode" if route_of(m) == "gemv" else "prefill"


def current_device() -> Optional[str]:
    """The current card's name, or None without one."""
    import torch
    if not torch.cuda.is_available():
        return None
    idx = torch.cuda.current_device()
    if idx not in _DEVICE_NAMES:
        _DEVICE_NAMES[idx] = torch.cuda.get_device_name(idx)
    return _DEVICE_NAMES[idx]


def table_path() -> str:
    """The table read at plan resolution: ``$REPRO_TORCH_AUTOTUNE_TABLE``
    if set (the empty string disables the table), else the tracked
    ``autotune_table.json`` beside this module."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        return env
    return DEFAULT_TABLE


def cell_key(m: int, k: int, n: int, phase: str, platform: str,
             packing: str, domain: str, device: str = "") -> tuple:
    """The identity of a table cell; cells of one card sort as the
    reference's do."""
    return (int(m), int(k), int(n), str(phase), str(platform),
            str(packing), str(domain), str(device))


def _entry_key(e: dict) -> tuple:
    return cell_key(e["m"], e["k"], e["n"], e["phase"], e["platform"],
                    e["packing"], e["domain"], e.get("device", ""))


def validate_table(payload) -> list:
    """Contract check of a parsed table; ``(rule, where, message)``
    violations:

      * AT001 structure: the top level, each entry's keys and types, the
        enums (phase, platform, packing, domain), a named card;
      * AT002 invariants: the phase is the one the route of M implies,
        and each plan (``blocks`` and ``heuristic_blocks``) keeps the
        kernel's contract, ``ternary_matmul.plan_violations``: sizes the
        kernel has, splits covering K exactly in whole stages with none
        empty, the float chain, the shared memory;
      * AT003 duplicate cells (two winners for one cell and card).

    The runtime loader (violations degrade to the rules) and the
    analysis pass (violations fail it) share it."""
    from .plan import DOMAINS, PACKINGS
    from .ternary_matmul import plan_violations
    out = []
    if not isinstance(payload, dict):
        return [("AT001", "table", "payload is not a JSON object")]
    if payload.get("version") != TABLE_VERSION:
        out.append(("AT001", "table", f"version {payload.get('version')!r} "
                                      f"!= {TABLE_VERSION}"))
    entries = payload.get("entries")
    if not isinstance(entries, list):
        out.append(("AT001", "table", "'entries' is not a list"))
        return out
    seen = {}
    for i, e in enumerate(entries):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            out.append(("AT001", where, "entry is not an object"))
            continue
        missing = [key for key in ENTRY_KEYS if key not in e]
        if missing:
            out.append(("AT001", where, f"missing keys {missing}"))
            continue
        ok = True
        for key in ("m", "k", "n"):
            if (not isinstance(e[key], int) or isinstance(e[key], bool)
                    or e[key] < 1):
                out.append(("AT001", where,
                            f"{key}={e[key]!r} is not a positive int"))
                ok = False
        for key, choices in (("phase", TABLE_PHASES), ("packing", PACKINGS),
                             ("domain", DOMAINS), ("platform", PLATFORMS)):
            if e[key] not in choices:
                out.append(("AT001", where,
                            f"{key}={e[key]!r} not in {sorted(choices)}"))
                ok = False
        if not isinstance(e["device"], str) or not e["device"]:
            out.append(("AT001", where, f"device={e['device']!r} does not "
                                        f"name a card"))
            ok = False
        for key in ("time_s", "heuristic_time_s"):
            if (not isinstance(e[key], (int, float))
                    or isinstance(e[key], bool) or e[key] <= 0):
                out.append(("AT001", where,
                            f"{key}={e[key]!r} is not a positive number"))
                ok = False
        for key in ("blocks", "heuristic_blocks"):
            b = e[key]
            if (not isinstance(b, list) or len(b) != 3
                    or not all(isinstance(v, int) and not isinstance(v, bool)
                               and v > 0 for v in b)):
                out.append(("AT001", where, f"{key}={b!r} is not a triple "
                                            f"of positive ints"))
                ok = False
        if not ok:
            continue
        cell = (f"{where} ({e['m']},{e['k']},{e['n']}) {e['phase']} "
                f"{e['platform']} {e['packing']}/{e['domain']} "
                f"[{e['device']}]")
        route = route_of(e["m"])
        if e["phase"] != route_phase(e["m"]):
            out.append(("AT002", cell, f"phase {e['phase']!r} but M="
                                       f"{e['m']} takes the {route} route "
                                       f"({route_phase(e['m'])!r})"))
        for key in ("blocks", "heuristic_blocks"):
            for _, msg in plan_violations(route, e["m"], e["k"], e["n"],
                                          e["packing"], e["domain"],
                                          tuple(e[key])):
                out.append(("AT002", cell, f"{key}: {msg}"))
        key = _entry_key(e)
        if key in seen:
            out.append(("AT003", cell, f"duplicate cell (first at "
                                       f"entries[{seen[key]}])"))
        else:
            seen[key] = i
    return out


def load_table(path: Optional[str] = None) -> dict:
    """Parse and validate the table at ``path`` into ``cell_key ->
    blocks``.  A missing file is an empty table (every lookup a logged
    miss); an invalid one is an empty table with a warning: failing
    loudly is the analysis pass's job, serving keeps the rules."""
    if path is None:
        path = table_path()
    if path in _TABLE_CACHE:
        return _TABLE_CACHE[path]
    table: dict = {}
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            _LOG.warning("autotune table %s unreadable (%s); using the "
                         "gemv_plan / mma_plan rules", path, e)
            payload = None
        if payload is not None:
            violations = validate_table(payload)
            if violations:
                _LOG.warning(
                    "autotune table %s fails validation (%d violations, "
                    "first: %s); using the gemv_plan / mma_plan rules",
                    path, len(violations), violations[0])
            else:
                for e in payload["entries"]:
                    table[_entry_key(e)] = tuple(e["blocks"])
    _TABLE_CACHE[path] = table
    return table


def lookup_blocks(m: int, k: int, n: int, phase: str, platform: str,
                  packing: str, domain: str,
                  device: Optional[str] = None) -> Optional[tuple]:
    """The measured plan of one cell on ``device`` (default: the current
    card), or None on a miss, which is logged once per cell: the table's
    gaps are visible, never silent."""
    if device is None:
        device = current_device() or ""
    key = cell_key(m, k, n, phase, platform, packing, domain, device)
    blocks = load_table().get(key)
    if blocks is None and key not in _MISSES_LOGGED:
        _MISSES_LOGGED.add(key)
        _LOG.info("autotune table miss for shape=(%d,%d,%d) phase=%s "
                  "platform=%s packing=%s domain=%s device=%r; the "
                  "wrapper's rule plans it", m, k, n, phase, platform,
                  packing, domain, device)
    return blocks


def reload_table() -> None:
    """Drop the cached table, the logged misses and the resolved plans,
    so the next lookup reads ``table_path()`` again (tests point
    ``$REPRO_TORCH_AUTOTUNE_TABLE`` at fixtures and call this)."""
    from .plan import plan_cache_clear
    _TABLE_CACHE.clear()
    _MISSES_LOGGED.clear()
    plan_cache_clear()


def canonical_bytes(entries: list) -> str:
    """Canonical JSON text of a set of entries: sorted by cell, sorted
    keys, two-space indent, a trailing newline; so save, load and save
    again is a byte-identical round trip."""
    entries = sorted(entries, key=_entry_key)
    payload = {"version": TABLE_VERSION, "entries": entries}
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def save_table(entries: list, path: Optional[str] = None) -> str:
    """Write the canonical table; refuses to write an invalid one."""
    if path is None:
        path = table_path()
    text = canonical_bytes(list(entries))
    violations = validate_table(json.loads(text))
    if violations:
        raise ValueError(f"refusing to save an invalid autotune table: "
                         f"{violations[0]}")
    with open(path, "w") as f:
        f.write(text)
    return path


def load_entries(path: Optional[str] = None) -> list:
    """The raw entry list at ``path`` (empty for a missing file)."""
    if path is None:
        path = table_path()
    if not (path and os.path.exists(path)):
        return []
    with open(path) as f:
        return json.load(f).get("entries", [])


def main_path_shapes() -> list:
    """(M, K, N) of every packed weight of the main path's model at a
    decode step (M = 8) and a prefill (M = 1024)."""
    from .. import configs
    cfg = configs.get(MAIN_ARCH)
    d, hd = cfg.d_model, cfg.hd
    pairs = [(d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
             (d, cfg.d_ff), (cfg.d_ff, d), (d, cfg.padded_vocab)]
    return ([(MAIN_DECODE_M, k, n) for k, n in pairs]
            + [(MAIN_PREFILL_M, k, n) for k, n in pairs])


def sweep_shapes(fast: bool = False) -> list:
    """The tuned (M, K, N): the main path's (``fast``), or the
    reference's sweep and then the main path's."""
    main = main_path_shapes()
    if fast:
        return main
    ref = list(DECODE_SHAPES) + list(PREFILL_SHAPES)
    return ref + [s for s in main if s not in ref]


def sweep_cells(device: str, fast: bool = False) -> list:
    """Every cell key of the sweep on ``device``."""
    from .plan import DOMAINS, PACKINGS
    return [cell_key(m, k, n, route_phase(m), "cuda", packing, domain,
                     device)
            for m, k, n in sweep_shapes(fast)
            for packing in PACKINGS for domain in DOMAINS]


def candidate_blocks(m: int, k: int, n: int, packing: str, domain: str,
                     sm_count: int, limit: Optional[int] = None) -> list:
    """The plans the route of M takes at one cell, the rule's first, then
    the others in order, each one the kernel takes (K is the extent the
    kernel sees)."""
    from . import ternary_matmul as tm
    route = route_of(m)
    if route == "gemv":
        heur = tm.gemv_plan(m, k, n, packing, sm_count)
        unit = tm.GEMV_STAGE_ROWS * (tm.TRIT2_PER_BYTE
                                     if packing == "trit2" else 1)
        stages = max(1, -(-k // unit))
        cands = [(bn, c, -(-stages // c) * unit)
                 for bn in sorted(tm.GEMV_BLOCK_NS)
                 for c in tm.GEMV_CLUSTERS]
    else:
        chain = tm.MMA_FLOAT_CHAIN if domain == "float" else None
        heur = tm.mma_plan(m, k, n, sm_count, chain)
        chunks = max(1, -(-k // tm.MMA_K_CHUNK))
        counts, s = {heur[1]}, 1
        while s <= chunks:
            counts.add(s)
            s *= 2
        cands = []
        for bm in tm.MMA_BLOCK_MS:
            cands.append(tm.mma_tile_plan(m, k, n, sm_count, bm, chain))
            tiles = -(-n // tm.MMA_BLOCK_N) * -(-m // bm)
            for s in sorted(counts):
                # past ~4 blocks an SM a split only adds partial sums
                # (splits x M x N in device memory) to reduce
                if s > 1 and tiles * s > MMA_MAX_WAVES * sm_count:
                    continue
                per = -(-chunks // s)
                cands.append((bm, -(-chunks // per), per * tm.MMA_K_CHUNK))
    out = [tuple(heur)]
    for c in cands:
        c = tuple(c)
        if c not in out and not tm.plan_violations(route, m, k, n, packing,
                                                   domain, c):
            out.append(c)
    return out if limit is None else out[:max(1, limit)]


def _cell_seed(m: int, k: int, n: int, packing: str, domain: str) -> int:
    return ((m * 1_000_003 + k * 9176 + n) * 4
            + 2 * (packing == "trit2") + (domain == "int8")) & 0x7FFFFFFF


def _quantiles(times: list) -> tuple:
    """(median, spread) of a cell's times: the spread is the
    interquartile range."""
    q = statistics.quantiles(times, n=4) if len(times) > 1 else \
        [times[0]] * 3
    return statistics.median(times), q[2] - q[0]


def measure_cell(m: int, k: int, n: int, phase: str, packing: str,
                 domain: str, reps: int = 15,
                 candidate_limit: Optional[int] = None,
                 flush=None) -> dict:
    """Race the candidate plans of one cell through the route's launcher
    (``launch_gemv`` / ``launch_mma``) on the current card and return its
    table entry.  Operands come from a generator seeded by the cell.  Each
    repeat times every candidate once, in turn, by CUDA events behind a
    spin kernel with the L2 flushed first; a candidate's time is the
    median of its repeats.  The fastest then races the rule's plan again,
    head to head, twice as long; the rule's plan is kept unless it loses
    there by more than the larger of the two spreads (interquartile
    ranges), and the entry's times are those of that race.  Every
    candidate's output is held to the rule's (int8 bitwise, float within
    ``FLOAT_TOL`` of max|y|); a disagreement raises."""
    import torch

    from . import ops
    from . import ternary_matmul as tm
    if not torch.cuda.is_available():
        raise RuntimeError("measure_cell needs a CUDA device")
    if phase != route_phase(m):
        raise ValueError(f"M={m} takes the {route_of(m)} route, phase "
                         f"{route_phase(m)!r}, not {phase!r}")
    if packing == "trit2" and k % tm.TRIT2_PER_BYTE:
        raise ValueError(f"trit2 K={k} is not a multiple of "
                         f"{tm.TRIT2_PER_BYTE}")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(
        _cell_seed(m, k, n, packing, domain))
    kw = k // tm.TRIT2_PER_BYTE if packing == "trit2" else k
    data = torch.randint(0, 256 if packing == "trit2" else 243, (kw, n),
                         generator=gen, device=dev, dtype=torch.uint8)
    scale = torch.rand(n, generator=gen, device=dev) * 1e-2
    x = torch.randn(m, k, generator=gen, device=dev, dtype=torch.bfloat16)
    x_scale = None
    if domain == "int8":
        x, x_scale = ops.quantize_acts_int8(x)
        x, x_scale = x.contiguous(), x_scale.reshape(-1).contiguous()
    launch = tm.launch_gemv if route_of(m) == "gemv" else tm.launch_mma
    cands = candidate_blocks(m, k, n, packing, domain, tm._sm_count(dev),
                             candidate_limit)
    outs = [torch.empty((m, n), dtype=torch.float32, device=dev)
            for _ in cands]
    if flush is None:
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def run(i):
        tm._raise_on(launch(x, x_scale, data, scale, packing, outs[i],
                            cands[i]),
                     f"autotune {route_of(m)} plan {cands[i]}")
    for i in range(len(cands)):
        run(i)
    torch.cuda.synchronize()
    top = outs[0].abs().max().item()
    for i in range(1, len(cands)):
        same = (torch.equal(outs[i], outs[0]) if domain == "int8" else
                (outs[i] - outs[0]).abs().max().item() <= FLOAT_TOL * top)
        if not same:
            raise RuntimeError(f"autotune: plan {cands[i]} disagrees with "
                               f"the rule's {cands[0]} at {(m, k, n)} "
                               f"{packing}/{domain}")
    def race(idx, n_reps):
        """(median, spread) in seconds of each candidate of ``idx``,
        timed in turns, ``n_reps`` times each."""
        times = {i: [] for i in idx}
        for _ in range(n_reps):
            events = []
            for i in idx:
                flush.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(i)
                end.record()
                events.append((i, start, end))
            torch.cuda.synchronize()
            for i, start, end in events:
                times[i].append(start.elapsed_time(end) / 1e3)
        return {i: _quantiles(t) for i, t in times.items()}

    stats = race(range(len(cands)), reps)
    best = min(stats, key=lambda i: stats[i][0])
    if best != 0:
        # the fastest against the rule's plan once more, head to head:
        # a win inside the timing noise of the first race does not count
        stats = race((0, best), 2 * reps)
        if stats[0][0] - stats[best][0] <= max(stats[0][1], stats[best][1]):
            best = 0
    return {"m": m, "k": k, "n": n, "phase": phase, "platform": "cuda",
            "packing": packing, "domain": domain,
            "blocks": list(cands[best]), "time_s": stats[best][0],
            "heuristic_blocks": list(cands[0]),
            "heuristic_time_s": stats[0][0], "device": current_device()}


def tune(fast: bool = False, reps: Optional[int] = None,
         verbose: bool = False, merge_with: Optional[list] = None,
         shapes: Optional[list] = None) -> list:
    """Measure every cell of the sweep (``shapes``, default
    :func:`sweep_shapes`) x packings x domains on the current card; the
    merged entry list keeps the entries of other cells and cards."""
    import torch

    from .plan import DOMAINS, PACKINGS
    if not torch.cuda.is_available():
        raise RuntimeError("tune needs a CUDA device")
    reps = reps or (7 if fast else 15)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fresh = []
    for m, k, n in (shapes or sweep_shapes(fast)):
        for packing in PACKINGS:
            for domain in DOMAINS:
                e = measure_cell(m, k, n, route_phase(m), packing, domain,
                                 reps=reps, flush=flush)
                fresh.append(e)
                if verbose:
                    print(f"  ({m},{k},{n}) {e['phase']} {packing}/{domain}:"
                          f" {tuple(e['blocks'])} {e['time_s'] * 1e3:.4f} ms"
                          f" (rule {tuple(e['heuristic_blocks'])} "
                          f"{e['heuristic_time_s'] * 1e3:.4f} ms)",
                          flush=True)
    done = {_entry_key(e) for e in fresh}
    kept = [e for e in (merge_with or []) if _entry_key(e) not in done]
    return kept + fresh


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Measure the gemv and mma route plans of "
                    "ternary_matmul per cell on this card and write the "
                    "table plan resolution reads.")
    p.add_argument("--out", default=None,
                   help="table path (default: $REPRO_TORCH_AUTOTUNE_TABLE "
                        "or the tracked autotune_table.json)")
    p.add_argument("--fast", action="store_true",
                   help="only the main path's cells, fewer repeats")
    p.add_argument("--reps", type=int, default=None)
    args = p.parse_args(argv)

    out = args.out or table_path()
    existing = load_entries(out)
    entries = tune(fast=args.fast, reps=args.reps, verbose=True,
                   merge_with=existing)
    save_table(entries, out)
    print(f"wrote {len(entries)} entries -> {out}")
    with open(out) as f:
        print(f.read(), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

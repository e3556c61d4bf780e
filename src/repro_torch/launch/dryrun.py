"""The dry run: trace every (architecture x input shape) on a production
mesh without the cards, and report the roofline terms of one rank.

The counterpart of the reference's ``repro.launch.dryrun``, which lowers
and compiles each cell on 512 placeholder XLA devices.  Here a cell
starts a fake process group of the mesh's size (this process is rank
0; collectives move nothing), builds the model at full width, places
storage-free inputs (``launch.input_specs``: DTensors of fake
tensors) and runs, under ``FakeTensorMode`` and the cost roll-up
(``roofline.op_cost``), the step the port really runs on a mesh:

* ``train``: ``make_train_step(model, opt, microbatches=, rules=,
  mesh=)`` on ``make_abstract_state``: each rank cuts its rows of the
  global batch, gathers every param whole (``dist.runtime.param_view``),
  takes its gradient, reduce-scatters it and updates its shards (the
  ZeRO-1-like step; the ranks along ``model`` repeat each other's
  compute);
* ``prefill``: ``model.prefill`` on the param view and the rank's rows;
* ``decode``: one ``model.decode`` step, or with ``--decode-loop N`` the
  bucket engine's device loop (``serve.engine.device_decode_loop``) for
  N - 1 steps, on a rank-local decode state (the rank's rows at every
  position: the port does not shard the cache over ``model``); with
  ``--continuous SLOTS`` one chunk of the meshed ``Scheduler`` (or, with
  ``--kv paged``, ``PagedScheduler``) loop instead: ``--decode-loop``
  steps (8 by default) of the rank's slots (``serve.engine.chunk_loop``
  over the schedulers' own decode step), its slot lanes and page table
  cut from ``launch.input_specs``' slot and page pool specs, its pool
  rank-local (the slots' stripe of pages), then the chunk's all-gather
  of the token buffer (``serve.engine.round_buffer``).

Packed weights (``--packed``) resolve to the ``abstract`` kernel backend,
which charges each ternary matmul its kernel's own cost.  The numbers
describe the port's step, not the reference's SPMD one.  The report has
the reference's keys (``lower_s`` is the trace's seconds; nothing
compiles, so ``compile_s`` is 0) and ``memory_stats`` (the live-bytes
peak of the traced step, by category) with ``fits`` against an 80 GB
card.  A cell the reference skips (``runnable``) has its ``skipped``
reason; a cell whose path the port refuses on a mesh (packed experts
split over ``model``; ternary training anywhere) has the refusal under
``refused`` (``skipped`` for ternary training) in place of the
roofline.  Every family trains on a mesh, with ``--opt auto`` taking
Adafactor above 3e9 parameters: its factored moments' all-reduces, the
MoE block's gather of the router logits and sum of the slots (forward
and backward) and the cross-entropy's label count appear in the
roll-up's collectives by kind.
``--ep data`` applies the ``ep-data`` rules variant (packed experts over
``data``, their tokens moved by ``all_to_all``).  ``--fidelity device``
raises: device fidelity on a mesh is not ported.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape decode_32k --multi-pod --packed base3
  python -m repro_torch.launch.dryrun --all   # subprocess per cell,
                                              # resumable
  python -m repro_torch.launch.dryrun --train-table   # train_4k rows
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import configs, optim
from ..configs.shapes import SHAPES, runnable
from ..core.cim_linear import CIMConfig
from ..dist import mesh as mesh_lib
from ..dist import runtime as dist_rt
from ..dist import sharding as shd
from ..dist import variants
from ..models import registry
from ..roofline import OpCost, analyze_step
from ..serve.engine import ServeEngine, device_decode_loop
from ..train.step import (TERNARY_REFUSAL, make_abstract_state,
                          make_train_step)
from . import input_specs as specs
from .mesh import fake_mesh, make_production_mesh, mesh_name

DEFAULT_OUT = "experiments/dryrun_torch"
HBM_BYTES = 80e9                  # an H100 SXM's HBM3
PART3 = "ROADMAP queue 1 item 8, part 3"


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_filename(arch: str, shape: str, multi_pod,
                  packed: str | None) -> str:
    """The report's file name; ``multi_pod`` may also be a mesh tag
    (``"4x4"``)."""
    tag = multi_pod if isinstance(multi_pod, str) else _mesh_tag(multi_pod)
    suffix = f"__{packed}" if packed else ""
    return f"{arch}__{shape}__{tag}{suffix}.json"


def refuse(continuous: int = 0, kv_layout: str = "dense",
           fidelity: str = "exact") -> None:
    """Raise for a request the dry run cannot trace: the paged pool
    without the slot pool it is a layout of, and device fidelity, which
    the port does not run on a mesh yet."""
    if kv_layout == "paged" and not continuous:
        raise ValueError("--kv paged requires --continuous SLOTS (the paged "
                         "pool is a continuous-batching slot-pool layout)")
    if fidelity == "device":
        raise NotImplementedError(
            f"--fidelity device: device fidelity on a mesh is not ported "
            f"({PART3})")


def expected_distinct(draws: int, vocab: int) -> int:
    """Distinct values expected among ``draws`` uniform draws from
    ``vocab`` (the synthetic batches' tokens): what the embedding
    gradient's ``torch.unique`` returns."""
    if draws <= 0:
        return 0
    return max(1, min(draws, round(vocab * -math.expm1(
        draws * math.log1p(-1.0 / vocab)))))


def _mesh(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    return fake_mesh(mesh_lib.MeshSpec(tuple(mesh_shape), axes))


def run_cell(arch: str, shape, *, multi_pod: bool = False,
             packed: str | None = None, microbatches: int = 0,
             fsdp: bool = True, remat: str = "full",
             opt_name: str = "auto", ep: str = "model", sp: bool = False,
             pure_dp: bool = False, kv_cache: str = "",
             decode_loop: int = 0, continuous: int = 0,
             kv_layout: str = "dense", page_size: int = 16,
             fidelity: str = "exact", extra_tags: dict | None = None,
             mesh_shape: tuple | None = None, smoke: bool = False,
             layers: int | None = None, capacity: int | None = None,
             unique_count=None) -> dict:
    """One cell's report.  ``shape`` names a cell of ``SHAPES`` or is a
    ``ShapeCell`` of its own (the card's calibration cells).
    ``mesh_shape`` replaces the production mesh (the tests' and the
    card's small meshes), ``smoke`` the full-width config by its smoke
    one, ``layers`` cuts its depth; ``capacity`` is the decode state's
    positions (default the cell's ``seq_len``); ``unique_count(n)``
    overrides the distinct tokens the embedding gradient sees among
    ``n`` (default: those expected of uniform draws)."""
    refuse(continuous, kv_layout, fidelity)
    cfg = (configs.smoke if smoke else configs.get)(arch)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    meta = {"arch": arch, "shape": cell.name,
            "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                     else _mesh_tag(multi_pod)),
            "packed": packed, "fsdp": fsdp, "remat": remat,
            "microbatches": microbatches, **(extra_tags or {})}
    if smoke:
        meta["smoke"] = True
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        meta["layers"] = layers
    ok, reason = runnable(cfg, cell)
    if not ok:
        return {**meta, "skipped": reason}
    if packed and cell.kind == "train":
        return {**meta, "skipped": TERNARY_REFUSAL}
    if kv_cache == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        meta["kv_cache"] = "int8"
    rules = shd.rules_for(cfg, "train" if cell.kind == "train" else "serve",
                          fsdp=fsdp)
    if ep == "data":
        rules = variants.apply_override(rules, "ep-data")
        meta["ep"] = ep
    for on, name in ((pure_dp, "pure-dp"), (sp, "sp")):
        if on:
            rules = variants.apply_override(rules, name)
            meta[name.replace("-", "_")] = True
    if cell.kind == "train" and remat != "config":
        cfg = dataclasses.replace(cfg, remat=remat)
    model = registry.build(cfg)
    cim = None
    if packed:
        cim = CIMConfig(mode="ternary", packing=packed,
                        backend="abstract").resolve("abstract")
        meta["cim_backend"] = cim.backend
        meta["cim_fidelity"] = cim.fidelity

    mesh = _mesh(multi_pod, mesh_shape)
    try:
        chips, name = mesh.size(), mesh_name(mesh)
        split = dist_rt.batch_split(rules, mesh, cell.global_batch)
        rows = cell.global_batch // dist_rt.split_count(split)
        def trace():
            # the DeviceMesh's own rank table is a real tensor
            with FakeTensorMode(allow_non_fake_inputs=True):
                if cell.kind == "train":
                    return _train(cell, model, rules, mesh, rows, opt_name,
                                  microbatches, unique_count, meta)
                return _serve(cell, model, rules, mesh, split, packed, cim,
                              decode_loop, capacity or cell.seq_len,
                              unique_count, meta, continuous, kv_layout,
                              page_size)
        cost, tokens, t_trace = _on_deep_stack(trace)
    except NotImplementedError as e:
        # the port refuses this cell's path on a mesh (its message names
        # the ROADMAP item): reported, not traced
        return {**meta, "refused": str(e)}
    finally:
        mesh_lib.destroy_process_group()
    mem = cost.memory_stats()
    mem["hbm_bytes"] = HBM_BYTES
    mem["fits"] = mem["peak_bytes"] <= HBM_BYTES
    report = analyze_step(
        cost, arch=arch, shape=cell.name, mesh_name=name, chips=chips,
        cfg=cfg, tokens=tokens,
        kind="train" if cell.kind == "train" else "serve",
        memory_stats=mem)
    return {**meta, "lower_s": round(t_trace, 2), "compile_s": 0.0,
            **report.to_dict(), "fits": mem["fits"]}


TRACE_STACK = 1 << 30       # bytes of C stack for a cell's trace


def _on_deep_stack(fn):
    """``fn()`` on a thread of TRACE_STACK bytes of C stack, its exception
    raised here.  Releasing a traced step's autograd graph frees its
    fake tensors one inside another: xlstm-125m's ``train_4k`` (4096
    sLSTM steps) went past the main thread's 8 MiB and crashed the
    process."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:        # re-raised in the caller
            out["error"] = e
    old = threading.stack_size(TRACE_STACK)
    try:
        worker = threading.Thread(target=run)
        worker.start()
    finally:
        threading.stack_size(old)
    worker.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _train(cell, model, rules, mesh, rows, opt_name, microbatches,
           unique_count, meta):
    """(roll-up, tokens, seconds) of the meshed train step, traced under
    the caller's FakeTensorMode."""
    cfg = model.cfg
    use_adafactor = (opt_name == "adafactor" or
                     (opt_name == "auto" and cfg.param_count() > 3e9))
    lr = optim.warmup_cosine(3e-4, 1000, 100_000)
    opt = optim.adafactor(lr) if use_adafactor else optim.adamw(lr)
    meta["optimizer"] = "adafactor" if use_adafactor else "adamw"
    # the reference's 8 microbatches of a large batch, as many as the
    # rank's rows allow
    mb = microbatches or math.gcd(8 if cell.global_batch >= 64 else 1, rows)
    meta["microbatches"] = mb
    state = make_abstract_state(model, opt, rules, mesh, device=specs.DEVICE)
    batch = {k: specs.global_tensor(v) for k, v in
             specs.train_batch_specs(cfg, cell, rules, mesh).items()}
    step = make_train_step(model, opt, microbatches=mb, rules=rules,
                           mesh=mesh)
    per_call = rows // mb * cell.seq_len
    cost = OpCost(unique_count or (
        lambda n: expected_distinct(per_call, cfg.vocab_size)))
    cost.register(state.params, "params")
    cost.register(state.opt_state, "optimizer")
    cost.register(batch, "temporaries")
    t0 = time.monotonic()
    with cost:
        step(state, batch)
    return cost, cell.global_batch * cell.seq_len, time.monotonic() - t0


def _serve(cell, model, rules, mesh, split, packed, cim, decode_loop,
           capacity, unique_count, meta, continuous=0, kv_layout="dense",
           page_size=16):
    """(roll-up, tokens, seconds) of a prefill, a decode step, the
    bucket engine's decode loop or a scheduler's chunk, traced under the
    caller's FakeTensorMode on the params' gathered view and the rank's
    rows."""
    params = specs.abstract_model_params(model, rules, mesh, packed)
    cost = OpCost(unique_count)
    cost.register(params, "params")
    if cell.kind != "prefill" and continuous:
        return _chunk(cell, model, rules, mesh, params, cim, decode_loop,
                      capacity, cost, meta, continuous, kv_layout,
                      page_size)
    if cell.kind == "prefill":
        batch = {k: specs.global_tensor(v) for k, v in specs.
                 prefill_batch_specs(model.cfg, cell, rules, mesh).items()}
        cost.register(batch, "temporaries")
        t0 = time.monotonic()
        with (cost, shd.activation_context(rules, mesh),
              dist_rt.row_block(split)):
            local = {k: dist_rt.shard_rows(v, split)
                     for k, v in batch.items()}
            tokens = local.pop("tokens")
            logits, _ = model.prefill(dist_rt.param_view(params), tokens,
                                      capacity, cim=cim, **local)
            logits[:, -1].argmax(-1).to(torch.int32)
        return cost, cell.global_batch * cell.seq_len, \
            time.monotonic() - t0
    if decode_loop == 1:
        raise ValueError("--decode-loop needs >= 2: slot 0 of the token "
                         "buffer is the prefill token passed in, so a "
                         "1-token loop runs no decode step")
    # a rank-local state: the rank's rows at every position
    rows = cell.global_batch // dist_rt.split_count(split)
    steps = max(decode_loop - 1, 1)
    state = model.init_cache(rows, capacity, specs.DEVICE)
    state["pos"] = max(capacity - steps, 0)
    cost.register({k: v for k, v in state.items() if k != "pos"}, "state")
    token = torch.empty((rows,), dtype=torch.int32, device=specs.DEVICE)
    t0 = time.monotonic()
    with (cost, shd.activation_context(rules, mesh),
          dist_rt.row_block(split)):
        view = dist_rt.param_view(params)

        def decode(tok, st):
            return model.decode(view, tok[:, None], st, cim=cim)
        if decode_loop:
            lanes = [torch.full((rows,), v, dtype=torch.int32,
                                device=specs.DEVICE)
                     for v in (decode_loop, -1)]
            device_decode_loop(decode, token, state, *lanes, decode_loop,
                               ServeEngine.buffer_width(decode_loop))
            meta["decode_loop"] = decode_loop
        else:
            logits, _ = decode(token, state)
            logits[:, -1].argmax(-1).to(torch.int32)
    return cost, cell.global_batch * steps, time.monotonic() - t0


def _chunk(cell, model, rules, mesh, params, cim, decode_loop, capacity,
           cost, meta, slots, kv_layout, page_size):
    """One chunk of the meshed ``Scheduler`` / ``PagedScheduler`` loop on
    this rank's slots: the schedulers' pool geometry and decode step in
    ``chunk_loop``, then the chunk's all-gathered transfer buffer."""
    from ..kernels.plan import rows_as_calls
    from ..models import paged_kv
    from ..serve import engine
    chunk = decode_loop if decode_loop >= 1 else 8
    split = dist_rt.batch_split(rules, mesh, slots, axis="slot")
    local, _ = engine.slot_block(slots, split)
    meta.update(continuous_slots=slots, chunk=chunk)
    if kv_layout == "paged":
        per_slot = -(-capacity // page_size)
        num_pages, stripe = engine.stripe_pages(slots, local, per_slot)
        meta.update(kv_layout="paged", page_size=page_size,
                    num_pages=num_pages)
        (_, table, pos, tok, live, made, fresh, max_new,
         eos) = specs.paged_pool_specs(model, cell, rules, mesh, slots,
                                       page_size, num_pages)
        pool = paged_kv.init_page_pool(model.cfg, stripe, page_size,
                                       specs.DEVICE)
        table = dist_rt.local(table)
    else:
        (pool, tok, live, made, fresh, max_new,
         eos) = specs.slot_pool_specs(model, cell, rules, mesh, slots)
        pos = pool["pos"]
        cache = model.init_cache(local, capacity, specs.DEVICE)
        pool = {k: v for k, v in cache.items() if k != "pos"}
    tok, live, made, fresh, max_new, eos = (
        dist_rt.local(x) for x in (tok, live, made, fresh, max_new, eos))
    carry = dict(pool=pool, pos=dist_rt.local(pos))
    cost.register(pool, "state")
    t0 = time.monotonic()
    with (cost, shd.activation_context(rules, mesh),
          dist_rt.row_block(split), rows_as_calls(True)):
        view = dist_rt.param_view(params)

        def step(t, lv):
            if kv_layout == "paged":
                t, carry["pos"] = engine.paged_decode_step(
                    model, view, cim, None, carry["pool"], table,
                    carry["pos"], t, lv)
            else:
                t, carry["pool"], carry["pos"] = engine.slot_decode_step(
                    model, view, cim, carry["pool"], carry["pos"], t)
            return t
        buf, cnt, steps, occ, _, live, _ = engine.chunk_loop(
            step, tok, live, made, fresh, max_new, eos, chunk)
        engine.round_buffer(buf, cnt, live, steps, occ, (), split)
    return cost, slots * chunk, time.monotonic() - t0


def save_result(result: dict, out_dir: str, tag: str | None = None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    fname = cell_filename(result["arch"], result["shape"], result["mesh"],
                          result.get("packed"))
    if result.get("smoke"):
        fname = fname.replace(".json", "__smoke.json")
    if tag:
        fname = fname.replace(".json", f"__{tag}.json")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1, default=str)
    if "skipped" in result:
        print(f"[skip] {fname}: {result['skipped']}")
    elif "refused" in result:
        print(f"[refused] {fname}: {result['refused']}")
    else:
        print(f"[ok]   {fname}: bottleneck={result['bottleneck']} "
              f"compute={result['t_compute']*1e3:.2f}ms "
              f"memory={result['t_memory']*1e3:.2f}ms "
              f"collective={result['t_collective']*1e3:.2f}ms "
              f"peak={result['memory_stats']['peak_bytes']/1e9:.2f}GB "
              f"fits={result['fits']} (trace {result['lower_s']}s)")
    return fname


def sweep(out_dir: str, multi_pod_too: bool = True, resume: bool = True,
          packed: str | None = None, archs=None, timeout: int = 3600
          ) -> list:
    """Subprocess-per-cell sweep (a fresh process group and fake mode per
    cell; resumable)."""
    meshes = [False, True] if multi_pod_too else [False]
    failures = []
    for arch in (archs or configs.ARCHS):
        for shape in SHAPES:
            for mp in meshes:
                fname = cell_filename(arch, shape, mp, packed)
                path = os.path.join(out_dir, fname)
                if resume and os.path.exists(path):
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--out-dir", out_dir]
                if mp:
                    cmd.append("--multi-pod")
                if packed:
                    cmd += ["--packed", packed]
                print(f"--- {fname}", flush=True)
                try:
                    r = subprocess.run(cmd, timeout=timeout,
                                       capture_output=True, text=True)
                    print(r.stdout[-2000:], end="", flush=True)
                    if r.returncode:
                        failures.append(fname)
                        print(r.stderr[-4000:], flush=True)
                except subprocess.TimeoutExpired:
                    failures.append(fname + " (timeout)")
    print(f"sweep done; {len(failures)} failures: {failures}")
    return failures


def table(out_dir: str, mesh: str = "16x16") -> str:
    """A markdown table of the reports in ``out_dir`` on ``mesh``: one
    row per traced (arch, shape), the float report and the base3 one as
    ``float / base3`` ("-" for a side without a trace), then one line
    each for the cells skipped, refused or never written.  Reckoned on
    the data sheet, not measured."""
    rows = ["| arch | shape | TFLOP/dev | GB/dev | wire GB/dev | compute "
            "ms | memory ms | collective ms | bound by | peak GB | fits "
            "| trace s |", "|" + " --- |" * 12]
    scale = {"flops_per_device": 1e-12, "bytes_per_device": 1e-9,
             "wire_bytes_per_device": 1e-9, "t_compute": 1e3,
             "t_memory": 1e3, "t_collective": 1e3}
    num = lambda v: f"{v:.0f}" if v >= 1000 else f"{v:.4g}"
    untraced = {"skipped": [], "refused": [], "missing": []}
    for arch in configs.ARCHS:
        for shape in SHAPES:
            sides = []
            for packed in (None, "base3"):
                path = os.path.join(out_dir, cell_filename(
                    arch, shape, mesh, packed))
                rep = None
                if os.path.exists(path):
                    with open(path) as f:
                        rep = json.load(f)
                sides.append(rep)
                name = f"{arch} {shape}" + (f" {packed}" if packed else "")
                if rep is None:
                    untraced["missing"].append(name)
                elif "skipped" in rep and not packed:
                    untraced["skipped"].append(name)
                elif "refused" in rep:
                    untraced["refused"].append(name)
            traced = [r if r and "bottleneck" in r else None for r in sides]
            if not any(traced):
                continue
            if sides[1] is None or "skipped" in sides[1]:
                traced = traced[:1]

            def col(get):
                return " / ".join("-" if r is None else get(r)
                                  for r in traced)
            cols = [col(lambda r, k=k, m=m: num(r[k] * m))
                    for k, m in scale.items()]
            cols += [col(lambda r: r["bottleneck"]),
                     col(lambda r: num(r["memory_stats"]["peak_bytes"]
                                       / 1e9)),
                     col(lambda r: str(r["fits"]).lower()),
                     col(lambda r: str(r["lower_s"]))]
            rows.append(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    for what, cells in untraced.items():
        if cells:
            rows.append(f"\n{what}: " + ", ".join(cells))
    return "\n".join(rows)


def train_table(out_dir: str, mesh: str = "16x16",
                shape: str = "train_4k") -> str:
    """A markdown table of the float ``shape`` reports in ``out_dir`` on
    ``mesh``, one row per arch: its optimizer, TFLOP, GB and wire GB a
    rank by collective kind, the live-bytes peak, ``fits`` and the trace
    seconds; a cell without a trace is listed by why.  Reckoned on the
    data sheet, not measured."""
    kinds = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
    rows = ["| arch | optimizer | TFLOP/dev | GB/dev | wire GB/dev: "
            + ", ".join(kinds) + " | peak GB | fits | trace s |",
            "|" + " --- |" * 8]
    untraced = []
    for arch in configs.ARCHS:
        path = os.path.join(out_dir, cell_filename(arch, shape, mesh, None))
        if not os.path.exists(path):
            untraced.append(f"{arch} (missing)")
            continue
        with open(path) as f:
            rep = json.load(f)
        if "bottleneck" not in rep:
            why = rep.get("skipped") or rep.get("refused")
            untraced.append(f"{arch} ({why})")
            continue
        wire = " / ".join(f"{rep['collectives'][k] / 1e9:.4g}"
                          for k in kinds)
        rows.append(
            f"| {arch} | {rep.get('optimizer', '-')} | "
            f"{rep['flops_per_device'] / 1e12:.4g} | "
            f"{rep['bytes_per_device'] / 1e9:.4g} | {wire} | "
            f"{rep['memory_stats']['peak_bytes'] / 1e9:.4g} | "
            f"{str(rep['fits']).lower()} | {rep['lower_s']} |")
    if untraced:
        rows.append("\nuntraced: " + ", ".join(untraced))
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--single-pod-only", action="store_true")
    p.add_argument("--packed", choices=("base3", "trit2"))
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--remat", default="full",
                   choices=("full", "dots", "none", "config"))
    p.add_argument("--opt", default="auto",
                   choices=("auto", "adamw", "adafactor"))
    p.add_argument("--ep", default="model", choices=("model", "data"))
    p.add_argument("--sp", action="store_true",
                   help="sequence parallelism over the model axis")
    p.add_argument("--pure-dp", action="store_true",
                   help="fold the model axis into data parallelism")
    p.add_argument("--kv-cache", default="", choices=("", "int8"),
                   help="KV cache storage dtype (int8 = scaled)")
    p.add_argument("--decode-loop", type=int, default=0,
                   help="decode cells: trace the bucket engine's device "
                        "loop with this max-new budget instead of one step")
    p.add_argument("--continuous", type=int, default=0, metavar="SLOTS",
                   help="decode cells: one chunk (--decode-loop steps, "
                        "default 8) of the meshed slot-pool Scheduler")
    p.add_argument("--kv", default="dense", choices=("dense", "paged"),
                   help="slot-pool KV layout (paged: the PagedScheduler, "
                        "with --continuous)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--fidelity", default="exact",
                   choices=("exact", "device"),
                   help=f"execution fidelity (device raises: {PART3})")
    p.add_argument("--smoke", action="store_true",
                   help="the arch's smoke config in place of the full one")
    p.add_argument("--mesh-shape", default=None,
                   help="a mesh in place of the production one, e.g. 4x4")
    p.add_argument("--out-dir", default=DEFAULT_OUT)
    p.add_argument("--tag", default=None,
                   help="suffix for the output file (perf experiments)")
    p.add_argument("--table", action="store_true",
                   help="print the markdown table of the reports in "
                        "--out-dir and exit")
    p.add_argument("--train-table", action="store_true",
                   help="print the train_4k reports' table (optimizer, "
                        "wire bytes by kind) and exit")
    args = p.parse_args(argv)
    if args.table:
        print(table(args.out_dir))
        return
    if args.train_table:
        print(train_table(args.out_dir))
        return
    if args.kv == "paged" and not args.continuous:
        p.error("--kv paged requires --continuous SLOTS (the paged "
                "pool is a continuous-batching slot-pool layout)")
    refuse(args.continuous, args.kv, args.fidelity)

    if args.all:
        fails = sweep(args.out_dir, multi_pod_too=not args.single_pod_only,
                      packed=args.packed)
        sys.exit(1 if fails else 0)
    if not args.arch or not args.shape:
        p.error("--arch and --shape required (or --all)")
    mesh_shape = (tuple(int(s) for s in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   packed=args.packed, microbatches=args.microbatches,
                   fsdp=not args.no_fsdp, remat=args.remat,
                   opt_name=args.opt, ep=args.ep, sp=args.sp,
                   pure_dp=args.pure_dp, kv_cache=args.kv_cache,
                   decode_loop=args.decode_loop,
                   continuous=args.continuous, kv_layout=args.kv,
                   page_size=args.page_size, fidelity=args.fidelity,
                   mesh_shape=mesh_shape, smoke=args.smoke)
    if args.tag:
        res["tag"] = args.tag
    save_result(res, args.out_dir, args.tag)


if __name__ == "__main__":
    main()

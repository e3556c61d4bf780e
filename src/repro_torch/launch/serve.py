"""Serving launcher: requests against a (optionally packed-ternary) model,
printing one JSON line.  Three drivers: the bucket ``ServeEngine`` (the
default), ``--continuous`` (the continuous-batching ``Scheduler``: a pool
of ``--slots`` decode slots, ``--chunk`` decode steps per host yield) and
``--continuous --kv paged`` (the ``PagedScheduler``: a paged,
prefix-shared KV pool read through the ``paged_attention`` kernel, or
through the gather with ``--fused-attn false``).  Requests arrive all at
once, as a Poisson stream (``--arrival-rate``), or from a JSON trace
(``--trace-file``).

The weights are random, drawn from a seeded ``torch.Generator`` on the
device.  With ``--packed`` they are drawn and packed one layer at a time
(``BaseModel.init_packed``), so the float tree never exists
(mixtral-8x7b's weights are 93.4 GB in bf16, 46.6 GB in base3;
llama-3.2-vision-90b's 179 GB in bf16 are 22.4 GB in trit2): base3
stores one byte per 5-trit weight, trit2 two bits per trit, and the
packed bytes are decoded only inside the matmul kernels.  Every family
packs through its ``pack_predicate``: the weights it reads through its
matmuls.  Where ``ternarize_params``'s default predicate would also
pack a leaf the model reads elsewhere (zamba2-7b's and
llama-3.2-vision-90b's stacked norms, of 64 layers or more; xlstm-125m's
sLSTM ``wr``), the launcher keeps that leaf float and says so on
stderr: the reference packs it and then fails (ROADMAP queue 3).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --packed base3 --domain int8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --packed base3 --continuous --kv paged --slots 8 --chunk 8 \\
      --capacity 512 --arrival-rate 50

``--arch`` takes every name of ``repro_torch.configs.ARCHS``
(internlm2-1.8b, glm4-9b, phi3-mini-3.8b, qwen3-14b, the MoE models
mixtral-8x7b and kimi-k2-1t-a32b, kimi fitting one card only at
``--smoke`` size, the recurrent zamba2-7b and xlstm-125m, the
encoder-decoder whisper-large-v3 and the cross-attending
llama-3.2-vision-90b, whose full size fits one card only packed).  The
last four serve from the dense pool only: ``--kv paged`` refuses them,
as the reference's does.  whisper prefills from zero ``frames`` and the
VLM from zero ``patches``, (batch, ``encoder_seq``, d_model), as in the
reference's launcher; there is no flag for real audio or images:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --packed trit2 --requests 2 \
      --prompt-len 32 --max-new 8

mixtral's attention is windowed (4096): its cache
holds at most the window and rolls, and ``--kv paged`` refuses it.  A
prompt past 2048 tokens is prefilled through the flash recurrence
(``models.attention.flash_attention``); size ``--capacity`` to hold the
prompt and its new tokens:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
      --packed base3 --prompt-len 3000 --capacity 3072

``--fidelity device`` serves decode through the fault-injected analog
MAC (``repro_torch.faults``) under the campaign of the paper's measured
TL restore yield, ``measured_fault_model(seed=--seed, drift_rate=0.001)``:
the served weights drift every chunk and are restore-scrubbed every
``--scrub-every`` chunks; prefill stays exact.  It needs ``--packed`` and
``--continuous``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --packed base3 --continuous --kv paged --fidelity device \
      --scrub-every 2

``--frontend`` serves through the SLO-aware front-end
(``repro_torch.frontend``): a model registry (``--frontend-models``, one
scheduler pool per architecture, float weights, paged KV unless ``--kv
dense``) behind one bounded-queue submit path (``--queue-limit``), with
FIFO or priority/deadline admission (``--admission slo``, ``--deadline-s``,
``--service-floor-s``) and the open-loop trace replay as the request
stream:

  PYTHONPATH=src python -m repro_torch.launch.serve --frontend \
      --frontend-models internlm2-1.8b,qwen3-14b --smoke --device cpu \
      --admission slo --deadline-s 30

``--legacy-loop`` runs the bucket engine's per-step decode loop (one host
sync per token) instead of the on-device loop, and ``--backend`` names a
registered kernel backend for the packed matmuls (``auto`` by default).

``--device cpu --smoke`` runs the same paths on the CPU through the plain
PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def report_packing_faults(model, packing: str) -> list:
    """The leaves (``model.packing_faults()``) that the default packing
    predicate would pack but that the model reads outside its matmuls
    (sLSTM's recurrent ``wr`` at a head dim of 64 or more; stacked
    norms and biases of 64 layers or more), named in one line on
    stderr: the launcher packs through ``model.pack_predicate`` and
    keeps them float, where the reference packs them and then fails in
    the forward pass (ROADMAP queue 3)."""
    faults = model.packing_faults()
    if faults:
        print(f"--packed {packing}: keeping {', '.join(faults)} of "
              f"{model.cfg.name} float: the model reads them outside its "
              f"matmuls; the reference's default predicate packs them and "
              f"fails (a known reference fault, ROADMAP queue 3)",
              file=sys.stderr)
    return faults


def extra_inputs(cfg) -> dict:
    """The reference launcher's stub inputs: zero ``frames`` (audio) or
    ``patches`` (vlm) of (batch, ``encoder_seq``, d_model) per prefill."""
    name = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if name is None:
        return {}
    return {name: lambda b: torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                        dtype=cfg.dtype)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="internlm2-1.8b",
                   help="one of repro_torch.configs.ARCHS")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--capacity", type=int, default=256,
                   help="KV positions per request: at least the prompt "
                        "plus its new tokens")
    p.add_argument("--packed", choices=("base3", "trit2"))
    p.add_argument("--domain", default="float", choices=("float", "int8"),
                   help="arithmetic domain of the packed matmuls")
    p.add_argument("--backend", default="auto",
                   help="kernel backend of the packed matmuls (a "
                        "registered name; 'auto' = capability match)")
    p.add_argument("--fidelity", default="exact",
                   choices=("exact", "device"),
                   help="execution fidelity: 'device' serves decode "
                        "through the fault-injected analog backend at the "
                        "measured TL restore yield (prefill stays exact); "
                        "requires --packed and --continuous")
    p.add_argument("--scrub-every", type=int, default=8,
                   help="decode chunks between restore-scrub repairs "
                        "under --fidelity device (0 disables scrubbing: "
                        "degradation accumulates)")
    p.add_argument("--legacy-loop", action="store_true",
                   help="per-step decode loop of the bucket engine (one "
                        "host sync per token) instead of the on-device "
                        "loop")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching Scheduler (slot pool + "
                        "chunked decode) instead of the bucket engine")
    p.add_argument("--slots", type=int, default=0,
                   help="decode slots for --continuous (default: "
                        "--max-batch)")
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps per scheduling round (host yield)")
    p.add_argument("--kv", default=None, choices=("dense", "paged"),
                   help="--continuous/--frontend KV layout: dense per-slot "
                        "caches or the paged, prefix-shared page pool "
                        "(default: dense for --continuous, paged for "
                        "--frontend pools)")
    p.add_argument("--page-size", type=int, default=16,
                   help="positions per KV page for --kv paged")
    p.add_argument("--num-pages", type=int, default=0,
                   help="page-pool size for --kv paged (0 = the dense-pool "
                        "equivalent, plus the reserved null page)")
    p.add_argument("--fused-attn", default="auto",
                   choices=("auto", "true", "false"),
                   help="--kv paged decode read: the paged_attention "
                        "kernel (auto, true) or the named gather (false)")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="Poisson request arrivals per second (0 = all "
                        "requests at t=0)")
    p.add_argument("--trace-file", default=None,
                   help="JSON arrival trace: list of {arrival_s, "
                        "prompt_len, max_new, eos_id} (overrides "
                        "--requests/--prompt-len/--max-new/--arrival-rate)")
    p.add_argument("--frontend", action="store_true",
                   help="serve through the SLO-aware front-end "
                        "(repro_torch.frontend): model registry + bounded "
                        "queue + admission policy + open-loop replay")
    p.add_argument("--frontend-models", default=None, metavar="A,B",
                   help="comma-separated architecture names to register "
                        "as front-end pools (default: --arch)")
    p.add_argument("--queue-limit", type=int, default=64,
                   help="--frontend pending-queue bound; past it submits "
                        "are rejected with 'queue-full'")
    p.add_argument("--admission", default="fifo", choices=("fifo", "slo"),
                   help="--frontend admission policy: fifo, or slo "
                        "(priority classes + earliest-deadline-first + "
                        "shedding of unmeetable requests)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help="--frontend relative completion budget of every "
                        "generated request (0 = no deadline; a "
                        "--trace-file's per-record deadline_s wins)")
    p.add_argument("--service-floor-s", type=float, default=0.0,
                   help="--admission slo minimum-service estimate: "
                        "pending requests whose deadline cannot be met "
                        "within it are shed")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    kv = args.kv or ("paged" if args.frontend else "dense")
    if kv == "paged" and not (args.continuous or args.frontend):
        p.error("--kv paged requires --continuous or --frontend (the paged "
                "pool is a slot-pool layout)")
    if args.frontend and args.continuous:
        p.error("--frontend drives its registry's scheduler pools itself; "
                "drop --continuous")
    if args.frontend and (args.packed or args.fidelity == "device"):
        p.error("--frontend pools serve float weights through the model "
                "registry; packed/device-fidelity serving is the "
                "bucket/--continuous path")
    if args.frontend and args.legacy_loop:
        p.error("--frontend has no legacy per-step loop; its pools are "
                "chunked schedulers")
    if args.fidelity == "device" and not args.packed:
        p.error("--fidelity device requires --packed (the device model "
                "faults packed ternary weights; float serving has no "
                "device path)")
    if args.fidelity == "device" and not args.continuous:
        p.error("--fidelity device requires --continuous (drift and "
                "restore-scrub are per-chunk hooks of the Scheduler)")
    if args.frontend:
        return _run_frontend(args, kv)

    from repro_torch import configs, resolve_device
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.models import registry
    from repro_torch.serve import (PagedScheduler, Request, Scheduler,
                                   ServeEngine, latency_stats, load_trace,
                                   make_trace, poisson_arrivals)

    device = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = registry.build(cfg)
    kept_float = report_packing_faults(model, args.packed) if args.packed \
        else []
    gen = torch.Generator(device=device).manual_seed(args.seed)
    raw_bytes = model.param_bytes()
    cim = None
    if args.packed:
        if args.fidelity == "device":
            # pin the measured-yield campaign BEFORE resolution, so the
            # device backend serves the paper's TL restore yield
            from repro_torch import faults
            faults.set_fault_model(faults.measured_fault_model(
                seed=args.seed, drift_rate=0.001))
        cim = CIMConfig(mode="ternary", packing=args.packed,
                        domain=args.domain, backend=args.backend,
                        fidelity=args.fidelity)
        # fail fast for both phases the engines resolve
        cim.resolve(device.type)
        cim.resolve(device.type, phase="prefill")
    params = (model.init_packed(gen, cim, device=device,
                                predicate=model.pack_predicate)
              if args.packed else model.init(gen, device=device))
    extra = extra_inputs(cfg)
    if args.trace_file:
        trace = load_trace(args.trace_file)
    else:
        arrivals = poisson_arrivals(args.requests, args.arrival_rate,
                                    seed=args.seed)
        trace = make_trace(arrivals, [args.prompt_len], [args.max_new])
    slots = args.slots or args.max_batch
    if args.continuous and kv == "paged":
        eng = PagedScheduler(
            model, params, capacity=args.capacity, slots=slots,
            chunk=args.chunk, page_size=args.page_size,
            num_pages=args.num_pages or None, cim=cim,
            fused_attn={"auto": "auto", "true": True,
                        "false": False}[args.fused_attn], device=device,
            scrub_every=args.scrub_every, extra_inputs=extra)
    elif args.continuous:
        eng = Scheduler(model, params, capacity=args.capacity, slots=slots,
                        chunk=args.chunk, cim=cim, device=device,
                        scrub_every=args.scrub_every, extra_inputs=extra)
    else:
        eng = ServeEngine(model, params, capacity=args.capacity,
                          max_batch=args.max_batch, cim=cim,
                          on_device_loop=not args.legacy_loop, device=device,
                          extra_inputs=extra)
    rng = np.random.default_rng(args.seed + 1)
    for i, rec in enumerate(trace):
        prompt = rng.integers(0, cfg.vocab_size, size=rec["prompt_len"])
        eng.submit(Request(uid=i, prompt=prompt, max_new=rec["max_new"],
                           eos_id=rec["eos_id"],
                           arrival_s=rec["arrival_s"]))

    t0 = time.monotonic()
    # the bucket engine replays the trace too (no sleeps when every
    # arrival is 0), so latency is completion - arrival for every driver
    done = eng.run() if args.continuous else eng.run_trace()
    dt = time.monotonic() - t0
    out = {
        "arch": cfg.name,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "packed": args.packed or "float",
        "backend": eng.cim.backend if eng.cim else None,
        "domain": args.domain if args.packed else None,
        "fidelity": eng.cim.fidelity if eng.cim else None,
        "weight_bytes": raw_bytes,
        "weight_bytes_served": hbm_bytes(params),
        "kept_float": kept_float,
        "requests": len(done),
        "generated_tokens": eng.generated_tokens,
        "steps": eng.steps_run,
        "host_transfers": eng.host_transfers,
        "wall_s": dt,
        "tok_per_s": eng.generated_tokens / max(dt, 1e-9),
        **latency_stats(done),
    }
    if args.continuous:
        out.update(decode_loop="continuous", slots=eng.slots,
                   chunk=eng.chunk, chunks=eng.chunks_run,
                   slot_occupancy=eng.slot_occupancy, kv=kv)
        if eng.cim is not None and eng.cim.fidelity == "device":
            out.update(scrubs=eng.scrubs_run, adc_clip_lo=eng.adc_clip_lo,
                       adc_clip_hi=eng.adc_clip_hi)
        if kv == "paged":
            out.update(page_size=eng.page_size, num_pages=eng.num_pages,
                       attn_backend=(eng.attn_plan.backend
                                     if eng.attn_plan else "gather"),
                       pages_in_use_peak=eng.pages_in_use_peak,
                       kv_bytes_pool=eng.kv_bytes(),
                       kv_bytes_resident_peak=eng.kv_bytes_resident_peak,
                       prefix_hit_rate=eng.prefix_hit_rate)
    else:
        out["decode_loop"] = "legacy" if args.legacy_loop else "device"
    print(json.dumps(out))
    return out


def _run_frontend(args, kv: str) -> dict:
    """The --frontend mode: registry + bounded-queue server + open-loop
    replay, reporting the load harness's numbers (goodput, TTFT, the
    latency split) and the registry's capacity report."""
    from repro_torch.frontend import (FIFOAdmission, FrontendServer,
                                      ModelRegistry, ModelSpec,
                                      SLOAdmission, replay, trace_requests)
    from repro_torch.serve import load_trace, make_trace, poisson_arrivals

    names = [m.strip()
             for m in (args.frontend_models or args.arch).split(",")
             if m.strip()]
    reg = ModelRegistry(device=args.device)
    for name in names:
        reg.register(ModelSpec(
            name=name, arch=name, smoke=args.smoke, kind=kv,
            capacity=args.capacity, slots=args.slots or args.max_batch,
            chunk=args.chunk, page_size=args.page_size,
            num_pages=args.num_pages or None, seed=args.seed))
    if args.trace_file:
        trace = load_trace(args.trace_file)
    else:
        arrivals = poisson_arrivals(args.requests, args.arrival_rate,
                                    seed=args.seed)
        trace = make_trace(arrivals, [args.prompt_len], [args.max_new],
                           deadlines=[args.deadline_s or None])
    records = trace_requests(trace, reg, names, seed=args.seed)
    policy = (SLOAdmission(service_floor_s=args.service_floor_s)
              if args.admission == "slo" else FIFOAdmission())
    server = FrontendServer(reg, policy, queue_limit=args.queue_limit)
    report = replay(server, records)
    out = {"decode_loop": "frontend", "models": names,
           "admission": policy.name, "queue_limit": args.queue_limit,
           "kv": kv, **report, "capacity_report": reg.capacity_report()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

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
device, then packed with ``ternarize_params`` when ``--packed`` is given:
base3 stores one byte per 5-trit weight, trit2 two bits per trit, and the
packed bytes are decoded only inside the matmul kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --packed base3 --domain int8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --packed base3 --continuous --kv paged --slots 8 --chunk 8 \\
      --capacity 512 --arrival-rate 50

``--arch`` takes every name of ``repro_torch.configs.ARCHS``
(internlm2-1.8b, glm4-9b, phi3-mini-3.8b, qwen3-14b).  A prompt past
2048 tokens is prefilled through the flash recurrence
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

``--device cpu --smoke`` runs the same paths on the CPU through the plain
PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


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
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching Scheduler (slot pool + "
                        "chunked decode) instead of the bucket engine")
    p.add_argument("--slots", type=int, default=0,
                   help="decode slots for --continuous (default: "
                        "--max-batch)")
    p.add_argument("--chunk", type=int, default=8,
                   help="decode steps per scheduling round (host yield)")
    p.add_argument("--kv", default="dense", choices=("dense", "paged"),
                   help="--continuous KV layout: dense per-slot caches or "
                        "the paged, prefix-shared page pool")
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
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.kv == "paged" and not args.continuous:
        p.error("--kv paged requires --continuous (the paged pool is a "
                "slot-pool layout)")
    if args.fidelity == "device" and not args.packed:
        p.error("--fidelity device requires --packed (the device model "
                "faults packed ternary weights; float serving has no "
                "device path)")
    if args.fidelity == "device" and not args.continuous:
        p.error("--fidelity device requires --continuous (drift and "
                "restore-scrub are per-chunk hooks of the Scheduler)")

    from repro_torch import configs, resolve_device
    from repro_torch.core.cim_linear import (CIMConfig, hbm_bytes,
                                             ternarize_params)
    from repro_torch.models import registry
    from repro_torch.serve import (PagedScheduler, Request, Scheduler,
                                   ServeEngine, latency_stats, load_trace,
                                   make_trace, poisson_arrivals)

    device = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = registry.build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    raw_bytes = hbm_bytes(params)
    cim = None
    if args.packed:
        if args.fidelity == "device":
            # pin the measured-yield campaign BEFORE resolution, so the
            # device backend serves the paper's TL restore yield
            from repro_torch import faults
            faults.set_fault_model(faults.measured_fault_model(
                seed=args.seed, drift_rate=0.001))
        cim = CIMConfig(mode="ternary", packing=args.packed,
                        domain=args.domain, fidelity=args.fidelity)
        # fail fast for both phases the engines resolve
        cim.resolve(device.type)
        cim.resolve(device.type, phase="prefill")
        params = ternarize_params(params, cim)
    if args.trace_file:
        trace = load_trace(args.trace_file)
    else:
        arrivals = poisson_arrivals(args.requests, args.arrival_rate,
                                    seed=args.seed)
        trace = make_trace(arrivals, [args.prompt_len], [args.max_new])
    slots = args.slots or args.max_batch
    if args.continuous and args.kv == "paged":
        eng = PagedScheduler(
            model, params, capacity=args.capacity, slots=slots,
            chunk=args.chunk, page_size=args.page_size,
            num_pages=args.num_pages or None, cim=cim,
            fused_attn={"auto": "auto", "true": True,
                        "false": False}[args.fused_attn], device=device,
            scrub_every=args.scrub_every)
    elif args.continuous:
        eng = Scheduler(model, params, capacity=args.capacity, slots=slots,
                        chunk=args.chunk, cim=cim, device=device,
                        scrub_every=args.scrub_every)
    else:
        eng = ServeEngine(model, params, capacity=args.capacity,
                          max_batch=args.max_batch, cim=cim, device=device)
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
                   slot_occupancy=eng.slot_occupancy, kv=args.kv)
        if eng.cim is not None and eng.cim.fidelity == "device":
            out.update(scrubs=eng.scrubs_run, adc_clip_lo=eng.adc_clip_lo,
                       adc_clip_hi=eng.adc_clip_hi)
        if args.kv == "paged":
            out.update(page_size=eng.page_size, num_pages=eng.num_pages,
                       attn_backend=(eng.attn_plan.backend
                                     if eng.attn_plan else "gather"),
                       pages_in_use_peak=eng.allocator.peak_in_use,
                       kv_bytes_pool=eng.kv_bytes(),
                       kv_bytes_resident_peak=eng.kv_bytes_resident_peak,
                       prefix_hit_rate=eng.prefix_hit_rate)
    else:
        out["decode_loop"] = "device"
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

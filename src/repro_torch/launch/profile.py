"""Where a decode step's time goes on the card.

Runs full-width decode steps of the bucket path (the same model, packing
and domain as ``launch/serve.py``; a bucket of 8 requests at position
``--prompt-len``, 128 by default), first timed plain with CUDA
synchronisation, then under ``torch.profiler``.  Prints the device time
per step by kernel, the number of kernels launched per step, and the
device's busy and idle share of the profiled wall time, and then, under
``cProfile``, the host time spent in the port's own functions, as one
JSON line.  It is the
yardstick for taking the host out of the decode step (CUDA-graph replay):
the idle share and the kernels per step are what such a change moves.

  PYTHONPATH=src python -m repro_torch.launch.profile --packed base3 --domain int8
  PYTHONPATH=src python -m repro_torch.launch.profile --arch glm4-9b \
      --prompt-len 3000 --capacity 3072
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 8
STEPS, TOP, SEED = 8, 10, 0


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="internlm2-1.8b",
                   help="one of repro_torch.configs.ARCHS")
    p.add_argument("--packed", default="base3", choices=("base3", "trit2"))
    p.add_argument("--domain", default="float", choices=("float", "int8"))
    p.add_argument("--prompt-len", type=int, default=128,
                   help="prompt tokens per request (past 2048 the prefill "
                        "takes the flash recurrence)")
    p.add_argument("--capacity", type=int, default=0,
                   help="KV positions per request (0: the prompt plus "
                        "the profiled steps, rounded up to 128)")
    args = p.parse_args(argv)
    # the prefill, then 3 warm-up steps and three runs of STEPS
    capacity = args.capacity or -(-(args.prompt_len + 4 * STEPS)
                                  // 128) * 128

    from repro_torch import configs, resolve_device
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.models import registry

    device = resolve_device("cuda")
    cfg = configs.get(args.arch)
    model = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing=args.packed, domain=args.domain)
    params = ternarize_params(
        model.init(torch.Generator(device=device).manual_seed(SEED),
                   device=device), cim)
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        BATCH, args.prompt_len)), device=device)
    logits, state = model.prefill(params, tokens, capacity, cim=cim)
    tok = logits[:, -1].argmax(-1, keepdim=True)

    def steps(n):
        nonlocal logits, state, tok
        for _ in range(n):
            logits, state = model.decode(params, tok, state, cim=cim)
            tok = logits[:, -1].argmax(-1, keepdim=True)

    steps(3)                                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:TOP]

    # the host side: cumulative time of the port's own functions (under
    # cProfile, which inflates every Python call; read them as shares)
    host = cProfile.Profile()
    host.enable()
    steps(STEPS)
    torch.cuda.synchronize()
    host.disable()
    mine = [(f"{Path(fn).name}:{name}", row[3])
            for (fn, _, name), row in pstats.Stats(host).stats.items()
            if "repro_torch" in fn]
    mine.sort(key=lambda kv: kv[1], reverse=True)
    out = {
        "arch": cfg.name, "device": torch.cuda.get_device_name(device),
        "packed": args.packed, "domain": args.domain, "batch": BATCH,
        "position": args.prompt_len, "capacity": capacity, "steps": STEPS,
        "step_ms": step_ms,
        "profiled_step_ms": wall_us / 1e3 / STEPS,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
        "kernels_per_step": sum(e.count for e in kernels) / STEPS,
        "top_kernels_ms_per_step": {
            e.key[:80]: _device_us(e) / 1e3 / STEPS for e in top},
        "host_cumulative_ms_per_step_cprofile": {
            name: sec * 1e3 / STEPS for name, sec in mine[:2 * TOP]},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

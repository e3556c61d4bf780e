"""Serving launcher: batched requests against a (optionally packed-ternary)
model through the bucket ``ServeEngine``, printing one JSON line.

The weights are random, drawn from a seeded ``torch.Generator`` on the
device, then packed with ``ternarize_params`` when ``--packed`` is given:
base3 stores one byte per 5-trit weight, trit2 two bits per trit, and the
packed bytes are decoded only inside the matmul kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --packed base3 --domain int8

``--device cpu --smoke`` runs the same path on the CPU through the plain
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
    p.add_argument("--arch", default="internlm2-1.8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--capacity", type=int, default=256)
    p.add_argument("--packed", choices=("base3", "trit2"))
    p.add_argument("--domain", default="float", choices=("float", "int8"),
                   help="arithmetic domain of the packed matmuls")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default) or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from repro_torch import configs, resolve_device
    from repro_torch.core.cim_linear import (CIMConfig, hbm_bytes,
                                             ternarize_params)
    from repro_torch.models import registry
    from repro_torch.serve import Request, ServeEngine, latency_stats

    device = resolve_device(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = registry.build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device=device)
    raw_bytes = hbm_bytes(params)
    cim = None
    if args.packed:
        cim = CIMConfig(mode="ternary", packing=args.packed,
                        domain=args.domain)
        params = ternarize_params(params, cim)
    eng = ServeEngine(model, params, capacity=args.capacity,
                      max_batch=args.max_batch, cim=cim, device=device)
    rng = np.random.default_rng(args.seed + 1)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len)
        eng.submit(Request(uid=i, prompt=prompt, max_new=args.max_new))

    t0 = time.monotonic()
    done = eng.run()
    dt = time.monotonic() - t0
    out = {
        "arch": cfg.name,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "packed": args.packed or "float",
        "backend": eng.cim.backend if eng.cim else None,
        "domain": args.domain if args.packed else None,
        "weight_bytes": raw_bytes,
        "weight_bytes_served": hbm_bytes(params),
        "requests": len(done),
        "generated_tokens": eng.generated_tokens,
        "steps": eng.steps_run,
        "host_transfers": eng.host_transfers,
        "wall_s": dt,
        "tok_per_s": eng.generated_tokens / max(dt, 1e-9),
        "decode_loop": "device",
        **latency_stats(done),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

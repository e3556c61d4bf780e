#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

Phases, each of which raises on failure:

1. build    - compile the CUDA sources of ``src/repro_torch/csrc`` (one
              ``nvcc`` per source, started together) and print the card.
2. kernels  - every kernel against its plain PyTorch version on the card,
              at the shapes of the serving path of internlm2-1.8b: K x N
              of each packed weight, M = 8 (decode) and M = 1024 (prefill
              of 8 x 128 tokens; the unembedding only at M = 8), both
              packings, both domains.  Int8 must match bitwise, float
              within 1e-4 of max|y| (summation order only).  Each case
              prints the kernel's median device time (CUDA events behind
              a spin kernel, L2 flushed between launches), its bound, the
              plain version's time and a library call's time (a
              yardstick the port never calls).
3. serve    - the bucket ServeEngine at full width (bf16, seeded random
              weights packed by ternarize_params; 8 requests of 128
              prompt tokens, 32 new tokens each) in the float and int8
              domains on base3 weights and the int8 domain on trit2
              weights.  The launch counts are zeroed just before each run
              and read just after: the run's kernel must have launched,
              with one host transfer per bucket and every token there.
4. parity   - one prefill and four decode steps of the same model with
              the cuda backend and then the plain torch backend named
              explicitly: int8-domain logits bitwise equal, float-domain
              logits within 10% of the logit scale (24 bf16 layers carry
              the kernels' different summation order).

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, data sheet
PEAK_OPS_PER_S = {"float": 989e12,         # bf16 tensor cores, dense
                  "int8": 1979e12}         # int8 tensor cores, dense
ARCH = "internlm2-1.8b"
BATCH, PROMPT, MAX_NEW, CAPACITY = 8, 128, 32, 256
FLOAT_TOL = 1e-4              # kernel vs plain, relative to max|y|
MODEL_FLOAT_TOL = 0.1         # logits, relative to max|logit|
SPIN_CYCLES = 2_000_000       # ~1 ms at the H100's 1.98 GHz clock
KERNEL_NAMES = {"float": "ternary_matmul", "int8": "ternary_matmul_int8"}
REPLACES = {"float": "src/repro/kernels/ternary_matmul.py:144",
            "int8": "src/repro/kernels/ternary_matmul.py:202"}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def layer_shapes(cfg):
    """(name, K, N, matmuls per forward) of every packed weight."""
    d, hd = cfg.d_model, cfg.hd
    L = cfg.num_layers
    return [("wq,wo", d, cfg.num_heads * hd, 2 * L),
            ("wk,wv", d, cfg.num_kv_heads * hd, 2 * L),
            ("w1,w3", d, cfg.d_ff, 2 * L),
            ("w2", cfg.d_ff, d, L),
            ("unembed", d, cfg.padded_vocab, 1)]


def bound(moved_bytes, ops, domain):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for the type."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[domain] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps, flush):
    """Median device ms of `fn` over `reps` launches, each timed by CUDA
    events with the L2 cache flushed before it (the serving path reads
    every weight cold).  A spin kernel queued ahead of the start event
    keeps the card busy while the host enqueues `fn`, so the events time
    the device's work and not the host's launch cost, which varies from
    machine to machine."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.build_all(verbose=True)
    print(f"[build] {len(build.SOURCES)} source(s) in "
          f"{time.monotonic() - t0:.1f} s")
    for src, info in build.BUILD_INFO.items():
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(torch, cfg):
    """Kernel vs plain version at the path's shapes; returns per-case
    records."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as tm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for mode in ("base3", "trit2"):            # ragged edges, untimed
        for m, k, n in ((1, 64, 5), (3, 520, 130), (13, 200, 136)):
            kw = k if mode == "base3" else k // 4
            data = torch.randint(0, 256 if mode == "trit2" else 243, (kw, n),
                                 generator=gen, device=dev, dtype=torch.uint8)
            scale = torch.rand(n, generator=gen, device=dev)
            w = ops.PackedTernary(data, scale, mode)
            x = torch.randn(m, k, generator=gen, device=dev)
            want = ops.ternary_matmul_torch(x, w)
            err = (tm.matmul_float(x, data, scale, mode) - want).abs().max()
            check(err.item() <= FLOAT_TOL * want.abs().max().item(),
                  f"ternary_matmul {mode} {(m, k, n)}: error {err.item()}")
            xi, xs = ops.quantize_acts_int8(x)
            check(torch.equal(tm.matmul_int8(xi, xs, data, scale, mode),
                              ops.ternary_matmul_int8_torch(xi, xs, w)),
                  f"ternary_matmul_int8 {mode} {(m, k, n)} is not bitwise")
    print("[kernels] ragged shapes agree")
    cases = []
    for mode in ("base3", "trit2"):
        for name, k, n, per_forward in layer_shapes(cfg):
            if mode == "base3":
                data = torch.randint(0, 243, (k, n), generator=gen,
                                     device=dev, dtype=torch.uint8)
            else:
                data = torch.randint(0, 256, (k // 4, n), generator=gen,
                                     device=dev, dtype=torch.uint8)
            scale = torch.rand(n, generator=gen, device=dev) * 1e-2
            w = ops.PackedTernary(data, scale, mode)
            w_bf16 = ops.decode_weight(w, torch.bfloat16)
            w_int8 = ops.decode_weight(w, torch.int8)
            wbytes = data.numel() + 4 * n
            for m in ((8,) if name == "unembed" else (8, BATCH * PROMPT)):
                x = torch.randn(m, k, generator=gen, device=dev,
                                dtype=torch.bfloat16)
                xi, xs = ops.quantize_acts_int8(x)
                for domain in ("float", "int8"):
                    if domain == "float":
                        run = lambda: tm.matmul_float(x, data, scale, mode)
                        plain = lambda: ops.ternary_matmul_torch(x, w)
                        library = lambda: torch.matmul(x, w_bf16)
                        in_bytes = 2 * m * k
                    else:
                        run = lambda: tm.matmul_int8(xi, xs, data, scale,
                                                     mode)
                        plain = lambda: ops.ternary_matmul_int8_torch(
                            xi, xs, w)
                        # torch._int_mm takes M > 16 only
                        library = ((lambda: torch._int_mm(xi, w_int8))
                                   if m > 16 else None)
                        in_bytes = m * k + 4 * m
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    if domain == "int8":
                        ok = torch.equal(got, want)
                    else:
                        ok = err <= FLOAT_TOL * want.abs().max().item()
                    moved = in_bytes + wbytes + 4 * m * n
                    rec = dict(
                        kernel=KERNEL_NAMES[domain], mode=mode, weight=name,
                        m=m, k=k, n=n, per_forward=per_forward,
                        max_abs_err=err, ok=bool(ok),
                        ms=time_ms(torch, run, 20, flush),
                        plain_ms=time_ms(torch, plain, 5, flush),
                        library_ms=(time_ms(torch, library, 10, flush)
                                    if library else None),
                        bytes=moved, ops=2 * m * k * n,
                        **bound(moved, 2 * m * k * n, domain))
                    cases.append(rec)
                    print("[kernels] " + json.dumps(rec))
                    check(ok, f"{rec['kernel']} disagrees with its plain "
                              f"version: {rec}")
            del data, w, w_bf16, w_int8
    return cases


def _requests(rng, vocab, n):
    from repro_torch.serve import Request
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=PROMPT),
                    max_new=MAX_NEW) for i in range(n)]


def phase_serve(torch, np, cfg, model, packed):
    """Full-width serving in each domain; returns per-run records, each
    with the launch counts read right after its own run."""
    from repro_torch.core.cim_linear import CIMConfig, hbm_bytes
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serve import ServeEngine
    runs = []
    for packing, domain in (("base3", "float"), ("base3", "int8"),
                            ("trit2", "int8")):
        params = packed[packing]
        cim = CIMConfig(mode="ternary", packing=packing, domain=domain)
        eng = ServeEngine(model, params, capacity=CAPACITY,
                          max_batch=BATCH, cim=cim, device="cuda")
        check(eng.cim.backend == "cuda",
              f"auto resolved to {eng.cim.backend!r} on the card")
        rng = np.random.default_rng(7)
        for r in _requests(rng, cfg.vocab_size, BATCH):   # warm-up bucket
            r.max_new = 2
            eng.submit(r)
        eng.run()
        eng = ServeEngine(model, params, capacity=CAPACITY,
                          max_batch=BATCH, cim=cim, device="cuda")
        reqs = _requests(rng, cfg.vocab_size, BATCH)
        for r in reqs:
            eng.submit(r)
        tm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        done = eng.run()
        wall = time.monotonic() - t0
        counts = dict(tm.LAUNCHES)
        kernel = KERNEL_NAMES[domain]
        check(counts[kernel] > 0, f"{kernel} never launched in the "
                                  f"{packing}/{domain} serve run")
        buckets = 1
        check(eng.host_transfers == buckets,
              f"{eng.host_transfers} host transfers for {buckets} bucket")
        check(len(done) == BATCH and all(
            len(r.out_tokens) == MAX_NEW
            and all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
            for r in done), "a request is missing tokens")

        # per-phase times, outside the counted run
        tokens = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                                 device="cuda")
        prefill_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.monotonic()
            logits, state = model.prefill(params, tokens, CAPACITY,
                                          cim=eng.cim)
            torch.cuda.synchronize()
            prefill_ms.append((time.monotonic() - t) * 1e3)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(MAX_NEW - 1):
            logits, state = model.decode(params, tok, state, cim=eng.cim)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t) * 1e3 / (MAX_NEW - 1)
        wbytes = hbm_bytes(params) - hbm_bytes(
            {k: v for k, v in params.items() if k == "embed"})
        rec = dict(packing=packing, domain=domain, requests=len(done),
                   generated_tokens=eng.generated_tokens,
                   steps=eng.steps_run, host_transfers=eng.host_transfers,
                   launches=counts, wall_s=wall,
                   tok_per_s=eng.generated_tokens / wall,
                   prefill_ms=statistics.median(prefill_ms),
                   decode_step_ms=step_ms,
                   decode_step_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
                   weight_bytes_per_step=wbytes)
        runs.append(rec)
        print("[serve] " + json.dumps(rec))
    return runs


def phase_parity(torch, np, cfg, model, params):
    """cuda backend vs the plain torch backend on the full-width model."""
    import dataclasses
    from repro_torch.core.cim_linear import CIMConfig
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(2, PROMPT)), device="cuda")
    out = {}
    for domain in ("float", "int8"):
        base = CIMConfig(mode="ternary", packing="base3", domain=domain)
        logits = {}
        feed = None
        for backend in ("cuda", "torch"):
            cim = dataclasses.replace(base, backend=backend)
            lg, state = model.prefill(params, tokens, CAPACITY, cim=cim)
            steps = [lg]
            if feed is None:
                feed = [lg[:, -1].argmax(-1, keepdim=True)]
            for i in range(4):
                lg, state = model.decode(params, feed[i], state, cim=cim)
                steps.append(lg)
                if len(feed) < 5:
                    feed.append(lg[:, -1].argmax(-1, keepdim=True))
            logits[backend] = torch.stack([s.float() for s in steps])
        a, b = logits["cuda"], logits["torch"]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        if domain == "int8":
            ok = torch.equal(a, b)
        else:
            ok = err <= MODEL_FLOAT_TOL * scale
        out[domain] = dict(max_abs_err=err, logit_scale=scale,
                           argmax_agreement=agree, ok=bool(ok))
        print(f"[parity] {domain}: " + json.dumps(out[domain]))
        check(ok, f"{domain}-domain logits: cuda vs torch {out[domain]}")
    return out


def kernel_summary(cases, runs, cfg):
    """One record per kernel: the numbers of one decode step's packed
    matmuls (M = 8, base3, every weight at its multiplicity), and the
    launches of the base3 serve run in the kernel's domain.  Each serve
    run's own count is under ``launches_per_run``."""
    out = []
    for domain, name in KERNEL_NAMES.items():
        mine = [c for c in cases if c["kernel"] == name]
        step = [c for c in mine if c["m"] == 8 and c["mode"] == "base3"]

        def total(key):
            vals = [c[key] for c in step]
            if any(v is None for v in vals):
                return None
            return sum(v * c["per_forward"] for v, c in zip(vals, step))
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/ternary_matmul.cu",
            replaces=REPLACES[domain],
            launches=next(r["launches"][name] for r in runs
                          if r["packing"] == "base3"
                          and r["domain"] == domain),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=total("ms"), plain_ms=total("plain_ms"),
            **bound(total("bytes"), total("ops"), domain),
            library_ms=total("library_ms"),
            workload=f"one decode step of {cfg.name}: "
                     f"{sum(c['per_forward'] for c in step)} packed "
                     f"matmuls at M=8, base3",
            launches_per_run={f"{r['packing']}/{r['domain']}":
                              r["launches"][name] for r in runs}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import configs
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    phase_build()
    card = card_line()
    print(f"[card] {card}")

    cfg = configs.get(ARCH)
    cases = phase_kernels(torch, cfg)

    model = registry.build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    packed = {p: ternarize_params(params, CIMConfig(mode="ternary",
                                                    packing=p))
              for p in ("base3", "trit2")}
    del params
    runs = phase_serve(torch, np, cfg, model, packed)
    parity = phase_parity(torch, np, cfg, model, packed["base3"])

    details = dict(card=card, device=torch.cuda.get_device_name(0),
                   cases=cases, serve=runs, parity=parity,
                   seconds=time.monotonic() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"[done] {details['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_summary(cases, runs, cfg)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

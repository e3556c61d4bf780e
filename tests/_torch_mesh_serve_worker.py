"""The ranks of ``tests/test_torch_mesh_serve.py``: one gloo process
group of four CPU ranks on a ``file://`` store runs every case in turn on
the port's meshed serving paths, beside the unmeshed port on rank 0, and
rank 0 saves what the test asserts on.  The params come in a file the
test writes (the reference's weights through ``repro_torch.convert``).
Imports neither jax nor repro."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
CAP = 32
PAGE = 4


class FakeClock:
    """A serve clock that moves only when the pump sleeps: every rank
    and every run replays the same arrivals."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _comm(fn):
    """(result, collectives by op name) of ``fn()``."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        out = fn()
    return out, {str(k): v for k, v in comm.get_comm_counts().items()}


def _everyone(value) -> list:
    got = [None] * WORLD
    dist.all_gather_object(got, value)
    return got


class Recorder:
    """Every decode step's logits of a scheduler (``model.decode`` /
    ``decode_paged``) and its live mask, in step order."""

    def __init__(self, eng):
        self.eng, self.model = eng, eng.model
        self.logits, self.live = [], []
        for name in ("decode", "decode_paged"):
            fn = getattr(self.model, name)

            def wrapped(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                self.logits.append(out[0][:, -1].detach().clone())
                return out
            setattr(self.model, name, wrapped)
        step = eng._decode_step

        def decode_step(tok, live):
            self.live.append(live.clone())
            return step(tok, live)
        eng._decode_step = decode_step

    def stop(self):
        for name in ("decode", "decode_paged"):
            delattr(self.model, name)
        del self.eng._decode_step

    def stacked(self) -> tuple:
        """(logits (rows, steps, V), live (rows, steps))."""
        return (torch.stack(self.logits, dim=1),
                torch.stack(self.live, dim=1))


def _submit(eng, specs):
    from repro_torch.serve import Request
    for uid, prompt, max_new, arrival in specs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new,
                           arrival_s=arrival))


def _counts(eng) -> dict:
    out = dict(chunks_run=eng.chunks_run, decode_steps=eng.decode_steps,
               occupied_slot_steps=eng.occupied_slot_steps,
               steps_run=eng.steps_run, host_transfers=eng.host_transfers)
    if hasattr(eng, "allocators"):
        out.update(pages_in_use_peak=eng.pages_in_use_peak,
                   kv_bytes_resident_peak=eng.kv_bytes_resident_peak,
                   prefix_hit_rate=eng.prefix_hit_rate,
                   stripes=eng.stripe_stats())
    return out


def _tokens(done) -> dict:
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


def _engine(kind, model, params, cim, slots, chunk, clock, **kw):
    from repro_torch.serve import PagedScheduler, Scheduler
    common = dict(capacity=CAP, slots=slots, chunk=chunk, cim=cim,
                  clock=clock, sleep=clock.sleep, device="cpu", **kw)
    if kind == "paged":
        # the gather read, which 'auto' resolves to on a mesh
        return PagedScheduler(model, params, page_size=PAGE,
                              fused_attn=False, **common)
    return Scheduler(model, params, **common)


def sched_run(kind, model, params, cim, specs, slots=4, chunk=3,
              rules=None, mesh=None, record=False):
    """One scheduler run on the trace ``specs``; meshed when ``mesh`` is
    given (every rank), else unmeshed.  Returns its tokens, counts, the
    collectives it ran, its view's shard kinds and, with ``record``,
    every decode call's logits of the whole pool."""
    from repro_torch.dist import runtime as rt
    clock = FakeClock()
    eng = _engine(kind, model, params, cim, slots, chunk, clock,
                  rules=rules, mesh=mesh)
    _submit(eng, specs)
    rec = Recorder(eng) if record else None
    try:
        done, comm = _comm(eng.run)
    finally:
        if rec is not None:
            rec.stop()
    out = dict(tokens=_tokens(done), counts=_counts(eng), comm=comm)
    if mesh is not None:
        out["split"] = None if eng._split is None else eng._split.count
        out["every_rank"] = _everyone(
            (eng.host_transfers, eng.chunks_run, eng.local_slots))
        out["kinds"] = sorted({
            f"{type(v).__name__}:{getattr(v, 'split', None)}"
            for v in eng._view["blocks"].values()})
    if rec is not None:
        logits, live = rec.stacked()
        if mesh is not None:
            logits = rt.gather_split(logits, eng._split)
            live = rt.gather_split(live, eng._split)
        out["logits"], out["live"] = logits, live
    return out


def _smoke(arch, dtype=torch.float32):
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    return registry.build(cfg)


def bucket_run(model, params, cim, prompts, rules=None, mesh=None,
               max_new=5):
    """The bucket engine's tokens and collectives, and the logits of a
    prefill and one decode step through its own calls."""
    from repro_torch.dist import runtime as rt
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, capacity=CAP, max_batch=len(prompts),
                      cim=cim, device="cpu", rules=rules, mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new=max_new))
    done, comm = _comm(eng.run)
    # the bucket's own prefill and decode step again (its row split is
    # the last bucket's, of the same rows)
    reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
    tok, state = eng._prefill(reqs)
    logits, _ = eng._decode(tok, state)
    if mesh is not None:
        tok = rt.gather_split(tok, eng._split)
        logits = rt.gather_split(logits, eng._split)
    return dict(tokens=_tokens(done), comm=comm,
                host_transfers=eng.host_transfers, steps_run=eng.steps_run,
                first=tok, logits=logits[:, -1], engine=eng)


def int8_row_shards(x, w, n: int):
    """``x (M, K) @ w`` in the int8 domain with ``w``'s K rows cut into
    ``n`` model-axis shards, one rank's part at a time without a process
    group: each shard's int32 sums (``ShardedPacked.partial_int32``, the
    kernel's int32 epilogue on the card), added in int32 as the
    all-reduce adds them, then the epilogue once."""
    from repro_torch.dist.runtime import ShardedPacked
    shards = [ShardedPacked(d.contiguous(), w.scale, w.mode, None, "row")
              for d in w.data.chunk(n, dim=-2)]
    acc, x_scale = shards[0].partial_int32(x, 0)
    for i, shard in enumerate(shards[1:], 1):
        acc = acc + shard.partial_int32(x, i)[0]
    return shards[0].epilogue(acc, x_scale, tuple(x.shape[:-1]))


def expert_halves(x, w: dict, cfg, cim, parts: int = 2):
    """``models.moe.moe_block(x, w)`` with the experts computed in
    ``parts`` groups, one rank's experts at a time, and their outputs
    joined along E, as the mesh's expert parallelism joins them."""
    from repro_torch.models import moe
    b, s, d = x.shape
    t = b * s
    g = min(moe.MOE_GROUP, t)
    pad = -t % g
    xt = torch.nn.functional.pad(x.reshape(1, t, d), (0, 0, 0, pad))
    xg = xt.reshape(-1, g, d)
    dispatch, combine, _, _ = moe.route(xg, w["router"], cfg, x.dtype)
    xe = torch.einsum("ngec,ngd->necd", dispatch, xg)
    e_l = cfg.num_experts // parts
    ye = torch.cat([moe._experts(
        xe[:, i * e_l:(i + 1) * e_l].contiguous(),
        {k: w[k][i * e_l:(i + 1) * e_l] for k in ("w1", "w2", "w3")}, cim)
        for i in range(parts)], dim=1)
    y = torch.einsum("ngec,necd->ngd", combine, ye)
    return y.reshape(1, t + pad, d)[:, :t].reshape(b, s, d)


# ----------------------------------------------------------------- cases

def case_sched(out, params, specs, prefix_specs, mesh22, mesh41):
    """Scheduler and PagedScheduler (gather), base3 float domain."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    model = _smoke("internlm2-1.8b")
    rules = shd.rules_for(model.cfg, "serve")
    cim = CIMConfig(mode="ternary", packing="base3")
    res = {}
    for kind in ("dense", "paged"):
        for tag, mesh in (("22", mesh22), ("41", mesh41)):
            res[(kind, tag)] = sched_run(kind, model, params["base3"], cim,
                                         specs, rules=rules, mesh=mesh,
                                         record=True)
        if dist.get_rank() == 0:
            res[(kind, "plain")] = sched_run(kind, model, params["base3"],
                                             cim, specs, record=True)
    # two requests owned by different DP ranks share a prompt prefix
    res[("prefix", "22")] = sched_run("paged", model, params["base3"], cim,
                                      prefix_specs, rules=rules,
                                      mesh=mesh22)
    # six slots do not divide over data = 4: the pool replicates
    res[("dense6", "41")] = sched_run("dense", model, params["base3"], cim,
                                      specs, slots=6, rules=rules,
                                      mesh=mesh41)
    if dist.get_rank() == 0:
        res[("prefix", "plain")] = sched_run("paged", model,
                                             params["base3"], cim,
                                             prefix_specs)
        res[("dense6", "plain")] = sched_run("dense", model,
                                             params["base3"], cim, specs,
                                             slots=6)
    out["sched"] = res


def case_int8(out, params, specs, prompts, mesh22):
    """The int8 domain, trit2 and base3: bucket and Scheduler logits."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    model = _smoke("internlm2-1.8b")
    rules = shd.rules_for(model.cfg, "serve")
    res = {}
    for packing in ("base3", "trit2"):
        cim = CIMConfig(mode="ternary", packing=packing, domain="int8")
        w = params[packing]
        meshed = bucket_run(model, w, cim, prompts, rules, mesh22)
        eng = meshed.pop("engine")
        meshed["kinds"] = sorted({f"{type(v).__name__}:"
                                  f"{getattr(v, 'split', None)}"
                                  for v in eng._view["blocks"].values()})
        res[(packing, "bucket", "22")] = meshed
        res[(packing, "sched", "22")] = sched_run(
            "dense", model, w, cim, specs, rules=rules, mesh=mesh22,
            record=True)
        if dist.get_rank() == 0:
            plain = bucket_run(model, w, cim, prompts)
            plain.pop("engine")
            res[(packing, "bucket", "plain")] = plain
            res[(packing, "sched", "plain")] = sched_run(
                "dense", model, w, cim, specs, record=True)
    out["int8"] = res


def _codes_backend():
    """The cuda backend's cim runner (the code route and its weight
    cache, ``CODE_WEIGHTS``) on the CPU's plain MAC, as a backend of
    its own: the cache's keying is then exercised here."""
    from repro_torch.kernels import backends
    from repro_torch.kernels.plan import BackendSpec, register_backend
    register_backend(BackendSpec(
        name="codes_cpu", platforms=frozenset({"cpu"}), priority=1,
        runner=backends._run_cuda, ops=frozenset({"cim"}),
        domains=frozenset({"float"}), packings=frozenset({"base3"}),
        kv_layouts=frozenset({"dense", "paged"})), override=True)
    return backends.CODE_WEIGHTS


def case_exact(out, params, prompts, mesh22):
    """Exact mode on float weights: bucket logits, the code cache."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import Request
    cache = _codes_backend()
    model = _smoke("internlm2-1.8b")
    rules = shd.rules_for(model.cfg, "serve")
    cim = CIMConfig(mode="exact", backend="codes_cpu")
    res = {}
    meshed = bucket_run(model, params["float"], cim, prompts, rules,
                        mesh22)
    eng = meshed.pop("engine")
    fills = cache.fills
    # warm: the same engine's view serves every later call from the cache
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=10 + i, prompt=p, max_new=4))
    eng.run()
    meshed["fills_after_warmup"] = cache.fills - fills
    meshed["cache_entries"] = len(cache)
    meshed["backend"] = eng.cim.backend
    res["22"] = meshed
    if dist.get_rank() == 0:
        plain = bucket_run(model, params["float"], cim, prompts)
        plain.pop("engine")
        res["plain"] = plain
    out["exact"] = res


def case_moe(out, params, specs, prompts, mesh22, mesh41):
    """Mixtral: the bucket engine and the Scheduler under the serve rules
    (experts over model) and under ep-data (experts over data)."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import variants
    model = _smoke("mixtral-8x7b")
    base = shd.rules_for(model.cfg, "serve")
    ep_data = variants.apply_override(base, "ep-data")
    w = params["moe"]
    res = {}
    cells = (("base", "22", base, mesh22, "int8"),
             ("ep-data", "41", ep_data, mesh41, "int8"),
             ("ep-data", "22", ep_data, mesh22, "float"))
    for rname, tag, rules, mesh, domain in cells:
        cim = CIMConfig(mode="ternary", packing="base3", domain=domain)
        b = bucket_run(model, w, cim, prompts, rules, mesh)
        eng = b.pop("engine")
        b["experts"] = sorted({
            f"{type(v).__name__}:{getattr(v, 'split', None)}:"
            f"{None if getattr(v, 'ep', None) is None else v.ep.count}"
            for k, v in eng._view["blocks"].items() if k in ("w1", "w2")})
        res[(rname, tag, "bucket")] = b
        res[(rname, tag, "sched")] = sched_run(
            "dense", model, w, cim, specs, slots=8, rules=rules,
            mesh=mesh, record=True)
    if dist.get_rank() == 0:
        for domain in ("int8", "float"):
            cim = CIMConfig(mode="ternary", packing="base3", domain=domain)
            b = bucket_run(model, w, cim, prompts)
            b.pop("engine")
            res[("plain", domain, "bucket")] = b
            res[("plain", domain, "sched")] = sched_run(
                "dense", model, w, cim, specs, slots=8, record=True)
    out["moe"] = res


def main(rank: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.dist import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", rank=rank, world_size=WORLD,
                                init_method=store)
    try:
        data = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        mesh22 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((2, 2), ("data", "model")), "cpu")
        mesh41 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((4, 1), ("data", "model")), "cpu")
        out = {}
        params, specs = data["params"], data["specs"]
        case_sched(out, params, specs, data["prefix_specs"], mesh22, mesh41)
        case_int8(out, params, specs, data["prompts"], mesh22)
        case_exact(out, params, data["prompts"], mesh22)
        case_moe(out, params, data["moe_specs"], data["prompts"], mesh22,
                 mesh41)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt"))
    finally:
        mesh_lib.destroy_process_group()

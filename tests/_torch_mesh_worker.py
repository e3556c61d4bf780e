"""The ranks of ``tests/test_torch_mesh.py``: one gloo process group of
four CPU ranks on a ``file://`` store runs every case in turn, and rank
0 saves what the test asserts on.  Imports neither jax nor repro."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _collectives(fn):
    """(result, number of collectives) of ``fn()``."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        out = fn()
    return out, comm.get_total_counts()


def _max_err(a, b) -> float:
    """max |a - b| over the max |b| of the tensor (1 where b is zero)."""
    a, b = a.double(), b.double()
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


def _tree_err(a, b) -> float:
    from repro_torch import tree
    return max(_max_err(x, y) for x, y in zip(tree.leaves(a),
                                               tree.leaves(b)))


def tp_linear(x, w, split: str, n: int, cim):
    """``cim_linear.linear`` of ``x`` on a packed ``w`` cut into ``n``
    model-axis shards, one rank's view at a time, without a process
    group: each shard's ``apply`` is cut to its ``partial`` (the planned
    kernel on the local shape), and the parts are joined as the mesh's
    collective joins them: columns concatenated ('col', N sharded) or
    partial products summed in rank order ('row', K's rows sharded)."""
    from repro_torch.core.cim_linear import linear
    from repro_torch.dist.runtime import ShardedPacked
    dim = -1 if split == "col" else -2
    data = w.data.chunk(n, dim=dim)
    scale = w.scale.chunk(n, dim=-1) if split == "col" else [w.scale] * n
    parts = []
    for i, (d, sc) in enumerate(zip(data, scale)):
        shard = ShardedPacked(d.contiguous(), sc.contiguous(), w.mode,
                              None, split)
        shard.apply = lambda xi, run, s=shard, i=i: s.partial(xi, run, i)
        parts.append(linear(x, shard, cim))
    if split == "col":
        return torch.cat(parts, dim=-1)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _smoke():
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32)
    return cfg, registry.build(cfg)


def case_train(out, mesh22):
    from repro_torch import tree
    from repro_torch.data import DataConfig, batch_for
    from repro_torch.dist import runtime as rt
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step, place_state
    cfg, model = _smoke()
    opt = adamw(1e-3)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=8, seed=0)
    gen = lambda: torch.Generator("cpu").manual_seed(0)      # noqa: E731
    ref = init_state(model, opt, gen(), "cpu")
    ref_step = make_train_step(model, opt)
    rules = shd.rules_for(cfg, "train")
    state = place_state(init_state(model, opt, gen(), "cpu"), model, opt,
                        rules, mesh22)
    step = make_train_step(model, opt, rules=rules, mesh=mesh22)
    losses, ref_losses, comms = [], [], 0
    for i in range(2):
        batch = batch_for(cfg, data, i, device="cpu")
        ref, m = ref_step(ref, batch)
        ref_losses.append(float(m["loss"]))
        (state, m), n = _collectives(lambda: step(state, batch))
        losses.append(float(m["loss"]))
        comms += n
    full = rt.gather_tree(state.params)
    # one step with the int8 sync over data, from the same start: the
    # loss is taken before the sync; AdamW's first update moves each
    # weight by at most lr, quantized or not
    first = place_state(init_state(model, opt, gen(), "cpu"), model, opt,
                        rules, mesh22)
    plain, m = step(first, batch_for(cfg, data, 0, device="cpu"))
    squeezed = make_train_step(model, opt, rules=rules, mesh=mesh22,
                               compress_grads=True)
    (comp, mc), n = _collectives(lambda: squeezed(
        place_state(init_state(model, opt, gen(), "cpu"), model, opt,
                    rules, mesh22), batch_for(cfg, data, 0, device="cpu")))
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(rt.gather_tree(comp.params)),
        tree.leaves(rt.gather_tree(plain.params))))
    out["compress"] = {"loss": float(mc["loss"]),
                       "plain_loss": float(m["loss"]), "max_gap": gap,
                       "lr": 1e-3, "collectives": n}
    out["train"] = {"losses": losses, "ref_losses": ref_losses,
                    "param_err": _tree_err(full, ref.params),
                    "opt_err": _tree_err(rt.gather_tree(state.opt_state),
                                         ref.opt_state),
                    "collectives": comms,
                    "placed": [str(p) for p in
                               state.params["blocks"]["wq"].placements]}


def case_int8(out, mesh22):
    from repro_torch.optim import int8_allgather_sync
    coord = mesh22.get_coordinate()
    g = torch.Generator().manual_seed(100 + coord[0])
    grads = {"a": torch.randn(33, 7, generator=g) * (1 + coord[0]),
             "b": torch.randn(5, generator=g)}
    (synced, _), n = _collectives(
        lambda: int8_allgather_sync(grads, mesh22, axes=("data",)))
    raw = [None] * WORLD
    dist.all_gather_object(raw, {k: v.numpy() for k, v in grads.items()})
    got = [None] * WORLD
    dist.all_gather_object(got, {k: v.numpy() for k, v in synced.items()})
    out["int8"] = {"raw": raw, "synced": got, "collectives": n,
                   "coords": [None] * WORLD}
    dist.all_gather_object(out["int8"]["coords"], list(coord))


def case_elastic(out, tmp, mesh22, mesh41):
    from repro_torch.data import DataConfig
    from repro_torch.dist import runtime as rt
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    cfg, model = _smoke()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=8, seed=0)

    def trainer(total, d, mesh):
        tc = TrainerConfig(total_steps=total, ckpt_dir=d, ckpt_interval=4,
                           ckpt_keep=3, seed=0)
        return Trainer(model, adamw(1e-3), data, tc, mesh=mesh,
                       device="cpu")
    first = trainer(4, os.path.join(tmp, "elastic"), mesh22)
    first.run()
    dist.barrier()
    second = trainer(8, os.path.join(tmp, "elastic"), mesh41)
    resumed, n = _collectives(second.run)
    straight = trainer(8, os.path.join(tmp, "straight"), mesh22)
    whole = straight.run()
    out["elastic"] = {
        "losses": [h["loss"] for h in first.history + second.history],
        "ref_losses": [h["loss"] for h in straight.history],
        "param_err": _tree_err(rt.gather_tree(resumed.params),
                               rt.gather_tree(whole.params)),
        "resumed_placements": [str(p) for p in
                               resumed.params["blocks"]["w1"].placements],
        "collectives": n}


def case_serve(out, mesh22):
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.dist import runtime as rt
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import Request, ServeEngine
    cfg, model = _smoke()
    rules = shd.rules_for(cfg, "serve")
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    out["serve"] = {}
    for packing in ("base3", "trit2"):
        cim = CIMConfig(mode="ternary", packing=packing)
        params = ternarize_params(
            model.init(torch.Generator("cpu").manual_seed(0), "cpu"), cim)
        runs = {}
        for meshed in (False, True):
            eng = ServeEngine(model, params, capacity=32, max_batch=4,
                              cim=cim, device="cpu",
                              rules=rules if meshed else None,
                              mesh=mesh22 if meshed else None)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p.tolist(), max_new=6))
            done, n = _collectives(eng.run)
            runs[meshed] = {"tokens": [r.out_tokens for r in done],
                            "host_transfers": eng.host_transfers,
                            "steps_run": eng.steps_run,
                            "collectives": n}
        # the logits of a prefill and one decode step on the rows
        tokens = torch.as_tensor(prompts)
        ref_logits, ref_state = model.prefill(params, tokens, 32, cim=cim)
        ref_next, _ = model.decode(
            params, ref_logits[:, -1].argmax(-1, keepdim=True).int(),
            ref_state, cim=cim)
        placed = rt.place_tree(params, model.param_specs, rules, mesh22)
        view = rt.param_view(placed)
        kinds = sorted({type(v).__name__ for v in view["blocks"].values()})
        split = rt.batch_split(rules, mesh22, tokens.shape[0])
        local = rt.shard_rows(tokens, split)
        logits, state = model.prefill(view, local, 32, cim=cim)
        nxt, _ = model.decode(view, logits[:, -1].argmax(-1, keepdim=True)
                              .int(), state, cim=cim)
        full = lambda x: rt.gather_split(x, split)  # noqa: E731
        runs["logit_err"] = max(_max_err(full(logits), ref_logits),
                                _max_err(full(nxt), ref_next))
        runs["view_kinds"] = kinds
        out["serve"][packing] = runs


def case_refusals(out, mesh22):
    """What does not run on a mesh yet raises, naming why."""
    from repro_torch import configs
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.dist import sharding as shd
    from repro_torch.serve import ServeEngine
    from repro_torch.train import init_state, make_train_step, place_state
    cfg, model = _smoke()
    got = {}

    def refused(name, fn):
        try:
            fn()
            got[name] = None
        except (NotImplementedError, ValueError) as e:
            got[name] = str(e)
    params = model.init(torch.Generator("cpu").manual_seed(0), "cpu")
    device = CIMConfig(mode="ternary", packing="base3", fidelity="device")
    refused("fidelity", lambda: ServeEngine(
        model, ternarize_params(params, device), cim=device, device="cpu",
        mesh=mesh22))
    refused("legacy", lambda: ServeEngine(model, params, device="cpu",
                                          on_device_loop=False,
                                          mesh=mesh22))
    for arch in ("zamba2-7b", "whisper-large-v3"):
        other = registry.build(configs.smoke(arch))
        refused(f"serve {arch}", lambda: ServeEngine(
            other, other.init(torch.Generator("cpu").manual_seed(0), "cpu"),
            device="cpu", mesh=mesh22))
    dots = registry.build(dataclasses.replace(cfg, remat="dots"))
    opt = adamw(1e-3)
    state = place_state(init_state(dots, opt, torch.Generator(
        "cpu").manual_seed(0), "cpu"), dots, opt,
        shd.rules_for(cfg, "train"), mesh22)
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    step = make_train_step(dots, opt, mesh=mesh22)
    refused("remat dots", lambda: step(state, batch))
    out["refusals"] = got


def main(rank: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.dist import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", rank=rank, world_size=WORLD,
                                init_method=store)
    try:
        mesh22 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((2, 2), ("data", "model")), "cpu")
        mesh41 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((4, 1), ("data", "model")), "cpu")
        out = {}
        case_train(out, mesh22)
        case_int8(out, mesh22)
        case_elastic(out, tmp, mesh22, mesh41)
        case_serve(out, mesh22)
        case_refusals(out, mesh22)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt"))
    finally:
        mesh_lib.destroy_process_group()

"""The ranks of ``tests/test_torch_mesh_train.py``: one gloo process group
of four CPU ranks on a ``file://`` store runs every case in turn on
``(2, 2)`` and ``(4, 1)`` meshes of ``("data", "model")``, with the
unmeshed port beside it on rank 0, and rank 0 saves what the test
asserts on.  Imports neither jax nor repro."""
import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
SEQ, ROWS = 16, 8                 # a step's batch: ROWS x SEQ tokens
PIECE = 1 << 11                   # optimizers.PIECE in the Adafactor case
TIE_TOKEN = 7                     # the exact case's planted token
TIE_AT = ((1, 3), (5, 7))         # (row, position): rows of ranks 0 and 2
MOE_CAPACITY = 0.5                # the MoE case's capacity factor: drops


def _collectives(fn):
    """(result, {collective: count}) of ``fn()``."""
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        out = fn()
    return out, {str(k): v for k, v in comm.get_comm_counts().items()}


def _max_err(a, b) -> float:
    """max |a - b| over the max |b| of the tensor (1 where b is zero)."""
    a, b = a.double(), b.double()
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale


def _tree_err(a, b) -> float:
    from repro_torch import tree
    return max(_max_err(x, y) for x, y in zip(tree.leaves(a),
                                               tree.leaves(b)))


def _model(arch: str, **kw):
    from repro_torch import configs
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32,
                              **kw)
    return registry.build(cfg)


def _init(model, opt, seed: int = 0):
    """The unmeshed state of a seeded draw; a VLM's gates (zeros at init,
    which would make every cross block add nothing) seeded nonzero."""
    from repro_torch.train import init_state
    state = init_state(model, opt, torch.Generator("cpu").manual_seed(seed),
                       "cpu")
    if model.cfg.family == "vlm":
        g = state.params["cross_blocks"]["gate"]
        g.copy_(torch.linspace(0.3, 0.9, g.shape[0]))
    return state


def _batches(model, steps: int, seed: int = 0) -> list:
    from repro_torch.data import DataConfig, batch_for
    data = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                      global_batch=ROWS, seed=seed)
    out = []
    for i in range(steps):
        b = batch_for(model.cfg, data, i, device="cpu")
        out.append({k: (v.float() if v.is_floating_point() else v)
                    for k, v in b.items()})
    return out


def _pair(model, opt, batches, meshes: dict, cim=None, state=None,
          ref=True, log=None, microbatches: int = 1) -> dict:
    """The steps of ``batches`` unmeshed (rank 0, with ``ref``) and on each
    mesh from the same state: losses, the errors of the gathered params
    and optimizer state against the unmeshed run, the collectives each
    meshed run made, and (with ``log``, a :func:`_recording`) the MoE
    block's record of each run."""
    from repro_torch.dist import runtime as rt
    from repro_torch.dist import sharding as shd
    from repro_torch.train import make_train_step, place_state
    start = state if state is not None else _init(model, opt)
    rules = shd.rules_for(model.cfg, "train")
    out = {}
    if ref and dist.get_rank() == 0:
        s = _clone(start)
        step = make_train_step(model, opt, cim=cim,
                               microbatches=microbatches)
        losses = []
        _clear(log)
        for b in batches:
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        out["plain"] = dict(losses=losses, params=s.params,
                            opt_state=s.opt_state, log=_taken(log))
    for tag, mesh in meshes.items():
        s = place_state(_clone(start), model, opt, rules, mesh)
        step = make_train_step(model, opt, cim=cim, rules=rules, mesh=mesh,
                               microbatches=microbatches)
        losses, comm = [], {}
        _clear(log)
        for b in batches:
            (s, m), n = _collectives(lambda: step(s, b))
            losses.append(float(m["loss"]))
            for k, v in n.items():
                comm[k] = comm.get(k, 0) + v
        params, opt_state = rt.gather_tree(s.params), rt.gather_tree(
            s.opt_state)
        out[tag] = dict(losses=losses, comm=comm, params=params,
                        opt_state=opt_state, log=_taken(log))
    if "plain" in out:
        for tag in meshes:
            out[tag]["param_err"] = _tree_err(out[tag]["params"],
                                              out["plain"]["params"])
            out[tag]["opt_err"] = _tree_err(out[tag]["opt_state"],
                                            out["plain"]["opt_state"])
    for rec in out.values():
        del rec["params"], rec["opt_state"]
    return out


def _clone(state):
    from repro_torch import tree
    from repro_torch.train import TrainState
    c = lambda t: None if t is None else tree.map_leaves(  # noqa: E731
        lambda x: x.clone(), t)
    return TrainState(c(state.params), c(state.opt_state),
                      state.step.clone(), c(state.ef_residual))


def case_adafactor(out, meshes):
    """Adafactor on smoke internlm2-1.8b, ``PIECE`` cut so that its
    stacked leaves take the sliced clip: each rank's leaf pieces and
    their factored moments split over both mesh dims."""
    from repro_torch.optim import adafactor, optimizers
    model = _model("internlm2-1.8b")
    old = optimizers.PIECE
    optimizers.PIECE = PIECE
    try:
        sliced = [n for n, x in _init(model, adafactor(1e-2)).params[
            "blocks"].items() if len(optimizers._parts(x)) > 1]
        out["adafactor"] = _pair(model, adafactor(1e-2),
                                 _batches(model, 2), meshes)
    finally:
        optimizers.PIECE = old
    out["adafactor"]["sliced"] = sliced
    from repro_torch.dist import sharding as shd
    from repro_torch.train import place_state
    opt = adafactor(1e-2)
    placed = place_state(_init(model, opt), model, opt,
                         shd.rules_for(model.cfg, "train"), meshes["22"])
    out["adafactor"]["placed"] = {
        k: [str(p) for p in v.placements]
        for k, v in placed.opt_state["blocks"]["wq"].items()}


def _tie_batch(model) -> tuple:
    """A batch whose first exact call's input amax ties across ranks: the
    planted token's embedding row is one-hot, so its rms-normalised row
    holds the call's largest |x| once, and it sits in rows 1 and 5 (on
    ranks 0 and 2 of (4, 1), data ranks 0 and 1 of (2, 2))."""
    batch = _batches(model, 2, seed=3)
    for b in batch:
        t = b["tokens"]
        t[t == TIE_TOKEN] = TIE_TOKEN + 1
        for r, c in TIE_AT:
            t[r, c] = TIE_TOKEN
    return batch


def case_exact(out, meshes):
    """Exact mode (the plain torch route, remat full) on smoke
    internlm2-1.8b with a planted cross-rank tie; the int8 domain's
    config, which trains as exact mode; and max_rows alone against the
    unmeshed tie split."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.optim import adamw
    model = _model("internlm2-1.8b", remat="full")
    opt = adamw(1e-3)
    state = _init(model, opt, seed=1)
    with torch.no_grad():
        row = state.params["embed"][TIE_TOKEN]
        row.zero_()
        row[0] = 1.0
    batches = _tie_batch(model)
    cim = CIMConfig(mode="exact")
    out["exact"] = _pair(model, opt, batches, meshes, cim=cim, state=state)
    int8 = _pair(model, opt, batches, {"22": meshes["22"]},
                 cim=CIMConfig(mode="exact", domain="int8"), state=state,
                 ref=False)
    out["exact"]["int8_losses"] = int8["22"]["losses"]
    # the tie: the amax of the first layer's input over the whole call
    x = _first_input(model, state.params, batches[0]["tokens"])
    top = x.abs().amax()
    hits = (x.abs() == top).nonzero()[:, 0].tolist()
    out["exact"]["tie_rows"] = sorted({h // SEQ for h in hits})
    out["max_rows"] = _max_rows_case(meshes["41"])


def _first_input(model, params, tokens):
    """The first exact call's input: layer 0's normed embedding rows."""
    from repro_torch.models.layers import embed, rms_norm
    x = embed(params["embed"], tokens)
    x = rms_norm(x, params["blocks"]["ln1"][0], model.cfg.norm_eps)
    return x.reshape(-1, x.shape[-1])


MAX_X = np.array([[0.5, -1.0, 2.0], [5.0, -5.0, 1.0], [0.0, 3.0, -2.0],
                  [1.0, 1.0, 1.0], [4.0, -4.5, 2.0], [-5.0, 0.5, 0.1],
                  [2.0, 2.0, -3.0], [1.5, -0.5, 0.25]], np.float32)


def _max_rows_case(mesh41) -> dict:
    """Each rank of (4, 1) holds two rows of MAX_X, whose |max| 5 ties
    three times over ranks 0 and 2; rank r's loss is (r + 1) * max |x|.
    Its gradient, gathered: the reference's grad of 10 * max |x| (the
    sum of the ranks' losses) on the whole call."""
    from repro_torch.dist import runtime as rt
    from repro_torch.dist import sharding as shd
    split = rt.batch_split(shd.train_rules(), mesh41, MAX_X.shape[0])
    x = rt.shard_rows(torch.from_numpy(MAX_X), split).requires_grad_()
    m = rt.max_rows(x.abs(), split)
    (m * (split.index + 1)).backward()
    grads = rt.gather_split(x.grad, split)
    return dict(max=float(m.detach()), grad=grads.numpy(), count=split.count)


def case_moe(out, meshes):
    """Smoke mixtral-8x7b and kimi-k2 (remat full, capacity factor
    MOE_CAPACITY, so that assignments drop): 128 tokens, one routing
    group spanning every rank; and mixtral's step in two microbatches.
    Each route's dispatch and choices and each aux value are recorded
    in call order."""
    from repro_torch.models import moe
    out["moe"] = {}
    with _recording(moe) as log:
        for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b"):
            model = _model(arch, remat="full",
                           moe_capacity_factor=MOE_CAPACITY)
            out["moe"][arch] = _pair(model, _sgd(), _batches(model, 1),
                                     meshes, log=log)
        # two microbatches of 64 tokens, each one group: a rank holds
        # its block of each
        model = _model("mixtral-8x7b", remat="full",
                       moe_capacity_factor=MOE_CAPACITY)
        out["moe"]["microbatches"] = _pair(
            model, _sgd(), _batches(model, 1), {"22": meshes["22"]},
            log=log, microbatches=2)


@contextlib.contextmanager
def _recording(moe):
    """Log every ``route`` call's (dispatch, one-hot choices) under grad
    and every ``_aux`` value of the MoE block."""
    log = {"route": [], "aux": []}
    route, aux = moe.route, moe._aux

    def rec_route(*a, **k):
        got = route(*a, **k)
        if torch.is_grad_enabled():
            log["route"].append((got[0].detach().clone(),
                                 got[3].detach().clone()))
        return got

    def rec_aux(*a, **k):
        v = aux(*a, **k)
        log["aux"].append(float(v))
        return v
    moe.route, moe._aux = rec_route, rec_aux
    try:
        yield log
    finally:
        moe.route, moe._aux = route, aux


def _clear(log) -> None:
    if log is not None:
        for v in log.values():
            v.clear()


def _taken(log):
    return None if log is None else {k: list(v) for k, v in log.items()}


FAMILIES = ("zamba2-7b", "xlstm-125m", "whisper-large-v3",
            "llama-3.2-vision-90b")


def _sgd():
    """SGD with momentum, unclipped: linear in the grads, so a leaf's
    error is its gradient's (AdamW's first steps, g / (|g| + eps), turn
    a summation-order difference in a gradient that cancels to near eps
    into one of the update's size)."""
    from repro_torch.optim import sgd
    return sgd(1e-2, momentum=0.9)


def case_families(out, mesh22):
    """The recurrent and cross families, one step on (2, 2): SGD with
    momentum, the VLM's Adafactor, as its launcher trains it.  (A second
    step carries the first one's f32 summation-order difference through
    zamba2's and xlstm's recurrences: 1.4e-5 and 1.6e-5 of a leaf's max
    after two SGD steps, where one step stays below 1e-6.)"""
    from repro_torch.optim import adafactor
    out["families"] = {}
    for arch in FAMILIES:
        model = _model(arch)
        opt = adafactor(1e-2) if model.cfg.family == "vlm" else _sgd()
        out["families"][arch] = _pair(model, opt, _batches(model, 1),
                                      {"22": mesh22})


def case_trainer(out, tmp, mesh22, mesh41):
    """An Adafactor Trainer on (2, 2) that crashes before step 3's
    update and replays from its step-2 checkpoint, stops at step 4;
    another on (4, 1) resumes there to step 8; against 8 straight steps
    on (2, 2)."""
    from repro_torch.data import DataConfig
    from repro_torch.dist import runtime as rt
    from repro_torch.optim import adafactor
    from repro_torch.train import FailurePlan, Trainer, TrainerConfig
    model = _model("internlm2-1.8b")
    data = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                      global_batch=ROWS, seed=0)

    def trainer(total, d, mesh, plan=None):
        tc = TrainerConfig(total_steps=total, ckpt_dir=d, ckpt_interval=2,
                           ckpt_keep=4, seed=0)
        return Trainer(model, adafactor(1e-2), data, tc, mesh=mesh,
                       device="cpu", failure_plan=plan)
    first = trainer(4, os.path.join(tmp, "ada"), mesh22,
                    FailurePlan(crash_at=(3,)))
    first.run()
    dist.barrier()
    second = trainer(8, os.path.join(tmp, "ada"), mesh41)
    resumed = second.run()
    straight = trainer(8, os.path.join(tmp, "ada_straight"), mesh22)
    whole = straight.run()
    # a replayed step's record comes again: the last one counts
    done = {h["step"]: h["loss"] for h in first.history + second.history}
    out["trainer"] = {
        "losses": list(done.values()), "steps": list(done),
        "ref_losses": [h["loss"] for h in straight.history],
        "restarts": first.restarts,
        "param_err": _tree_err(rt.gather_tree(resumed.params),
                               rt.gather_tree(whole.params)),
        "opt_err": _tree_err(rt.gather_tree(resumed.opt_state),
                             rt.gather_tree(whole.opt_state)),
        "resumed_placements": {
            k: [str(p) for p in v.placements]
            for k, v in resumed.opt_state["blocks"]["wq"].items()}}


def case_reference(out, inputs, mesh22):
    """One step from the reference's state on (2, 2): Adafactor on smoke
    internlm2-1.8b and SGD with momentum on smoke mixtral-8x7b; the
    gathered params, optimizer state and metrics."""
    from repro_torch.dist import runtime as rt
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adafactor, optimizers, sgd
    from repro_torch.train import make_train_step, place_state
    out["reference"] = {}
    for name, arch in (("adafactor", "internlm2-1.8b"),
                       ("moe", "mixtral-8x7b")):
        case = inputs[name]
        model = _model(arch)
        opt = (adafactor(optimizers.warmup_cosine(1e-1, 2, 10))
               if name == "adafactor" else
               sgd(optimizers.warmup_cosine(1e-2, 0, 10), momentum=0.9))
        rules = shd.rules_for(model.cfg, "train")
        state = place_state(case["state"], model, opt, rules, mesh22)
        step = make_train_step(model, opt, rules=rules, mesh=mesh22)
        new, m = step(state, case["batch"])
        out["reference"][name] = dict(
            params=rt.gather_tree(new.params),
            opt_state=rt.gather_tree(new.opt_state),
            metrics={k: float(v) for k, v in m.items()})


def main(rank: int, store: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.dist import mesh as mesh_lib
    mesh_lib.init_process_group("cpu", rank=rank, world_size=WORLD,
                                init_method=store)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        mesh22 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((2, 2), ("data", "model")), "cpu")
        mesh41 = mesh_lib.make_mesh(
            mesh_lib.MeshSpec((4, 1), ("data", "model")), "cpu")
        meshes = {"22": mesh22, "41": mesh41}
        out = {}
        case_reference(out, inputs, mesh22)
        case_adafactor(out, meshes)
        case_exact(out, meshes)
        case_moe(out, meshes)
        case_families(out, mesh22)
        case_trainer(out, tmp, mesh22, mesh41)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt"))
    finally:
        mesh_lib.destroy_process_group()

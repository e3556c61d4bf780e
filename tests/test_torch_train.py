"""The port's optimizers, gradient compression, data pipeline and
checkpoints (``repro_torch.optim``, ``.data``, ``.checkpoint``): the
reference's own tests of them (``tests/test_optim.py``,
``test_data.py``, ``test_checkpoint.py``) on the port, then the port
held against ``repro`` on the same numpy inputs.

Bars:

* one update of each optimizer: SGD (with and without momentum)
  bitwise; AdamW and Adafactor within 4 ulp of each tensor's largest
  magnitude, params, state and the metrics.  Adafactor's row and column
  means sum in another order than XLA's, and ``rsqrt``, ``pow`` and
  ``cos`` are a libm's, not XLA's, so neither is bitwise;
* ``warmup_cosine`` within 4 ulp over steps 0-120 (``cos``);
* ``compress_int8`` / ``ef_compress_grads`` bitwise (both round half to
  even, both divide truly);
* ``lm_batch``'s tokens and labels and ``class_batch``'s labels bitwise
  at two seeds and steps; ``class_batch``'s ``x`` within 4 ulp (the
  reference's ``normal`` is XLA's ``erf_inv``);
* a checkpoint written by either package restores in the other, leaf
  for leaf bitwise, bf16 included.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (jbatch, np_tree, one_thread,  # noqa: F401
                              port_model, ref_model, within_ulps)
from repro import checkpoint as jck
from repro import optim as joptim
from repro.optim import optimizers as joptim_impl
from repro.data import pipeline as jdata
from repro.models.config import ParamDef, init_params, is_def
from repro.train.step import TrainState as JTrainState
from repro.train.step import init_state as jinit_state
from repro_torch import checkpoint as ck
from repro_torch import optim, tree
from repro_torch.convert import state_from_reference
from repro_torch.data import (ClassTaskConfig, DataConfig, batch_for,
                              class_batch, class_means, entropy_floor,
                              lm_batch)
from repro_torch.data.pipeline import _A, _B
from repro_torch.models.config import ParamSpec
from repro_torch.optim import (adafactor, adamw, compress_int8,
                               decompress_int8, ef_compress_grads, ef_init,
                               int8_allgather_sync, sgd, warmup_cosine)
from repro_torch.train import TrainState

SHAPES = {"w": (32, 16), "b": (16,), "stack": (4, 8, 8)}
SPECS = {"w": ParamSpec((32, 16)), "b": ParamSpec((16,), "zeros"),
         "stack": ParamSpec((4, 8, 8))}


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: s.initialize(g, "cpu", torch.float32)
            for k, s in SPECS.items()}


# ------------------------------------------------- the reference's tests

def _quadratic_steps(opt, steps=60):
    params = _params()
    target = {k: torch.full_like(p, 0.5) for k, p in params.items()}
    state = opt.init(params)

    def loss_fn(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in sorted(p))

    l0 = float(loss_fn(params))
    for i in range(steps):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        g = torch.autograd.grad(loss_fn(live), [live[k] for k in params])
        params, state, _ = opt.update(dict(zip(params, g)), state, params, i)
    return l0, float(loss_fn(params))


def test_adamw_descends():
    l0, l1 = _quadratic_steps(adamw(5e-2))
    assert l1 < 0.1 * l0


def test_adafactor_descends():
    l0, l1 = _quadratic_steps(adafactor(5e-1))
    assert l1 < 0.2 * l0


def test_sgd_descends():
    l0, l1 = _quadratic_steps(sgd(5e-2, momentum=0.9))
    assert l1 < 0.1 * l0


def _assert_defs_match_state(defs_tree, state):
    flat_d = [d for _, d in _spec_leaves(defs_tree)]
    flat_s = tree.leaves(state)
    assert len(flat_d) == len(flat_s)
    for d, s in zip(flat_d, flat_s):
        assert tuple(d.shape) == tuple(s.shape), (d, s.shape)
        assert d.dtype == s.dtype


def _spec_leaves(specs, path=()):
    if isinstance(specs, ParamSpec):
        yield path, specs
        return
    for k in sorted(specs):
        yield from _spec_leaves(specs[k], path + (k,))


def test_adamw_state_defs_match_init():
    opt = adamw(1e-3)
    _assert_defs_match_state(opt.state_defs(SPECS), opt.init(_params()))


def test_adafactor_state_defs_match_init():
    opt = adafactor(1e-3)
    _assert_defs_match_state(opt.state_defs(SPECS), opt.init(_params()))
    # factored: the (32,16) matrix must NOT have a full second moment
    st = opt.init(_params())
    assert set(st["w"].keys()) == {"r", "c"}
    assert st["w"]["r"].shape == (32,)
    assert st["w"]["c"].shape == (16,)
    assert st["stack"]["r"].shape == (4, 8)
    assert st["b"]["v"].shape == (16,)


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert float(lr(99)) < 0.2


def test_int8_roundtrip_error_bound():
    g = torch.randn((128, 64), generator=torch.Generator().manual_seed(1))
    q, s = compress_int8(g)
    err = (decompress_int8(q, s) - g).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_is_unbiased_over_steps():
    """Sum of EF-compressed grads converges to sum of true grads."""
    base = torch.randn((64, 32), generator=torch.Generator().manual_seed(2))
    resid = ef_init({"w": base})
    total_true = torch.zeros((64, 32))
    total_comp = torch.zeros((64, 32))
    for i in range(30):
        g = {"w": base * (1 + 0.1 * i)}
        comp, resid = ef_compress_grads(g, resid)
        total_true += g["w"]
        total_comp += comp["w"]
    # residual is bounded; accumulated difference == final residual
    diff = (total_true - total_comp).abs()
    assert float(diff.max()) <= float(resid["w"].abs().max()) + 1e-5


CFG = DataConfig(vocab_size=512, seq_len=64, global_batch=8, seed=3)


def test_deterministic():
    a = lm_batch(CFG, 5, device="cpu")
    b = lm_batch(CFG, 5, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    c = lm_batch(CFG, 6, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


def test_labels_are_shifted_tokens():
    b = lm_batch(CFG, 0, device="cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_sharding_reconstructs_global_batch():
    """2 hosts each generating half == 1 host generating all."""
    full = lm_batch(CFG, 2, device="cpu")
    h0 = lm_batch(CFG, 2, host_index=0, num_hosts=2, device="cpu")
    h1 = lm_batch(CFG, 2, host_index=1, num_hosts=2, device="cpu")
    stitched = torch.cat([h0["tokens"], h1["tokens"]])
    assert torch.equal(full["tokens"], stitched)


def test_chain_structure_is_learnable():
    """With noise/restart off, tokens follow t+1 = (a*t + b) mod v exactly."""
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=4, seed=1,
                     restart_p=0.0, noise_p=0.0)
    t = lm_batch(cfg, 0, device="cpu")["tokens"]
    assert torch.equal(t[:, 1:], (_A * t[:, :-1] + _B) % cfg.v)


def test_entropy_floor_bounds():
    h = entropy_floor(CFG)
    assert 0.0 < h < np.log(CFG.v)


def test_tokens_in_vocab_range():
    b = lm_batch(CFG, 9, device="cpu")
    assert int(b["tokens"].min()) >= 0
    assert int(b["tokens"].max()) < CFG.vocab_size


def test_class_batch():
    cfg = ClassTaskConfig(num_classes=4, dim=16, snr=10.0)
    b = class_batch(cfg, 0, batch=64, device="cpu")
    assert b["x"].shape == (64, 16)
    assert int(b["y"].max()) < 4
    # high SNR -> nearest-mean classifier near perfect
    mu = class_means(cfg, device="cpu")
    pred = torch.cdist(b["x"], mu).argmin(dim=1)
    assert float((pred == b["y"]).float().mean()) > 0.95


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.ones((3,)), torch.arange(5)]}


def _equal_trees(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_roundtrip_with_target(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 7, t, extra={"note": "hi"})
    got, extra = ck.restore(str(tmp_path), target=t, device="cpu")
    assert extra["note"] == "hi"
    _equal_trees(t, got)


def test_bfloat16_preserved(tmp_path):
    t = {"x": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    ck.save(str(tmp_path), 0, t)
    got, _ = ck.restore(str(tmp_path), target=t, device="cpu")
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(t["x"], got["x"])


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 13):
        ck.save(str(tmp_path), s, t)
    assert ck.latest_step(str(tmp_path)) == 13
    removed = ck.gc_old_steps(str(tmp_path), keep=2)
    assert removed == [1, 5]
    assert ck.available_steps(str(tmp_path)) == [9, 13]


def test_crash_mid_save_preserves_previous(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 10, t)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ck.save(str(tmp_path), 20, t, _fail_after_files=1)
    # the wreckage is a .tmp dir; step 10 is still the latest COMPLETE one
    assert ck.latest_step(str(tmp_path)) == 10
    got, _ = ck.restore(str(tmp_path), target=t, device="cpu")
    assert torch.equal(got["params"]["w"], t["params"]["w"])
    # next save cleans the wreckage
    ck.save(str(tmp_path), 20, t)
    assert ck.latest_step(str(tmp_path)) == 20


def test_restore_without_target_builds_dict(tmp_path):
    t = {"a": {"b": torch.ones((2, 2))}, "c": torch.zeros((3,))}
    ck.save(str(tmp_path), 3, t)
    got, _ = ck.restore(str(tmp_path), device="cpu")
    assert torch.equal(got["a"]["b"], t["a"]["b"])
    assert torch.equal(got["c"], t["c"])


def test_restore_onto_a_device_roundtrip(tmp_path):
    """``restore(device=)``, the port's counterpart of the reference's
    re-shard: every leaf on the named device, the values unchanged; the
    default device is the card, which raises without one."""
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    got, _ = ck.restore(str(tmp_path), target=t, device="cpu")
    _equal_trees(t, got)
    assert all(x.device.type == "cpu" for x in tree.leaves(got))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ck.restore(str(tmp_path), target=t)


def test_manager_interval(tmp_path):
    m = ck.CheckpointManager(str(tmp_path), interval=5, keep=2)
    t = _tree()
    for s in range(12):
        m.maybe_save(s, t)
    assert ck.available_steps(str(tmp_path)) == [5, 10]


# --------------------------------------------- parity with the reference

PDEFS = {"w": ParamDef((32, 16), ("embed", "mlp")),
         "b": ParamDef((16,), ("none",), "zeros"),
         "stack": ParamDef((4, 8, 8), ("layers", "embed", "mlp")),
         "odd": ParamDef((3, 1, 5), ("layers", "embed", "mlp"))}

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.05),
    "sgd_momentum": lambda o: o.sgd(0.05, momentum=0.9, max_grad_norm=1.0),
    "adamw": lambda o: o.adamw(o.warmup_cosine(1e-2, 2, 10),
                               weight_decay=0.1),
    "adafactor": lambda o: o.adafactor(o.warmup_cosine(1e-1, 2, 10)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_the_reference(name):
    """Three updates (steps 0-2, growing grads, the schedule in its warmup
    and past it) from the reference's params: SGD bitwise, AdamW and
    Adafactor within 4 ulp of each tensor's max."""
    _three_updates_match_the_reference(name)


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw", "adafactor"])
def test_sliced_leaves_update_as_whole_leaves(name, monkeypatch):
    """With ``optim.optimizers.PIECE`` at 8 elements the stacked leaves
    ("stack" 4 x 8 x 8, "odd" 3 x 1 x 5) are normed, clipped and updated
    one slice of their leading axis at a time, as zamba2-7b's Mamba2
    in_proj is at full width: three updates' params, state and grad norm
    within 8 ulp of each tensor's max of the whole-leaf path's (4
    measured: the norm sums the slices in another order, and the clip
    and Adafactor's RMS take it up)."""
    from repro_torch.optim import optimizers

    def three_updates():
        rng = np.random.default_rng(0)
        params = {k: torch.from_numpy(rng.standard_normal(d.shape).astype(
            np.float32)) for k, d in PDEFS.items()}
        opt = OPTIMIZERS[name](optim)
        state = opt.init(params)
        for step in range(3):
            g = {k: torch.from_numpy((0.3 * (1 + step) * rng.standard_normal(
                d.shape)).astype(np.float32)) for k, d in PDEFS.items()}
            params, state, m = opt.update(
                g, state, params, torch.tensor(step, dtype=torch.int32))
        return tree.leaves(params) + tree.leaves(state) + [m["grad_norm"]]
    whole = three_updates()
    monkeypatch.setattr(optimizers, "PIECE", 8)
    assert len(optimizers._parts(torch.zeros(3, 1, 5))) == 3
    assert len(optimizers._parts(torch.zeros(16, 16))) == 1
    sliced = three_updates()
    assert len(whole) == len(sliced)
    for want, got in zip(whole, sliced):
        assert within_ulps(got.numpy(), want.numpy(), 8), name


def _three_updates_match_the_reference(name):
    jparams = init_params(jax.random.key(0), PDEFS, jnp.float32)
    rng = np.random.default_rng(1)
    grads = [{k: (0.3 * (1 + i) * rng.standard_normal(d.shape)).astype(
        np.float32) for k, d in PDEFS.items()} for i in range(3)]
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jstate = jopt.init(jparams)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    tstate = topt.init(tparams)
    for step, g in enumerate(grads):
        jparams, jstate, jm = jopt.update(jbatch(g), jstate, jparams, step)
        tparams, tstate, tm = topt.update(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, tstate,
            tparams, torch.tensor(step, dtype=torch.int32))
        pairs = list(zip(jax.tree.leaves(jparams), tree.leaves(tparams)))
        pairs += list(zip(jax.tree.leaves(jstate), tree.leaves(tstate)))
        pairs += [(jm[k], tm[k]) for k in ("grad_norm", "lr")]
        for want, got in pairs:
            want, got = np.asarray(want), got.numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            if name.startswith("sgd"):
                np.testing.assert_array_equal(got, want)
            else:
                assert within_ulps(got, want, 4), (name, step)


def test_adamw_updates_bf16_params_in_f32():
    """bf16 params: ``p - lr * upd.astype(bf16)`` is computed in f32 and
    rounded once, as the reference's f32 learning rate promotes it (a
    torch product with a 0-d f32 tensor would stay bf16)."""
    jparams = {"w": (jax.random.normal(jax.random.key(3), (16, 8))
                     ).astype(jnp.bfloat16)}
    g = {"w": (0.1 * np.random.default_rng(4).standard_normal((16, 8))
               ).astype(jnp.bfloat16)}
    jopt, topt = joptim.adamw(3e-3), optim.adamw(3e-3)
    want, _, _ = jopt.update(jbatch(g), jopt.init(jparams), jparams, 0)
    tparams = {"w": torch.from_numpy(np.asarray(jparams["w"]).view(
        np.int16).copy()).view(torch.bfloat16)}
    tg = {"w": torch.from_numpy(np.asarray(g["w"]).view(
        np.int16).copy()).view(torch.bfloat16)}
    got, _, _ = topt.update(tg, topt.init(tparams), tparams, 0)
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        np.asarray(want["w"]).view(np.int16))


def test_clip_by_global_norm_of_bf16_grads_matches_the_reference():
    """bf16 grads past max_norm: the norm within 1e-6 of the reference's
    (relative: 1836 squares summed in another order), and each clipped
    grad bitwise the reference's product at the port's norm, in f32
    rounded once."""
    rng = np.random.default_rng(8)
    g = {k: rng.standard_normal(shape).astype(jnp.bfloat16)
         for k, shape in (("a", (64, 24)), ("b", (300,)))}
    _, jn = joptim_impl.clip_by_global_norm(jbatch(g), 1.0)
    got, tn = optim.clip_by_global_norm(
        {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
            torch.bfloat16) for k, v in g.items()}, 1.0)
    assert float(jn) > 1.0
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    scale = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.asarray(tn.numpy()),
                                               1e-12))
    for k in g:
        want = (jnp.asarray(g[k]) * scale).astype(jnp.bfloat16)
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_state_defs_match_the_reference():
    """Each optimizer's state_defs of the port's ParamSpecs have the
    reference's shapes and dtypes, leaf for leaf in its order."""
    specs = {k: ParamSpec(d.shape, d.init) for k, d in PDEFS.items()}
    for name in OPTIMIZERS:
        jd = jax.tree.leaves(OPTIMIZERS[name](joptim).state_defs(PDEFS),
                             is_leaf=is_def)
        td = [d for _, d in _spec_leaves(
            OPTIMIZERS[name](optim).state_defs(specs))]
        assert [tuple(d.shape) for d in jd] == [tuple(d.shape) for d in td]
        assert all(str(t.dtype).endswith(str(np.dtype(j.dtype)))
                   for j, t in zip(jd, td))


def test_warmup_cosine_matches_the_reference():
    for args in ((3e-4, 7, 100), (1e-3, 5, 8), (1.0, 0, 50)):
        jlr, tlr = joptim.warmup_cosine(*args), warmup_cosine(*args)
        for s in range(121):
            want = np.asarray(jlr(s))
            got = tlr(torch.tensor(s, dtype=torch.int32)).numpy()
            assert within_ulps(got, want, 4), (args, s)


def test_compression_matches_the_reference():
    rng = np.random.default_rng(5)
    for shape in ((64, 33), (7,), (3, 4, 5)):
        g = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        jq, js = joptim.compress_int8(jnp.asarray(g))
        tq, ts = compress_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            decompress_int8(tq, ts).numpy(),
            np.asarray(joptim.decompress_int8(jq, js)))
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": rng.standard_normal((5,)).astype(np.float32)}
    resid = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in grads.items()}
    jg, je = joptim.ef_compress_grads(jbatch(grads), jbatch(resid))
    tg, te = ef_compress_grads(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in resid.items()})
    for k in grads:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))


def test_int8_allgather_sync_on_one_card():
    """No axis of more than one device: error feedback, then return (the
    reference's no-axes branch, also on a one-device mesh); an axis of
    more devices raises (multi-GPU is ROADMAP queue 1 item 8)."""
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((8, 8)).astype(np.float32)}
    e = {"w": np.zeros((8, 8), np.float32)}
    mesh = jax.make_mesh((1,), ("data",))
    jg, je = joptim.int8_allgather_sync(jbatch(g), mesh, residual=jbatch(e))
    tg, te = int8_allgather_sync({"w": torch.from_numpy(g["w"])},
                                 {"data": 1},
                                 residual={"w": torch.from_numpy(e["w"])})
    np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(je["w"]))
    same, none = int8_allgather_sync({"w": torch.from_numpy(g["w"])})
    assert none is None and torch.equal(same["w"],
                                        torch.from_numpy(g["w"]))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        int8_allgather_sync({"w": torch.from_numpy(g["w"])},
                            {"data": 2, "model": 1})


@pytest.mark.parametrize("seed,step,vocab,chain",
                         [(3, 5, 512, 0), (11, 40_000, 92544, 0),
                          (0, 2, 50304, 4099)])
def test_lm_batch_matches_the_reference(seed, step, vocab, chain):
    """Tokens and labels bitwise, host slices included, at a vocab below
    the chain's 4096, at internlm2's and at a chain vocab past it."""
    jcfg = jdata.DataConfig(vocab_size=vocab, seq_len=48, global_batch=6,
                            seed=seed, chain_vocab=chain)
    tcfg = DataConfig(vocab_size=vocab, seq_len=48, global_batch=6,
                      seed=seed, chain_vocab=chain)
    for host in ((0, 1), (1, 2)):
        want = jdata.lm_batch(jcfg, jnp.asarray(step, jnp.int32), *host)
        got = lm_batch(tcfg, step, *host, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("seed,step", [(0, 3), (5, 1000)])
def test_class_batch_matches_the_reference(seed, step):
    jcfg = jdata.ClassTaskConfig(num_classes=10, dim=32, snr=2.0, seed=seed)
    tcfg = ClassTaskConfig(num_classes=10, dim=32, snr=2.0, seed=seed)
    want = jdata.class_batch(jcfg, jnp.asarray(step), batch=96)
    got = class_batch(tcfg, step, batch=96, device="cpu")
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    assert within_ulps(got["x"].numpy(), np.asarray(want["x"]), 4)


def test_data_pipeline_refusals():
    """A chain vocab past prng.randint's span is refused; the audio and
    vlm families, refused before their bf16 draws were ported, now get
    their frames or patches beside the LM batch."""
    from repro_torch import configs
    with pytest.raises(ValueError, match="2\\^15"):
        lm_batch(DataConfig(vocab_size=50000, seq_len=8, global_batch=1,
                            chain_vocab=40000), 0, device="cpu")
    small = DataConfig(vocab_size=512, seq_len=8, global_batch=2)
    for arch, name in (("whisper-large-v3", "frames"),
                       ("llama-3.2-vision-90b", "patches")):
        cfg = configs.smoke(arch)
        got = batch_for(cfg, small, 0, device="cpu")
        assert set(got) == {"tokens", "labels", name}
        assert got[name].dtype == torch.bfloat16
        assert tuple(got[name].shape) == (2, cfg.encoder_seq, cfg.d_model)
    got = batch_for(configs.smoke("mixtral-8x7b"), small, 0, device="cpu")
    assert torch.equal(got["tokens"], lm_batch(small, 0,
                                               device="cpu")["tokens"])


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_batch_for_features_match_the_reference(arch):
    """``batch_for``'s bf16 frames (audio) and patches (vlm) bitwise the
    reference's at two steps, on both hosts of two (each draws the same
    features), with the tokens and labels."""
    from repro import configs as jconfigs
    from repro_torch import configs
    jcfg = jdata.DataConfig(vocab_size=512, seq_len=8, global_batch=4,
                            seed=3)
    tcfg = DataConfig(vocab_size=512, seq_len=8, global_batch=4, seed=3)
    for step in (0, 17):
        for host in (0, 1):
            want = jdata.batch_for(jconfigs.smoke(arch), jcfg, step, host, 2)
            got = batch_for(configs.smoke(arch), tcfg, step, host, 2,
                            device="cpu")
            assert set(got) == set(want)
            for k, v in want.items():
                w = np.asarray(v)
                if w.dtype == np.int32:
                    np.testing.assert_array_equal(got[k].numpy(), w)
                else:
                    assert got[k].dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        got[k].view(torch.int16).numpy(),
                        w.view(np.int16))


def _ref_state(dtype=jnp.float32, error_feedback=False):
    model = ref_model("internlm2-1.8b")
    opt = joptim.adamw(1e-3)
    return jinit_state(model, opt, jax.random.key(4), dtype=dtype,
                       error_feedback=error_feedback)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    """A TrainState the reference saved (adamw moments, the int32 step)
    restores into the port's TrainState structure leaf for leaf, bitwise,
    bf16 included; ``state_from_reference`` gives the same state."""
    jstate = _ref_state(jnp.float32 if dtype == "f32" else jnp.bfloat16)
    jck.save(str(tmp_path), 0, jstate)
    target = state_from_reference(np_tree(jstate), device="cpu")
    got, _ = ck.restore(str(tmp_path), target=target, device="cpu")
    assert isinstance(got, TrainState) and got.ef_residual is None
    want = jax.tree.leaves(jstate)
    assert len(tree.leaves(got)) == len(want)
    for w, g in zip(want, tree.leaves(got)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    _equal_trees(got, target)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's save of a TrainState with error-feedback buffers: the
    reference's restore into its own TrainState gives the same leaves and
    reads the same manifest paths as its own save would write."""
    jstate = _ref_state(jnp.bfloat16, error_feedback=True)
    state = state_from_reference(np_tree(jstate), device="cpu")
    ck.save(str(tmp_path / "port"), 3, state, extra={"by": "port"})
    got, extra = jck.restore(str(tmp_path / "port"), target=jstate)
    assert extra == {"by": "port"}
    assert isinstance(got, JTrainState)
    for w, g in zip(jax.tree.leaves(jstate), jax.tree.leaves(got)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    jck.save(str(tmp_path / "ref"), 3, jstate, extra={"by": "port"})
    read = [open(os.path.join(tmp_path, who, "step_00000003",
                              "manifest.json")).read()
            for who in ("port", "ref")]
    assert read[0] == read[1]
    shutil.rmtree(tmp_path / "ref")

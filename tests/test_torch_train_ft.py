"""The port's training path (``TransformerLM.forward`` / ``loss``,
``make_train_step``, the fault-tolerant ``Trainer``, the launcher):
the reference's ``tests/test_train_ft.py`` on the port, then the port
held against ``repro`` on the same inputs.

Bars:

* forward logits, loss and every leaf's gradient in f32 on smoke
  internlm2-1.8b and smoke mixtral-8x7b (MoE aux loss included): within
  1e-5 of each tensor's max |value| (summation order only);
* one ``make_train_step`` step with two microbatches, and one with error
  feedback on a one-device mesh: loss, grad norm, params, optimizer state
  and residuals within 1e-5 of each tensor's max |value|;
* a bf16 ``Trainer`` run of 12 steps in both packages from one step-0
  checkpoint the reference wrote: every step's loss within 1% (the
  largest gap measured on the CPU was 2.5e-4 of the loss: bf16
  rounding in two libraries' summation orders);
* exact mode (``CIMConfig(mode="exact")``, the reference's ``cim_mac``
  through its oracle): loss and every gradient within 1e-5 of each
  tensor's max |value|; ``wq`` and ``wk`` get exactly zero, as in the
  reference (the MAC's integer codes carry no gradient, only the
  quantization scales do);
* ternary mode: the reference's ``jax.grad`` raises; the port refuses it
  before any step, in ``make_train_step`` and in the launcher;
* crash/restart replay in the port: bitwise.
"""
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (jbatch, lm_tokens, np_tree,  # noqa: F401
                              one_thread, oracle_cim_mac, port_model,
                              ref_model, tbatch)
from repro import checkpoint as jck
from repro import optim as joptim
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.data import DataConfig as JDataConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train.step import init_state as jinit_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs, optim, tree
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.data import DataConfig
from repro_torch.kernels import backends
from repro_torch.kernels import cim_mac as cm
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train import (FailurePlan, Trainer, TrainerConfig,
                               make_train_step, value_and_grad)

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------ the reference's tests, ported

def _mk(tmp_path, total=12, interval=4, plan=None, step_time_fn=None,
        seed=0):
    cfg = configs.smoke("internlm2-1.8b")
    model = registry.build(cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=seed)
    tc = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                       ckpt_interval=interval, ckpt_keep=3, seed=seed)
    return Trainer(model, adamw(1e-3), data, tc, failure_plan=plan,
                   step_time_fn=step_time_fn, device="cpu")


def _params_equal(a, b):
    la, lb = tree.leaves(a.params), tree.leaves(b.params)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_loss_decreases(tmp_path):
    tr = _mk(tmp_path / "a", total=15)
    tr.run()
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0]


def test_crash_restart_is_bitwise_identical(tmp_path):
    ref = _mk(tmp_path / "ref", total=12).run()

    plan = FailurePlan(crash_at=(6,))
    tr = _mk(tmp_path / "crash", total=12, plan=plan)
    got = tr.run()
    assert tr.restarts == 1
    assert int(got.step) == 12
    assert _params_equal(ref, got)


def test_crash_during_save_recovers(tmp_path):
    ref = _mk(tmp_path / "ref", total=12).run()

    plan = FailurePlan(crash_in_save=(8,))
    tr = _mk(tmp_path / "crash", total=12, plan=plan)
    got = tr.run()
    assert tr.restarts == 1
    assert _params_equal(ref, got)


def test_double_failure(tmp_path):
    ref = _mk(tmp_path / "ref", total=16).run()
    plan = FailurePlan(crash_at=(5, 11), crash_in_save=(12,))
    tr = _mk(tmp_path / "crash", total=16, plan=plan)
    got = tr.run()
    assert tr.restarts == 3
    assert _params_equal(ref, got)
    # the optimizer state and the step replay too
    assert all(torch.equal(x, y) for x, y in zip(
        tree.leaves(ref.opt_state), tree.leaves(got.opt_state)))


def test_straggler_detection(tmp_path):
    # steps 8/9/10 are 10x slower than the 0.01s median
    times = {8: 0.1, 9: 0.12, 10: 0.11}
    tr = _mk(tmp_path, total=14,
             step_time_fn=lambda s: times.get(s, 0.01))
    tr.run()
    assert tr.straggler_events >= 3
    assert tr.mitigations >= 1
    flagged = [h["step"] for h in tr.history if h["straggler"]]
    assert 8 in flagged and 9 in flagged


# --------------------------------------------- parity with the reference

def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _ref_value_and_grad(jm, jparams, batch, cim=None):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, cim=cim)))
    return fn(jparams, jbatch(batch))


def _port_value_and_grad(tm, params, batch, cim=None):
    loss, grads = value_and_grad(tm, params, tbatch(batch), cim)
    return loss, tree.leaves(grads)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x7b"])
def test_forward_loss_and_grads_match_the_reference(arch):
    """f32 smoke models from the reference's params: logits, the MoE aux
    loss, the loss (three labels masked) and every leaf's gradient."""
    jm, tm = ref_model(arch), port_model(arch)
    jparams = jm.init(jax.random.key(1))
    params = params_from_reference(np_tree(jparams), device="cpu")
    batch = lm_tokens(jm.cfg.vocab_size, 2, 24, seed=0)
    jlogits, jaux = jax.jit(lambda p, b: jm.forward(p, b, return_aux=True))(
        jparams, jbatch(batch))
    with torch.no_grad():
        logits, aux = tm.forward(params, tbatch(batch), return_aux=True)
    _close(logits.numpy(), jlogits)
    _close(aux.numpy(), jaux)
    if arch == "mixtral-8x7b":
        assert float(jaux) > 0
    jl, jg = _ref_value_and_grad(jm, jparams, batch)
    loss, grads = _port_value_and_grad(tm, params, batch)
    _close(loss.numpy(), jl)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for want, got in zip(jleaves, grads):
        _close(got.numpy(), want)


def test_remat_full_gives_the_same_loss_and_grads():
    """``remat="full"`` recomputes each layer in the backward pass: the
    same loss and gradients, bitwise; another policy raises."""
    tm = port_model("internlm2-1.8b")
    full = registry.build(dataclasses.replace(tm.cfg, remat="full"))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = lm_tokens(tm.cfg.vocab_size, 2, 16, seed=1)
    la, ga = _port_value_and_grad(tm, params, batch)
    lb, gb = _port_value_and_grad(full, params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    dots = registry.build(dataclasses.replace(tm.cfg, remat="dots"))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        _port_value_and_grad(dots, params, batch)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-large-v3",
                                  "zamba2-7b", "xlstm-125m"])
def test_forward_of_the_other_families_raises(arch):
    model = registry.build(configs.smoke(arch))
    batch = tbatch(lm_tokens(model.cfg.vocab_size, 1, 4, seed=0))
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        model.loss({}, batch)


def _step_pair(microbatches, error_feedback):
    """One step of each package's make_train_step from the reference's
    state on the same batch, with SGD and momentum, unclipped (linear in
    the grads: the first step's momentum is the grads; AdamW's first
    step, g / (|g| + eps), would amplify any difference at grads of eps's
    size)."""
    jm, tm = ref_model("internlm2-1.8b"), port_model("internlm2-1.8b")
    jopt = joptim.sgd(joptim.warmup_cosine(1e-2, 0, 10), momentum=0.9)
    topt = optim.sgd(optim.warmup_cosine(1e-2, 0, 10), momentum=0.9)
    jstate = jinit_state(jm, jopt, jax.random.key(2),
                         error_feedback=error_feedback)
    if error_feedback:
        jstate = jstate._replace(ef_residual=jax.tree.map(
            lambda e: jnp.full(e.shape, 1e-4, e.dtype), jstate.ef_residual))
    state = state_from_reference(np_tree(jstate), device="cpu")
    batch = lm_tokens(jm.cfg.vocab_size, 4, 16, seed=3)
    mesh = jax.make_mesh((1,), ("data",)) if error_feedback else None
    jstep = jax.jit(jmake_train_step(jm, jopt, microbatches=microbatches,
                                     mesh=mesh,
                                     compress_grads=error_feedback))
    jnew, jmet = jstep(jstate, jbatch(batch))
    step = make_train_step(tm, topt, microbatches=microbatches,
                           mesh={"data": 1} if error_feedback else None,
                           compress_grads=error_feedback)
    new, met = step(state, tbatch(batch))
    return jnew, jmet, new, met


def _close_but_flips(got, want, quantum):
    """Within 1e-5 of 127 quanta (the leaf's largest compressed value),
    but for at most 0.1% of the elements (and at least one allowed),
    whose int8 code rounds the other way at a near-tie: one quantum off."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    near = d <= 1e-5 * 127 * quantum
    flip = np.abs(d - quantum) <= 1e-3 * quantum
    assert np.all(near | flip)
    assert flip.sum() <= max(1, 1e-3 * d.size)


@pytest.mark.parametrize("microbatches,error_feedback", [(2, False),
                                                         (1, True)])
def test_train_step_matches_the_reference(microbatches, error_feedback):
    """Two microbatches (f32 accumulation), and error feedback on a
    one-device mesh (the reference's no-axes branch; ``{"data": 1}`` in
    the port): metrics, params and state within 1e-5 of each tensor's
    max; with error feedback the momentum (the compressed grads) and
    the residuals may differ by one quantum where a code rounds the
    other way at a near-tie."""
    jnew, jmet, new, met = _step_pair(microbatches, error_feedback)
    assert int(new.step) == int(jnew.step) == 1
    for k in ("loss", "grad_norm", "lr"):
        _close(met[k].numpy(), jmet[k])
    for want, got in zip(jax.tree.leaves(jnew.params),
                         tree.leaves(new.params)):
        _close(got.numpy(), want)
    assert (new.ef_residual is None) == (not error_feedback)
    pairs = zip(jax.tree.leaves(jnew.opt_state["m"]),
                tree.leaves(new.opt_state["m"]),
                jax.tree.leaves(jnew.ef_residual) if error_feedback
                else [None] * 99,
                tree.leaves(new.ef_residual) if error_feedback
                else [None] * 99)
    for want_m, got_m, want_e, got_e in pairs:
        if not error_feedback:
            _close(got_m.numpy(), want_m)
            continue
        quantum = float(np.abs(np.asarray(want_m)).max()) / 127
        _close_but_flips(got_m.numpy(), want_m, quantum)
        _close_but_flips(got_e.numpy(), want_e, quantum)


def test_trainer_bf16_losses_match_the_reference(tmp_path):
    """Both Trainers, bf16 smoke internlm2-1.8b, AdamW with the
    launcher's schedule, from one step-0 checkpoint the reference wrote
    (a checkpoint in ckpt_dir wins over a fresh init): 12 steps, every
    step's loss within 1%, then each resumes the other's final
    checkpoint."""
    jcfg = ref_model("internlm2-1.8b", "bf16").cfg
    jmodel = ref_model("internlm2-1.8b", "bf16")
    jopt = joptim.adamw(joptim.warmup_cosine(1e-2, 5, 12))
    jck.save(str(tmp_path / "ref"), 0, jinit_state(jmodel, jopt,
                                                   jax.random.key(7)))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jtc = JTrainerConfig(total_steps=12, ckpt_dir=str(tmp_path / "ref"),
                         ckpt_interval=4, seed=1)
    jtr = JTrainer(jmodel, jopt, JDataConfig(vocab_size=jcfg.vocab_size,
                                             seq_len=32, global_batch=4,
                                             seed=1), jtc)
    jtr.run()
    model = port_model("internlm2-1.8b", "bf16")
    tc = TrainerConfig(total_steps=12, ckpt_dir=str(tmp_path / "port"),
                       ckpt_interval=4, seed=1)
    tr = Trainer(model, optim.adamw(optim.warmup_cosine(1e-2, 5, 12)),
                 DataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                            global_batch=4, seed=1), tc, device="cpu")
    state = tr.run()
    want = [h["loss"] for h in jtr.history]
    got = [h["loss"] for h in tr.history]
    assert [h["step"] for h in tr.history] == list(range(12))
    np.testing.assert_allclose(got, want, rtol=0.01)
    assert got[-1] < got[0]
    assert [h["lr"] for h in tr.history] == pytest.approx(
        [h["lr"] for h in jtr.history], rel=1e-6)
    # each package restores the other's final checkpoint
    got_ref, _ = jck.restore(str(tmp_path / "port"),
                             target=jinit_state(jmodel, jopt,
                                                jax.random.key(7)))
    assert int(got_ref.step) == 12
    back = state_from_reference(np_tree(got_ref), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(back), tree.leaves(state)))


def test_ternary_training_is_refused_as_the_reference_fails():
    """The reference's jax.grad through its Pallas ternary_matmul raises;
    the port refuses a ternary config at construction and a packed leaf
    before the step, and the launcher refuses --cim ternary."""
    jm = ref_model("internlm2-1.8b")
    jparams = jm.init(jax.random.key(1))
    batch = lm_tokens(jm.cfg.vocab_size, 1, 8, seed=0)
    with pytest.raises(Exception):
        _ref_value_and_grad(jm, jparams, batch,
                            cim=JCIMConfig(mode="ternary").resolve())
    tm = port_model("internlm2-1.8b")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(tm, adamw(1e-3), cim=CIMConfig(mode="ternary"))
    from repro_torch.core.cim_linear import ternarize_params
    from repro_torch.train import init_state
    state = init_state(tm, adamw(1e-3), torch.Generator().manual_seed(0),
                       "cpu")
    packed = state._replace(params=ternarize_params(
        state.params, CIMConfig(mode="ternary")))
    with pytest.raises(ValueError, match="packed leaves: blocks/w1"):
        make_train_step(tm, adamw(1e-3))(packed, tbatch(batch))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--cim", "ternary"], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no backward" in out.stderr


def test_exact_mode_loss_and_grads_match_the_reference():
    """Exact mode in f32: the reference's cim_mac through its oracle, the
    port's plain torch route."""
    jm, tm = ref_model("internlm2-1.8b"), port_model("internlm2-1.8b")
    jparams = jm.init(jax.random.key(1))
    params = params_from_reference(np_tree(jparams), device="cpu")
    batch = lm_tokens(jm.cfg.vocab_size, 2, 16, seed=0)
    with oracle_cim_mac():
        jl, jg = _ref_value_and_grad(jm, jparams, batch,
                                     cim=JCIMConfig(mode="exact").resolve())
    loss, grads = _port_value_and_grad(
        tm, params, batch, cim=CIMConfig(mode="exact").resolve("cpu"))
    _close(loss.numpy(), jl)
    paths = [p for p, _ in tree.flatten_with_path(params)]
    for path, want, got in zip(paths, jax.tree.leaves(jg), grads):
        _close(got.numpy(), want)
        zero = path[-1] in ("wq", "wk")
        assert (np.abs(np.asarray(want)).max() == 0) == zero, path
        assert (got.abs().max().item() == 0) == zero, path


def test_exact_code_route_backward_twice_matches_the_torch_route():
    """The cuda backend's code route (its wrappers compute the plain
    versions on CPU tensors) takes each weight's codes from CODE_WEIGHTS.
    Two backward passes through one weight (the second finds the cached
    codes), then an in-place update (the codes refill): each weight
    gradient equals the torch route's, which quantizes on every call.
    A scale cached from an earlier graph would fail or lose the weight's
    gradient."""
    plan = type("Plan", (), dict(num_trits=5, adc_bits=5))
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((48, 40), generator=gen).requires_grad_()
    x = torch.randn((6, 48), generator=gen)
    backends.CODE_WEIGHTS.clear()
    fills = backends.CODE_WEIGHTS.fills
    for step in range(3):
        xs = x.clone().requires_grad_()
        (gw, gx), = [torch.autograd.grad(
            backends._run_cim_codes(plan, xs, w).square().sum(), (w, xs))]
        xt = x.clone().requires_grad_()
        want = torch.autograd.grad(
            backends._run_cim(plan, xt, w, cm.cim_mac_torch).square().sum(),
            (w, xt))
        assert gw.abs().max() > 0
        torch.testing.assert_close(gw, want[0], rtol=1e-6, atol=0)
        torch.testing.assert_close(gx, want[1], rtol=1e-6, atol=0)
        if step == 1:
            with torch.no_grad():
                w.mul_(0.5)
    assert backends.CODE_WEIGHTS.fills - fills == 2
    assert cm.LAUNCHES["cim_mac"] == 0


def test_launcher_trains_on_the_cpu(tmp_path):
    """The launcher's smoke run: the reference's JSON keys, 6 steps, a
    resumable final checkpoint."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path), "--optimizer", "adafactor"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == {"steps", "first_loss", "last_loss", "wall_s",
                        "tokens_per_s", "restarts"}
    assert rec["steps"] == 6 and rec["restarts"] == 0
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])
    assert (tmp_path / "step_00000006" / "manifest.json").exists()

"""The training forward of the four families that were serve-only in the
port: whisper-large-v3 (``EncDecModel``), llama-3.2-vision-90b (the
cross-attending ``TransformerLM``), zamba2-7b (``ZambaModel``) and
xlstm-125m (``XLSTMModel``), held against ``repro`` on the same params
(carried across by ``convert``) and the same seeded batch, smoke size.

Bars:

* f32, from the reference's params (the VLM's gates seeded nonzero in
  both, else its cross blocks add nothing): logits and the loss (three
  labels masked) within 1e-5 of each tensor's max |value|; every leaf's
  gradient within ``GRAD_TOL`` of its max.  That is 1e-5 for whisper
  and the VLM; 3e-5 for xlstm (1.4e-5 measured, mLSTM ``wk``) and 1e-4
  for zamba2 (5.7e-5 measured at 64 positions): in those two the
  reference's own f32 gradients lie 5.8e-5 and 1.1e-4 of the max from
  a float64 run of the same function, the port's 4.4e-5 and 1.6e-4
  (held: at most twice the reference's), so f32 summation order alone
  moves them that far.  zamba2 runs 64 positions (one chunk, where the
  reference's gradients are finite), the others 24;
* ``remat="full"`` against ``"none"`` bitwise, for the VLM (the cross
  block after each group) and zamba2 (the weight-tied shared block);
* zamba2 at 256 positions: logits within 5e-5 of the reference's max
  (2.0e-5 measured; the reference's f32 logits lie 2.3e-5 from the
  float64 run, the port's 1.9e-5), the loss within 1e-5; the
  port's gradients finite, the reference's not but for ``final_norm``
  and ``unembed``, past the last Mamba2 layer (pinned: its
  ``_ssd_chunked`` takes ``exp`` of the unmasked ``gap``, which
  overflows off the triangle, and ``where``'s gradient there is 0 x inf);
* one step of ``make_train_step`` with two microbatches (the frames or
  patches split with the tokens) against the reference's: metrics and
  params within 1e-5 of each tensor's max;
* a bf16 ``Trainer`` run of whisper in both packages from one step-0
  checkpoint the reference wrote: every step's loss within 1%;
* ``torch.maximum`` and ``amax`` split the gradient at a tie as
  ``jnp.maximum`` and ``jnp.max`` do (the sLSTM and mLSTM stabilisers);
* the launcher trains each family's smoke config on the CPU.
"""
import contextlib
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import (jbatch, lm_tokens, np_tree,  # noqa: F401
                              one_thread, port_model, ref_model, tbatch)
from repro import checkpoint as jck
from repro import optim as joptim
from repro.data import DataConfig as JDataConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train.step import init_state as jinit_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import optim, tree
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import registry
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train import value_and_grad

ARCHS = ("xlstm-125m", "whisper-large-v3", "llama-3.2-vision-90b",
         "zamba2-7b")
SEQ = {"zamba2-7b": 64}
GRAD_TOL = {"xlstm-125m": 3e-5, "zamba2-7b": 1e-4}
EXTRA = {"audio": "frames", "vlm": "patches"}


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _batch(cfg, rows: int, seq: int, seed: int = 0) -> dict:
    """Seeded tokens (three labels masked) and, for audio and vlm, f32
    frames or patches (rows, encoder_seq, d_model)."""
    batch = lm_tokens(cfg.vocab_size, rows, seq, seed=seed)
    if cfg.family in EXTRA:
        rng = np.random.default_rng(seed + 100)
        batch[EXTRA[cfg.family]] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _ref_params(jm, seed: int = 1):
    """The reference's init; a VLM's f32 gates (zeros at init, which
    would make every cross block add nothing) seeded nonzero."""
    jparams = jm.init(jax.random.key(seed))
    if jm.cfg.family == "vlm":
        g = jparams["cross_blocks"]["gate"]
        jparams["cross_blocks"]["gate"] = jnp.linspace(
            0.3, 0.9, g.shape[0], dtype=jnp.float32)
    return jparams


@functools.lru_cache(maxsize=None)
def _reference(arch: str, seq: int):
    """The reference's side, once per (arch, positions): params, batch,
    logits, loss and gradient leaves (numpy)."""
    jm = ref_model(arch)
    jparams = _ref_params(jm)
    batch = _batch(jm.cfg, 2 if seq < 256 else 1, seq)
    # one compile for the logits, the loss and the gradients
    jlogits, (jloss, jgrads) = jax.jit(lambda p, b: (
        jm.forward(p, b), jax.value_and_grad(jm.loss)(p, b)))(
            jparams, jbatch(batch))
    return dict(params=np_tree(jparams), batch=batch,
                logits=np.asarray(jlogits), loss=np.asarray(jloss),
                grads=[np.asarray(g) for g in jax.tree.leaves(jgrads)])


def _grad_at(params, grads, *path):
    """The gradient leaf at ``path`` of a flattened gradient list."""
    paths = ["/".join(p) for p, _ in tree.flatten_with_path(params)]
    return grads[paths.index("/".join(path))]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_the_reference(arch):
    ref = _reference(arch, SEQ.get(arch, 24))
    tm = port_model(arch)
    params = params_from_reference(ref["params"], device="cpu")
    batch = tbatch(ref["batch"])
    with torch.no_grad():
        logits, aux = tm.forward(params, batch, return_aux=True)
    _close(logits.numpy(), ref["logits"])
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    loss, grads = value_and_grad(tm, params, batch)
    _close(loss.numpy(), ref["loss"])
    grads = tree.leaves(grads)
    assert len(grads) == len(ref["grads"])
    for got, want in zip(grads, ref["grads"]):
        _close(got.numpy(), want, GRAD_TOL.get(arch, 1e-5))
    if arch == "llama-3.2-vision-90b":
        # the cross blocks carry gradient (their gates are nonzero)
        assert float(_grad_at(params, grads, "cross_blocks",
                              "wk").abs().max()) > 0


@contextlib.contextmanager
def _float64_port():
    """A float64 model of the port kept float64 throughout: its f32
    upcasts (``.float()``) and f32 buffers widened while inside."""
    mp = pytest.MonkeyPatch()
    upcast = torch.Tensor.float
    mp.setattr(torch.Tensor, "float", lambda x, *a, **k: x if x.dtype
               == torch.float64 else upcast(x, *a, **k))
    for name in ("zeros", "ones", "full"):
        def wide(*a, _make=getattr(torch, name), **k):
            if k.get("dtype") is torch.float32:
                k["dtype"] = torch.float64
            return _make(*a, **k)
        mp.setattr(torch, name, wide)
    try:
        yield
    finally:
        mp.undo()


def _float64_run(tm, params, batch):
    """The port's logits, loss and gradient leaves in float64."""
    model = registry.build(dataclasses.replace(tm.cfg, dtype=torch.float64))
    wide = tree.map_leaves(lambda x: x.double() if x.is_floating_point()
                           else x, params)
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    with _float64_port():
        with torch.no_grad():
            logits = model.forward(wide, batch)
        loss, grads = value_and_grad(model, wide, batch)
    return logits.numpy(), float(loss), [g.numpy() for g in
                                         tree.leaves(grads)]


def _gap(got, truth) -> float:
    """|got - truth| over the leaves, each of its truth's max |value|."""
    return max(float(np.abs(np.asarray(a, np.float64) - b).max()
                     / max(np.abs(b).max(), 1e-300))
               for a, b in zip(got, truth))


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_f32_error_is_the_reference_s(arch):
    """Where ``GRAD_TOL`` passes 1e-5 (and for zamba2's logits at 256
    positions, held to 5e-5): both packages' f32 results against the
    port's float64 run of the same params and batch.  The reference's
    own f32 gradients lie 5.8e-5 (xlstm) and 1.1e-4 (zamba2) from it,
    so no f32 summation order comes within 1e-5 of another's; the
    port's lie no farther than twice the reference's."""
    for seq in (SEQ.get(arch, 24),) + ((256,) if arch == "zamba2-7b"
                                       else ()):
        ref = _reference(arch, seq)
        tm = port_model(arch)
        params = params_from_reference(ref["params"], device="cpu")
        batch = tbatch(ref["batch"])
        logits, loss, grads = _float64_run(tm, params, batch)
        with torch.no_grad():
            port_logits = tm.forward(params, batch).numpy()
        e_ref, e_port = (_gap([x], [logits]) for x in (ref["logits"],
                                                       port_logits))
        print(f"{arch} at {seq}: logits {e_ref:.3g} (reference), "
              f"{e_port:.3g} (port) from float64")
        assert e_port <= 2 * e_ref + 1e-6
        if seq == 256:
            continue                      # the reference's grads are NaN
        port = [g.numpy() for g in tree.leaves(
            value_and_grad(tm, params, batch)[1])]
        e_ref, e_port = _gap(ref["grads"], grads), _gap(port, grads)
        print(f"{arch} at {seq}: grads {e_ref:.3g} (reference), "
              f"{e_port:.3g} (port) from float64")
        assert e_ref <= 2e-4 and e_port <= 2 * e_ref


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-7b"])
def test_remat_full_gives_the_same_loss_and_grads(arch):
    """Each self layer (VLM) or Mamba2 layer (zamba2) recomputed in the
    backward pass, the cross blocks and the shared block not: the same
    loss and gradients, bitwise."""
    tm = port_model(arch)
    full = registry.build(dataclasses.replace(tm.cfg, remat="full"))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    if "cross_blocks" in params:
        params["cross_blocks"]["gate"].fill_(0.5)
    batch = tbatch(_batch(tm.cfg, 2, 16, seed=1))
    la, ga = value_and_grad(tm, params, batch)
    lb, gb = value_and_grad(full, params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(ga),
                                                  tree.leaves(gb)))


def test_zamba2_gradients_stay_finite_past_the_reference_overflow():
    """At 256 positions (one full SSD chunk) ``gap`` passes 88 off the
    triangle: the reference's gradients are all non-finite (pinned),
    the port's masked ``exp`` keeps its own finite, and the forward is
    the reference's."""
    ref = _reference("zamba2-7b", 256)
    assert np.isfinite(ref["loss"])
    tm = port_model("zamba2-7b")
    params = params_from_reference(ref["params"], device="cpu")
    # every leaf whose gradient passes back through a Mamba2 layer
    finite = {"/".join(p): bool(np.isfinite(g).all()) for (p, _), g in zip(
        tree.flatten_with_path(params), ref["grads"])}
    assert {k for k, ok in finite.items() if ok} == {"final_norm",
                                                     "unembed"}
    batch = tbatch(ref["batch"])
    with torch.no_grad():
        _close(tm.forward(params, batch).numpy(), ref["logits"], 5e-5)
    loss, grads = value_and_grad(tm, params, batch)
    _close(loss.numpy(), ref["loss"])
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_train_step_with_microbatches_matches_the_reference(arch):
    """Two microbatches split the frames or patches with the tokens:
    one SGD-with-momentum step of each package from the reference's
    state, metrics and params within 1e-5 of each tensor's max."""
    jm, tm = ref_model(arch), port_model(arch)
    jopt = joptim.sgd(joptim.warmup_cosine(1e-2, 0, 10), momentum=0.9)
    topt = optim.sgd(optim.warmup_cosine(1e-2, 0, 10), momentum=0.9)
    jstate = jinit_state(jm, jopt, jax.random.key(2))
    if arch == "llama-3.2-vision-90b":
        jstate = jstate._replace(params=_ref_params(jm, 2))
    state = state_from_reference(np_tree(jstate), device="cpu")
    batch = _batch(jm.cfg, 4, 16, seed=3)
    jnew, jmet = jax.jit(jmake_train_step(jm, jopt, microbatches=2))(
        jstate, jbatch(batch))
    new, met = make_train_step(tm, topt, microbatches=2)(state,
                                                         tbatch(batch))
    for k in ("loss", "grad_norm", "lr"):
        _close(met[k].numpy(), jmet[k])
    for want, got in zip(jax.tree.leaves(jnew.params),
                         tree.leaves(new.params)):
        _close(got.numpy(), want)


def test_trainer_bf16_losses_match_the_reference(tmp_path):
    """Both Trainers on bf16 smoke whisper, AdamW with the launcher's
    schedule, from one step-0 checkpoint the reference wrote, on each
    package's ``batch_for`` (its frames bitwise the reference's): 8
    steps, every step's loss within 1%, the loss falling."""
    steps = 8
    jm = ref_model("whisper-large-v3", "bf16")
    jopt = joptim.adamw(joptim.warmup_cosine(1e-2, 5, steps))
    jck.save(str(tmp_path / "ref"), 0, jinit_state(jm, jopt,
                                                   jax.random.key(7)))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    data = dict(vocab_size=jm.cfg.vocab_size, seq_len=16, global_batch=2,
                seed=1)
    jtr = JTrainer(jm, jopt, JDataConfig(**data), JTrainerConfig(
        total_steps=steps, ckpt_dir=str(tmp_path / "ref"),
        ckpt_interval=4, seed=1))
    jtr.run()
    tr = Trainer(port_model("whisper-large-v3", "bf16"),
                 optim.adamw(optim.warmup_cosine(1e-2, 5, steps)),
                 DataConfig(**data), TrainerConfig(
                     total_steps=steps, ckpt_dir=str(tmp_path / "port"),
                     ckpt_interval=4, seed=1), device="cpu")
    tr.run()
    want = [h["loss"] for h in jtr.history]
    got = [h["loss"] for h in tr.history]
    assert [h["step"] for h in tr.history] == list(range(steps))
    np.testing.assert_allclose(got, want, rtol=0.01)
    assert got[-1] < got[0]


def test_ties_split_the_gradient_as_jax():
    """The stabilisers' maxima: at a tie ``torch.maximum`` gives each
    side half the gradient and ``amax`` shares it among the tied
    elements, as ``jnp.maximum`` and ``jnp.max`` do."""
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = np.array([1.0, 5.0, 3.0], np.float32)
    ja, jb_ = jax.grad(lambda x, y: jnp.sum(jnp.maximum(x, y) * jnp.arange(
        1.0, 4.0)), argnums=(0, 1))(a, b)
    ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    (torch.maximum(ta, tb) * torch.arange(1.0, 4.0)).sum().backward()
    assert np.array_equal(ta.grad.numpy(), ja)
    assert np.array_equal(tb.grad.numpy(), jb_)
    floor = np.float32(1e-6)
    jn = jax.grad(lambda n: jnp.sum(1.0 / jnp.maximum(n, 1e-6)))(
        np.array([floor, 2.0], np.float32))
    tn = torch.tensor([floor, 2.0], requires_grad=True)
    (1.0 / torch.maximum(tn, torch.full((), 1e-6))).sum().backward()
    assert np.array_equal(tn.grad.numpy(), jn)
    x = np.array([[1.0, 4.0, 4.0, 2.0]], np.float32)
    jx = jax.grad(lambda v: jnp.sum(jnp.max(v, axis=1) * 3.0))(x)
    tx = torch.tensor(x, requires_grad=True)
    (tx.amax(dim=1) * 3.0).sum().backward()
    assert np.array_equal(tx.grad.numpy(), jx)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_each_family(arch, tmp_path):
    """``repro_torch.launch.train --smoke --device cpu --arch A``: the
    reference's JSON keys, finite losses, no refusal."""
    out = launch_train.main([
        "--smoke", "--device", "cpu", "--arch", arch, "--steps", "3",
        "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
        "--optimizer", "adafactor"])
    assert out["steps"] == 3 and out["restarts"] == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])

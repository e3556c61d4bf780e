"""The port's training on a live mesh for every family: one
``torch.multiprocessing`` spawn of four gloo ranks on a ``file://`` store
(``tests/_torch_mesh_train_worker.py``) runs every case on ``(2, 2)``
and ``(4, 1)`` meshes of ``("data", "model")``, smoke size in f32, held
against the unmeshed port (rank 0), and two of them against the
reference's unsharded step, which the main process takes while the
ranks run:

  * Adafactor on smoke internlm2-1.8b with ``optimizers.PIECE`` cut so
    that the stacked leaves take the sliced clip: its factored moments
    are means over the leaf's last two dims, which both meshes split;
  * exact mode (remat 'full') on a batch whose first exact call's input
    amax ties across two ranks; an exact config naming the int8 domain
    trains as plain exact mode; ``dist.runtime.max_rows`` alone on a
    three-way tie over ranks 0 and 2, whose gathered gradient is
    ``jax.grad`` of the ranks' summed losses on the whole call;
  * smoke mixtral-8x7b and kimi-k2 (remat 'full', a capacity factor
    that drops assignments): the step's 128 tokens are one routing group
    spanning every rank; routes, drops and aux equal the unmeshed run's,
    and so in two microbatches, each rank holding its block of each;
  * zamba2-7b, xlstm-125m, whisper-large-v3 (frames) and the VLM
    (patches, its gates seeded nonzero, Adafactor), one step on (2, 2);
    the MoE and these cases step with SGD and momentum, whose update is
    linear in the gradient (AdamW's first steps would amplify a
    summation-order difference in a gradient that cancels to near eps);
  * an Adafactor ``Trainer`` that crashes and replays on (2, 2), then
    resumes on (4, 1), against 8 straight steps;
  * one step from the reference's state on (2, 2) (Adafactor on
    internlm2-1.8b, SGD with momentum on mixtral-8x7b) against the
    reference's jitted unsharded step.

The bars: losses within 1e-6 relative, each param and moment leaf within
1e-5 of its max |value|, the aux and routes exact; against the reference
1e-5 of each tensor's max.  About 30 s on one core a rank.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_threads import one_thread  # noqa: F401
import _torch_mesh_train_worker as worker

jax.config.update("jax_platform_name", "cpu")

LOSS_REL, LEAF_REL = 1e-6, 1e-5


def _reference_cases() -> dict:
    """The reference's initial states and seeded batches of the two cases
    the ranks step from (carried across by ``convert``), and the jitted
    step of each (run while the ranks work)."""
    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.models import registry as jregistry
    from repro.train.step import init_state as jinit_state
    from repro.train.step import make_train_step as jmake_train_step
    from repro_torch.convert import state_from_reference
    from _torch_train_ref import lm_tokens, np_tree, tbatch
    cases, steps = {}, {}
    for name, arch, opt, key in (
            ("adafactor", "internlm2-1.8b",
             joptim.adafactor(joptim.warmup_cosine(1e-1, 2, 10)), 2),
            ("moe", "mixtral-8x7b",
             joptim.sgd(joptim.warmup_cosine(1e-2, 0, 10), momentum=0.9),
             4)):
        jm = jregistry.build(dataclasses.replace(jconfigs.smoke(arch),
                                                 dtype=jnp.float32))
        jstate = jinit_state(jm, opt, jax.random.key(key))
        batch = lm_tokens(jm.cfg.vocab_size, worker.ROWS, worker.SEQ,
                          seed=key)
        cases[name] = dict(state=state_from_reference(np_tree(jstate),
                                                      device="cpu"),
                           batch=tbatch(batch))
        steps[name] = (jax.jit(jmake_train_step(jm, opt)), jstate,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return cases, steps


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    cases, steps = _reference_cases()
    torch.save(cases, tmp / "inputs.pt")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ranks = mp.spawn(worker.main,
                         args=("file://" + str(tmp / "store"), str(tmp)),
                         nprocs=worker.WORLD, join=False)
        try:
            reference = {}
            for name, (step, jstate, jb) in steps.items():
                new, met = step(jstate, jb)
                reference[name] = dict(
                    params=jax.tree.leaves(new.params),
                    opt_state=jax.tree.leaves(new.opt_state),
                    metrics={k: float(v) for k, v in met.items()})
        finally:
            while not ranks.join():
                pass
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    out = torch.load(tmp / "results.pt", weights_only=False)
    out["jax"] = reference
    return out


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _held(run: dict) -> None:
    """A meshed run against the unmeshed one, to the file's bars."""
    for got, want in zip(run["losses"], run["ref_losses"]):
        assert _rel(got, want) <= LOSS_REL, (run["losses"],
                                             run["ref_losses"])
    assert run["param_err"] <= LEAF_REL
    assert run["opt_err"] <= LEAF_REL
    assert sum(run["comm"].values()) > 0


def _meshed(res: dict, tag: str) -> dict:
    return dict(res[tag], ref_losses=res["plain"]["losses"])


@pytest.mark.parametrize("tag", ["22", "41"])
def test_adafactor_with_sliced_leaves_matches_unmeshed(results, tag):
    r = results["adafactor"]
    # every stacked block leaf took the sliced clip
    assert {"wq", "wk", "wv", "wo", "w1", "w2", "w3"} <= set(r["sliced"])
    _held(_meshed(r, tag))
    # the factored moments of wq lie as wq does: its rows over data,
    # its columns over model
    assert r["placed"] == {"r": ["S(1)", "R"], "c": ["R", "S(1)"]}
    assert any("all_reduce" in k or "allreduce" in k for k in r[tag]["comm"])


@pytest.mark.parametrize("tag", ["22", "41"])
def test_exact_mode_with_a_cross_rank_tie_matches_unmeshed(results, tag):
    r = results["exact"]
    # the first exact call's amax ties between rows of two ranks
    assert r["tie_rows"] == [row for row, _ in worker.TIE_AT]
    _held(_meshed(r, tag))


def test_exact_config_naming_int8_trains_as_exact(results):
    r = results["exact"]
    assert r["int8_losses"] == r["22"]["losses"]


def test_max_rows_gradient_is_the_reference_tie_split(results):
    r = results["max_rows"]
    x = worker.MAX_X
    weight = sum(range(1, r["count"] + 1))
    want = np.asarray(jax.grad(
        lambda v: jnp.max(jnp.abs(v)) * float(weight))(x))
    # |5| three times, over ranks 0 and 2: a third of the summed weight
    assert np.count_nonzero(want) == 3
    assert r["max"] == 5.0
    np.testing.assert_array_equal(r["grad"], want)


@pytest.mark.parametrize("arch,tag", [
    ("mixtral-8x7b", "22"), ("mixtral-8x7b", "41"),
    ("kimi-k2-1t-a32b", "22"), ("kimi-k2-1t-a32b", "41"),
    ("microbatches", "22")])
def test_moe_routes_drops_and_aux_match_unmeshed(results, arch, tag):
    r = results["moe"][arch]
    _held(_meshed(r, tag))
    plain, meshed = r["plain"]["log"], r[tag]["log"]
    # forward and remat re-forward, each layer: the same calls
    assert len(meshed["route"]) == len(plain["route"]) > 0
    tokens = worker.ROWS * worker.SEQ // (2 if arch == "microbatches"
                                         else 1)
    drops = []
    for (d0, o0), (d1, o1) in zip(plain["route"], meshed["route"]):
        # one group of the whole call's tokens (of a microbatch's)
        assert d1.shape[:2] == (1, tokens)
        assert torch.equal(o0, o1) and torch.equal(d0, d1)
        drops.append(int(o0.sum() - d0.sum()))
    assert meshed["aux"] == plain["aux"]
    assert any(n > 0 for n in drops), drops
    # the logits' all-gather and the slots' sum ran, forward and back
    comm = r[tag]["comm"]
    assert any("all_gather" in k or "allgather" in k for k in comm)


@pytest.mark.parametrize("arch", worker.FAMILIES)
def test_family_trains_on_a_mesh_as_unmeshed(results, arch):
    _held(_meshed(results["families"][arch], "22"))


def test_adafactor_trainer_restores_across_meshes(results):
    r = results["trainer"]
    assert r["restarts"] == 1
    assert r["steps"] == list(range(8))
    for got, want in zip(r["losses"], r["ref_losses"]):
        assert _rel(got, want) <= LOSS_REL
    assert r["param_err"] <= LEAF_REL and r["opt_err"] <= LEAF_REL
    # the moments resumed on (4, 1): wq's rows over data = 4
    assert r["resumed_placements"] == {"r": ["S(1)", "R"],
                                       "c": ["R", "S(1)"]}


def _close(got, want, rel=LEAF_REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["adafactor", "moe"])
def test_meshed_step_matches_the_reference(results, name):
    from repro_torch import tree
    got, want = results["reference"][name], results["jax"][name]
    for k in ("loss", "grad_norm", "lr"):
        _close(got["metrics"][k], want["metrics"][k])
    for a, b in zip(tree.leaves(got["params"]), want["params"]):
        _close(a.numpy(), b)
    for a, b in zip(tree.leaves(got["opt_state"]), want["opt_state"]):
        _close(a.numpy(), b)

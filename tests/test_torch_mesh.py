"""The port's sharding layer on a live mesh: one ``torch.multiprocessing``
spawn of four gloo ranks on a ``file://`` store
(``tests/_torch_mesh_worker.py``) runs every case, on smoke
internlm2-1.8b in f32, and each case here asserts on its results:

  * a train step on ``(2, 2)`` ``("data", "model")`` against the
    unsharded port: loss within 1e-6 relative, every param (and the
    optimizer state) within 1e-5 of its leaf's max |value|, 2 AdamW
    steps;
  * a step with ``compress_grads`` runs the int8 sync over data;
  * ``int8_allgather_sync`` over ``data = 2`` equals the reference's
    formula (``repro.optim.compression.compress_int8``, then
    ``sum(q * s) / n``) on the gathered shards;
  * the elastic run: 4 steps on ``(2, 2)``, a checkpoint, a restore onto
    ``(4, 1)`` and 4 more, against 8 steps on ``(2, 2)``, to the same
    bar (the reference's own, in bf16, is ``max_diff < 5e-2``);
  * the bucket ``ServeEngine`` with base3 and trit2 weights (float
    domain) on ``(2, 2)``: the unmeshed engine's greedy tokens, one host
    transfer per bucket, prefill and decode logits within 1e-5 of their
    max |value|;
  * what does not run on a mesh yet raises, naming the ROADMAP item:
    device fidelity and the legacy step loop in serving, the recurrent
    and cross families' serving, and training under ``remat="dots"``
    (the int8 domain, exact mode and MoE serve on a mesh:
    ``tests/test_torch_mesh_serve.py``; every family, Adafactor and
    exact mode train on one: ``tests/test_torch_mesh_train.py``).

Every case ran at least one collective (``CommDebugMode``).  The
unmeshed port is held against ``repro`` by ``tests/test_torch_serve.py``
and ``tests/test_torch_train.py``.
"""
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from _torch_threads import one_thread  # noqa: F401
import _torch_mesh_worker as worker


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mp.spawn(worker.main,
                 args=("file://" + str(tmp / "store"), str(tmp)),
                 nprocs=worker.WORLD, join=True)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    return torch.load(tmp / "results.pt", weights_only=False)


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def test_sharded_train_step_matches_unsharded(results):
    r = results["train"]
    assert r["collectives"] > 0
    # FSDP over data on the embed dim, heads over model
    assert r["placed"] == ["S(1)", "S(2)"]
    for got, want in zip(r["losses"], r["ref_losses"]):
        assert _rel(got, want) <= 1e-6
    assert r["param_err"] <= 1e-5
    assert r["opt_err"] <= 1e-5


def test_meshed_step_with_int8_sync(results):
    """``compress_grads`` on (2, 2): the int8 all-gather over data runs,
    the loss is the uncompressed step's (taken before the sync), and
    AdamW's first update moves no weight by more than lr either way."""
    r = results["compress"]
    assert r["collectives"] > 0
    assert r["loss"] == r["plain_loss"]
    assert r["max_gap"] <= 2 * r["lr"] * (1 + 1e-5)


def test_int8_allgather_sync_matches_reference_formula(results):
    import jax.numpy as jnp
    from repro.optim.compression import compress_int8
    r = results["int8"]
    assert r["collectives"] > 0
    coords = r["coords"]
    # the data axis's shards, in its order (model ranks hold copies)
    shards = [r["raw"][coords.index([d, 0])] for d in range(2)]
    for key in ("a", "b"):
        qs = [compress_int8(jnp.asarray(s[key])) for s in shards]
        want = np.asarray(
            (sum(q.astype(jnp.float32) * s for q, s in qs) / len(qs)
             ).astype(jnp.float32))
        for got in r["synced"]:
            np.testing.assert_array_equal(got[key], want)


def test_elastic_restore_across_meshes(results):
    r = results["elastic"]
    assert r["collectives"] > 0
    # the resumed run's leaves are placed on (4, 1)
    assert r["resumed_placements"] == ["S(1)", "S(2)"]
    assert len(r["losses"]) == len(r["ref_losses"]) == 8
    for got, want in zip(r["losses"], r["ref_losses"]):
        assert _rel(got, want) <= 1e-6
    assert r["param_err"] <= 1e-5


@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_meshed_bucket_engine_matches_unmeshed(results, packing):
    r = results["serve"][packing]
    plain, meshed = r[False], r[True]
    assert meshed["collectives"] > 0 and plain["collectives"] == 0
    assert meshed["tokens"] == plain["tokens"]
    assert meshed["host_transfers"] == plain["host_transfers"] == 1
    assert meshed["steps_run"] == plain["steps_run"]
    assert r["logit_err"] <= 1e-5
    # the packed matmuls ran tensor-parallel on their local shards
    assert "ShardedPacked" in r["view_kinds"]


@pytest.mark.parametrize("what", ["fidelity", "legacy", "serve zamba2-7b",
                                  "serve whisper-large-v3", "remat dots"])
def test_unported_mesh_paths_raise(results, what):
    msg = results["refusals"][what]
    assert msg is not None
    assert "ROADMAP queue 1 item 8" in msg


@pytest.mark.parametrize("packing,k,n,split", [
    ("base3", 64, 96, "col"), ("base3", 96, 64, "row"),
    ("trit2", 64, 96, "col"), ("trit2", 96, 64, "row"),
    # trit2's 24 rows cover 96 positions: the last shard's input is
    # zero-padded past K = 94
    ("trit2", 94, 64, "row")])
def test_tensor_parallel_shards_join_to_the_whole_product(packing, k, n,
                                                          split):
    """The local products of two model-axis shards (``ShardedPacked.
    partial`` through ``cim_linear.linear``), joined as the collective
    joins them, give the unsharded product (the plain path here; the
    same check runs the kernel on the card, ``tests/test_torch_cuda.py``)."""
    from repro_torch.core.cim_linear import CIMConfig, linear
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    w = ops.pack_weights(torch.as_tensor(rng.standard_normal((k, n)),
                                         dtype=torch.float32), packing)
    x = torch.as_tensor(rng.standard_normal((3, k)), dtype=torch.float32)
    cim = CIMConfig(mode="ternary", packing=packing)
    want = linear(x, w, cim)
    got = worker.tp_linear(x, w, split, 2, cim)
    assert got.shape == want.shape == (3, n)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

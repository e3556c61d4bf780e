"""The port's serving paths on a live mesh: one ``torch.multiprocessing``
spawn of four gloo ranks on a ``file://`` store
(``tests/_torch_mesh_serve_worker.py``) runs every case on ``(2, 2)``
and ``(4, 1)`` meshes of ``("data", "model")``, with the unmeshed port
beside it on rank 0.  The weights are the reference's, drawn by ``repro``
and carried across by ``repro_torch.convert``; the requests are seeded
with numpy and arrive on a bursty trace under a clock that moves only
when the pump sleeps.

  * ``Scheduler`` and ``PagedScheduler`` (the gather read), smoke
    internlm2-1.8b base3 in f32: greedy tokens equal to the unmeshed
    port's and to the reference's unsharded schedulers on the same
    trace; ``host_transfers == chunks_run`` on every rank; the counts
    equal; every decode call's logits within 1e-5 of their max |value|
    (the float domain's row-parallel sums add in another order); a
    trace whose requests on different DP ranks share a prompt prefix
    (the stripes share within themselves only); a pool of 6 slots on
    ``(4, 1)``, which replicates;
  * the int8 domain, base3 and trit2: the bucket engine's prefill and
    decode logits and the ``Scheduler``'s decode logits bitwise to the
    unmeshed port, with column- and row-split layers;
  * exact mode on float weights through the code route's weight cache
    (``CODE_WEIGHTS``, the card's cim runner on the CPU's plain MAC):
    the bucket's logits bitwise, no cache fill after warm-up;
  * smoke mixtral-8x7b base3: the bucket engine and the ``Scheduler``
    with experts over ``model`` (the serve rules, int8 domain, (2, 2)),
    over ``data`` (``ep-data``, int8, (4, 1): logits bitwise; float,
    (2, 2): the experts' row split over ``model`` adds in another order,
    1e-5); the ``ep-data`` runs move tokens by ``all_to_all``.

Each rank holds at least two rows in the bitwise cases: on one row the
CPU's BLAS takes the matrix-vector kernel, whose sums over K run in
another order than the matrix kernel's (the router's logits in the MoE
block are such a product).  Every meshed run ran collectives
(``CommDebugMode``).  About 40 s on one core a rank.
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
import _torch_mesh_serve_worker as worker

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-5


def _specs(seed: int, n: int, lens, budgets) -> list:
    """(uid, prompt, max_new, arrival_s) of a bursty trace: two bursts
    of simultaneous arrivals, more requests in each than slots, so the
    pool fills and slots free and refill in mid-burst (the test clock
    stands still while the pool is busy)."""
    from repro_torch.serve import trace
    rng = np.random.default_rng(seed)
    arrivals = trace.bursty_arrivals(n, bursts=2, gap_s=0.25, spread_s=0.0,
                                     seed=seed)
    return [(i, rng.integers(0, 512, size=lens[i % len(lens)]).astype(
        np.int32).tolist(), budgets[i % len(budgets)], arrivals[i])
        for i in range(n)]


def _prefix_specs() -> list:
    """Four requests at once: slots 0-1 are the first data rank's, 2-3
    the second's.  Request 1 repeats request 0's prompt (one stripe);
    request 2 starts with its first two pages (the other stripe)."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 512, size=12).astype(np.int32)
    other = rng.integers(0, 512, size=7).astype(np.int32)
    prompts = [base, base.copy(), np.concatenate([base[:8], other[:3]]),
               other]
    return [(i, p.tolist(), 4, 0.0) for i, p in enumerate(prompts)]


def _reference_params() -> tuple:
    """The reference's params (numpy trees by name) and its base3
    internlm2 model and params."""
    from repro import configs as jconfigs
    from repro.core.cim_linear import CIMConfig as JCIMConfig
    from repro.core.cim_linear import ternarize_params as jternarize
    from repro.models import registry as jregistry
    out = {}
    for arch, key in (("internlm2-1.8b", 3), ("mixtral-8x7b", 5)):
        jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=jnp.float32)
        jm = jregistry.build(jcfg)
        raw = jax.jit(jm.init)(jax.random.key(key))
        packs = ("float", "base3", "trit2") if arch[0] == "i" else ("base3",)
        for packing in packs:
            tree = raw if packing == "float" else jternarize(
                raw, JCIMConfig(mode="ternary", packing=packing))
            name = packing if arch[0] == "i" else "moe"
            out[name] = jax.tree.map(np.asarray, tree)
            if name == "base3":
                model, jparams = jm, tree
    return out, model, jparams


def _reference_tokens(model, jparams, specs) -> dict:
    """The reference's unsharded Scheduler's and PagedScheduler's (gather
    read) tokens on the trace."""
    from repro.core.cim_linear import CIMConfig as JCIMConfig
    from repro.serve import PagedScheduler as JPagedScheduler
    from repro.serve import Request as JRequest
    from repro.serve import Scheduler as JScheduler
    tokens = {}
    jcim = JCIMConfig(mode="ternary", packing="base3", backend="xla")
    for kind in ("dense", "paged"):
        clock = worker.FakeClock()
        kw = dict(capacity=worker.CAP, slots=4, chunk=3, cim=jcim,
                  clock=clock, sleep=clock.sleep)
        eng = (JPagedScheduler(model, jparams, page_size=worker.PAGE,
                               fused_attn=False, **kw)
               if kind == "paged" else JScheduler(model, jparams, **kw))
        for uid, prompt, max_new, arrival in specs:
            eng.submit(JRequest(uid=uid, prompt=jnp.asarray(prompt),
                                max_new=max_new, arrival_s=arrival))
        tokens[kind] = {r.uid: [int(t) for t in r.out_tokens]
                        for r in eng.run()}
    return tokens


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' results, and the reference's tokens, which the main
    process takes while the ranks run."""
    from repro_torch.convert import params_from_reference
    tmp = tmp_path_factory.mktemp("mesh_serve")
    trees, model, jparams = _reference_params()
    specs = _specs(21, 10, (8, 12, 6, 10), (5, 3, 6, 4))
    rng = np.random.default_rng(7)
    torch.save(dict(
        params={k: params_from_reference(v, device="cpu")
                for k, v in trees.items()},
        specs=specs, prefix_specs=_prefix_specs(),
        moe_specs=_specs(5, 12, (8, 6), (4, 3)),
        prompts=rng.integers(0, 512, (8, 8)).astype(np.int32).tolist()),
        tmp / "inputs.pt")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ranks = mp.spawn(worker.main,
                         args=("file://" + str(tmp / "store"), str(tmp)),
                         nprocs=worker.WORLD, join=False)
        try:
            reference = _reference_tokens(model, jparams, specs)
        finally:
            while not ranks.join():
                pass
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    out = torch.load(tmp / "results.pt", weights_only=False)
    out["reference"] = reference
    return out


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= ATOL * scale


def _ran_collectives(run) -> bool:
    return sum(run["comm"].values()) > 0


@pytest.mark.parametrize("tag", ["22", "41"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_meshed_scheduler_matches_unmeshed_and_reference(results, kind,
                                                         tag):
    ref_tokens = results["reference"]
    res = results["sched"]
    meshed, plain = res[(kind, tag)], res[(kind, "plain")]
    assert meshed["split"] == (2 if tag == "22" else 4)
    assert meshed["tokens"] == plain["tokens"] == ref_tokens[kind]
    for key in ("chunks_run", "decode_steps", "occupied_slot_steps",
                "steps_run", "host_transfers"):
        assert meshed["counts"][key] == plain["counts"][key], key
    for transfers, chunks, _ in meshed["every_rank"]:
        assert transfers == chunks == plain["counts"]["chunks_run"]
    # the live slots' logits (a dead slot decodes scratch, and a paged
    # pool's scratch reads pages the stripes hand out in another order)
    assert torch.equal(meshed["live"], plain["live"])
    live = plain["live"]
    assert _close(meshed["logits"][live], plain["logits"][live])
    assert _ran_collectives(meshed)
    if kind == "paged":
        stripes = meshed["counts"]["stripes"]
        assert len(stripes) == meshed["split"]
        assert meshed["counts"]["pages_in_use_peak"] == sum(
            s["pages_in_use_peak"] for s in stripes)


def test_paged_prefix_shared_within_a_stripe(results):
    """Request 1 hits request 0's pages on their stripe; request 2's
    pages are on the other stripe, so the meshed pool writes its two
    shared pages again where the unmeshed pool maps them."""
    res = results["sched"]
    meshed, plain = res[("prefix", "22")], res[("prefix", "plain")]
    assert meshed["tokens"] == plain["tokens"]
    stripes = meshed["counts"]["stripes"]
    assert [s["prefix_hits"] for s in stripes] == [3, 0]
    assert plain["counts"]["stripes"][0]["prefix_hits"] == 5
    assert meshed["counts"]["prefix_hit_rate"] < \
        plain["counts"]["prefix_hit_rate"]
    assert meshed["counts"]["pages_in_use_peak"] > \
        plain["counts"]["pages_in_use_peak"]


def test_indivisible_pool_replicates(results):
    res = results["sched"]
    meshed, plain = res[("dense6", "41")], res[("dense6", "plain")]
    assert meshed["split"] is None
    assert all(ls == 6 for _, _, ls in meshed["every_rank"])
    assert meshed["tokens"] == plain["tokens"]
    assert meshed["counts"] == plain["counts"]


@pytest.mark.parametrize("engine", ["bucket", "sched"])
@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_int8_domain_bitwise_on_a_mesh(results, packing, engine):
    res = results["int8"]
    meshed = res[(packing, engine, "22")]
    plain = res[(packing, engine, "plain")]
    assert meshed["tokens"] == plain["tokens"]
    assert torch.equal(meshed["logits"], plain["logits"])
    assert _ran_collectives(meshed)
    if engine == "bucket":
        assert torch.equal(meshed["first"], plain["first"])
        assert meshed["host_transfers"] == plain["host_transfers"] == 1
        # a column-split and a row-split layer both ran
        assert {"ShardedPacked:col", "ShardedPacked:row"} <= \
            set(meshed["kinds"])
    else:
        for transfers, chunks, _ in meshed["every_rank"]:
            assert transfers == chunks


def test_exact_mode_bitwise_and_cached(results):
    meshed, plain = results["exact"]["22"], results["exact"]["plain"]
    assert meshed["backend"] == "codes_cpu"
    assert meshed["tokens"] == plain["tokens"]
    assert torch.equal(meshed["first"], plain["first"])
    assert torch.equal(meshed["logits"], plain["logits"])
    assert meshed["fills_after_warmup"] == 0 and meshed["cache_entries"] > 0
    assert _ran_collectives(meshed)


@pytest.mark.parametrize("engine", ["bucket", "sched"])
@pytest.mark.parametrize("cell", ["base|22|int8", "ep-data|41|int8",
                                  "ep-data|22|float"])
def test_moe_serves_on_a_mesh(results, cell, engine):
    rules, tag, domain = cell.split("|")
    res = results["moe"]
    meshed = res[(rules, tag, engine)]
    plain = res[("plain", domain, engine)]
    assert meshed["tokens"] == plain["tokens"]
    if domain == "int8":
        assert torch.equal(meshed["logits"], plain["logits"])
    else:
        assert _close(meshed["logits"], plain["logits"])
    assert _ran_collectives(meshed)
    moved = any("alltoall" in k for k in meshed["comm"])
    assert moved == (rules == "ep-data")
    if engine == "bucket":
        ep = 2 if rules == "base" else (4 if tag == "41" else 2)
        assert all(k.endswith(f":{ep}") for k in meshed["experts"])


@pytest.mark.parametrize("packing", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", [(128, 64), (94, 64)])
def test_int8_row_shards_join_bitwise(packing, k, n):
    """Two K shards' int32 sums added, then the epilogue, are the
    unsplit int8 product bit for bit (the plain version here; the card
    test runs the kernel's int32 epilogue, ``tests/test_torch_cuda.py``).
    K = 94 under trit2: the last shard's codes are zero-padded."""
    from repro_torch.core.cim_linear import CIMConfig, linear
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    w = ops.pack_weights(torch.as_tensor(rng.standard_normal((k, n)),
                                         dtype=torch.float32), packing)
    x = torch.as_tensor(rng.standard_normal((3, k)), dtype=torch.float32)
    want = linear(x, w, CIMConfig(mode="ternary", packing=packing,
                                  domain="int8"))
    assert torch.equal(worker.int8_row_shards(x, w, 2), want)


def test_expert_halves_join_bitwise():
    """The experts of a packed stack in two halves, joined along E, give
    ``moe_block``'s output bit for bit."""
    from repro_torch.core.cim_linear import CIMConfig, ternarize_params
    from repro_torch.models import moe
    model = worker._smoke("mixtral-8x7b")
    cim = CIMConfig(mode="ternary", packing="base3")
    params = ternarize_params(
        model.init(torch.Generator().manual_seed(0), "cpu"), cim)
    wl = {k: v[0] for k, v in params["blocks"].items()}
    x = torch.randn(3, 5, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want, _ = moe.moe_block(x, wl, model.cfg, cim)
    assert torch.equal(worker.expert_halves(x, wl, model.cfg, cim), want)

"""Macro-exact inference (``CIMConfig(mode="exact")``) of the port's
internlm2-smoke model against the JAX reference, on the CPU at f32, on
the same parameters (carried across by ``repro_torch.convert``) and the
same seeded tokens: every ``dense()`` goes through ``plan_matmul(op=
"cim")``, which encodes the activations and ternarizes the float weights
on every call.

The reference's exact plan runs its Pallas ``cim_mac`` kernel; here it
runs through that kernel's own oracle ``ref.cim_mac_ref`` (the kernel in
interpret mode compiles for a minute per model phase on this host).  The
two are equal at the model's 5-bit ADC, which
tests/test_torch_cim_mac.py holds for the port's plain version, the
oracle and the interpret-mode kernel, at the default blocks of the
reference's plan included.

Bars:

* logits of a prefill and two decode steps within 3% of the logit scale
  and the same argmax.  The MAC is bitwise (the per-layer test) but the
  activation codes are a per-tensor quantization, a step function: a
  one-ulp difference between XLA's CPU ``rsqrt`` and PyTorch's that lands
  on a rounding boundary moves one trit code, as in the int8 domain of
  tests/test_torch_model.py;
* the bucket ``ServeEngine`` gives the reference's greedy tokens, with
  one host transfer per bucket;
* the exact config routes through the cim plan in ``dense`` and resolves
  ``torch`` in the engine on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.kernels import cim_mac as jcim_mac_module
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.kernels import cim_mac as cm
from repro_torch.models import layers, registry
from repro_torch.serve import Request, ServeEngine

jax.config.update("jax_platform_name", "cpu")

B, S, CAP, STEPS = 2, 8, 16, 2
LENGTHS, MAX_NEW = [6, 6, 6], [4, 3, 4]


@pytest.fixture(scope="module")
def reference():
    """The JAX side, computed once: logits of a prefill and two decode
    steps, and the tokens of a short bucket, in exact mode."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcim_mac_module, "cim_mac",
               lambda x, w, adc_bits, **_: jref.cim_mac_ref(x, w, adc_bits))
    try:
        jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                                   dtype=jnp.float32)
        jm = jregistry.build(jcfg)
        jparams = jax.jit(jm.init)(jax.random.key(2))
        cim = JCIMConfig(mode="exact")
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, 512, size=(B, S)).astype(np.int32)
        feed = rng.integers(0, 512, size=(STEPS, B, 1)).astype(np.int32)
        prefill = jax.jit(jm.prefill, static_argnums=(2,),
                          static_argnames=("cim",))
        decode = jax.jit(jm.decode, static_argnames=("cim",))
        lg, state = prefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP,
                            cim=cim)
        logits = [np.asarray(lg)]
        for tok in feed:
            lg, state = decode(jparams, jnp.asarray(tok), state, cim=cim)
            logits.append(np.asarray(lg))
        prompts = [rng.integers(0, 512, size=n).astype(np.int32)
                   for n in LENGTHS]
        eng = JServeEngine(jm, jparams, capacity=CAP, max_batch=4, cim=cim)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(uid=i, prompt=jnp.asarray(p),
                                max_new=MAX_NEW[i]))
        tokens = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    finally:
        mp.undo()
    return dict(params=jax.tree.map(np.asarray, jparams), prompt=prompt,
                feed=feed, logits=logits, prompts=prompts, tokens=tokens,
                transfers=eng.host_transfers)


def _port_model():
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    return registry.build(tcfg)


def test_exact_logits_match_the_reference(reference):
    tm = _port_model()
    params = params_from_reference(reference["params"], device="cpu")
    cim = CIMConfig(mode="exact")
    lg, state = tm.prefill(params, torch.from_numpy(reference["prompt"]),
                           CAP, cim=cim)
    got = [lg.numpy()]
    for tok in reference["feed"]:
        lg, state = tm.decode(params, torch.from_numpy(tok), state, cim=cim)
        got.append(lg.numpy())
    assert len(got) == len(reference["logits"]) == 1 + STEPS
    for want, g in zip(reference["logits"], got):
        assert g.shape == want.shape == (B, 1, 512)
        scale = np.abs(want).max()
        np.testing.assert_allclose(g, want, rtol=0, atol=0.03 * scale)
        np.testing.assert_array_equal(g.argmax(-1), want.argmax(-1))


def test_exact_bucket_tokens_match_the_reference(reference):
    tm = _port_model()
    params = params_from_reference(reference["params"], device="cpu")
    eng = ServeEngine(tm, params, capacity=CAP, max_batch=4,
                      cim=CIMConfig(mode="exact"), device="cpu")
    assert eng.cim.backend == "torch"
    for i, p in enumerate(reference["prompts"]):
        eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW[i]))
    got = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    assert got == reference["tokens"]
    assert eng.host_transfers == reference["transfers"] == 1


def test_dense_routes_an_exact_config_through_the_cim_plan(monkeypatch):
    calls = []
    real = cm.cim_mac_torch
    monkeypatch.setattr(cm, "cim_mac_torch",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.randn(3, 5, 64)
    w = torch.randn(64, 32) * 0.1
    y = layers.dense(x, w, CIMConfig(mode="exact").resolve("cpu"))
    assert y.shape == (3, 5, 32) and y.dtype == x.dtype
    assert calls == [(5, 15, 64)]
    ref_y = (x @ w).abs().max()
    assert float((y - x @ w).abs().max()) < 0.05 * float(ref_y)


# ------------------------------------------- schedulers, one slot a call

SCHED_SEEDS = (4, 5)
SCHED_LENGTHS = (6, 9, 5, 8, 7, 10)
SCHED_NEW, SCHED_SLOTS, SCHED_CHUNK, SCHED_CAP, SCHED_PAGE = 16, 3, 3, 32, 4
SCHED_KINDS = ("dense", "gather", "fused")
NEAR_TIE = 0.02          # fused read: top-2 margin over the logit scale
FUSED_TIES = 1           # fused read: requests a seed may move (seed 5 uid 2)


def _sched_prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in SCHED_LENGTHS]


def _serve_seed(eng, request_cls, wrap, seed):
    """One prompt seed's requests through a scheduler; their tokens."""
    n0 = len(eng.completed)
    for i, p in enumerate(_sched_prompts(seed)):
        eng.submit(request_cls(uid=i, prompt=wrap(p), max_new=SCHED_NEW))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()[n0:]}


@pytest.fixture(scope="module")
def sched_reference():
    """The reference's dense Scheduler, gather and fused PagedScheduler in
    exact mode, its cim_mac and its fused paged read each through its
    oracle (the port's plain versions are those oracles' counterparts;
    the interpret-mode paged kernel's ``m`` is ~2e-6 off its oracle on
    this jax, and exact mode's activation codes are a step function).
    It decodes the dense pool and the gather read one slot per call
    (each slot's activations quantized alone) and the fused read in one
    call over every slot."""
    from repro.kernels import paged_attention as jpa
    from repro.serve import PagedScheduler as JPagedScheduler
    from repro.serve import Scheduler as JScheduler
    mp = pytest.MonkeyPatch()
    mp.setattr(jcim_mac_module, "cim_mac",
               lambda x, w, adc_bits, **_: jref.cim_mac_ref(x, w, adc_bits))
    mp.setattr(jpa, "paged_attention",
               lambda q, kv, **_: jpa.paged_attention_ref(q, kv))
    try:
        jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                                   dtype=jnp.float32)
        jm = jregistry.build(jcfg)
        jparams = jax.jit(jm.init)(jax.random.key(2))
        cim = JCIMConfig(mode="exact")
        kw = dict(capacity=SCHED_CAP, slots=SCHED_SLOTS, chunk=SCHED_CHUNK,
                  cim=cim)
        engines = {
            "dense": JScheduler(jm, jparams, **kw),
            "gather": JPagedScheduler(jm, jparams, page_size=SCHED_PAGE,
                                      fused_attn=False, **kw),
            "fused": JPagedScheduler(jm, jparams, page_size=SCHED_PAGE,
                                     fused_attn=True, **kw)}
        tokens = {kind: {seed: _serve_seed(eng, JRequest, jnp.asarray,
                                           seed)
                         for seed in SCHED_SEEDS}
                  for kind, eng in engines.items()}
    finally:
        mp.undo()
    return dict(params=jax.tree.map(np.asarray, jparams), tokens=tokens)


def _record_logits(monkeypatch, eng):
    """Record, at every decode step of `eng`, each slot's request uid
    and its last-position logits."""
    from repro_torch.serve import engine
    calls, sample = [], engine.greedy_sample

    def greedy(logits):
        calls.append(([None if r is None else r.uid for r in eng._slot_req],
                      logits[:, -1].clone()))
        return sample(logits)
    monkeypatch.setattr(engine, "greedy_sample", greedy)
    return calls


def _margin_at(calls, uid, j):
    """Top-2 margin over the logit scale where request `uid` sampled its
    token j (j >= 1: the j-th decode step its slot took part in; every
    request here runs its full budget, no EOS)."""
    rows = [lg[owners.index(uid)] for owners, lg in calls if uid in owners]
    top = rows[j - 1].topk(2).values
    return float(top[0] - top[1]) / float(rows[j - 1].abs().max())


@pytest.mark.parametrize("kind", SCHED_KINDS)
def test_exact_schedulers_match_the_reference(sched_reference, kind,
                                              monkeypatch):
    """The dense pool and the gather read quantize each slot's
    activations alone (``rows_as_calls``): tokens equal the reference's
    per request on both prompt seeds.  The fused read quantizes every
    slot at once, as the reference's; its attention sums in torch's
    order, not XLA's, and a one-ulp difference that crosses a code
    boundary can move a token, so it gives the reference's tokens but
    in at most ``FUSED_TIES`` requests a seed, each at its first
    divergence a near tie (top-2 margin within ``NEAR_TIE`` of the
    logit scale)."""
    from repro_torch.serve import PagedScheduler, Scheduler
    tm = _port_model()
    params = params_from_reference(sched_reference["params"], device="cpu")
    kw = dict(capacity=SCHED_CAP, slots=SCHED_SLOTS, chunk=SCHED_CHUNK,
              cim=CIMConfig(mode="exact"), device="cpu")
    if kind == "dense":
        eng = Scheduler(tm, params, **kw)
    else:
        eng = PagedScheduler(tm, params, page_size=SCHED_PAGE,
                             fused_attn=kind == "fused", **kw)
    assert eng.decode_per_slot == (kind != "fused")
    assert eng.cim.backend == "torch"
    calls = _record_logits(monkeypatch, eng)
    for seed in SCHED_SEEDS:
        first = len(calls)
        got = _serve_seed(eng, Request, lambda p: p, seed)
        want = sched_reference["tokens"][kind][seed]
        bad = [u for u in want if got[u] != want[u]]
        limit = FUSED_TIES if kind == "fused" else 0
        assert len(bad) <= limit, f"seed {seed}: requests {bad} differ"
        for u in bad:
            j = next(i for i, (a, b) in enumerate(zip(want[u], got[u]))
                     if a != b)
            assert j >= 1                  # a prefill is one call
            margin = _margin_at(calls[first:], u, j)
            assert margin <= NEAR_TIE, (seed, u, j, margin)
    assert eng.host_transfers == eng.chunks_run


def test_rows_as_calls_quantizes_each_row_alone():
    """Inside ``rows_as_calls`` an exact plan's rows equal one call per
    row, bitwise; outside, the rows share one scale."""
    from repro_torch.kernels.plan import rows_as_calls
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 1, 64, generator=gen) * torch.tensor(
        [1.0, 20.0, 0.05])[:, None, None]
    w = torch.randn(64, 32, generator=gen) * 0.1
    cim = CIMConfig(mode="exact").resolve("cpu")
    one_by_one = torch.cat([layers.dense(x[i:i + 1], w, cim)
                            for i in range(3)])
    with rows_as_calls():
        per_row = layers.dense(x, w, cim)
    assert torch.equal(per_row, one_by_one)
    assert not torch.equal(layers.dense(x, w, cim), one_by_one)

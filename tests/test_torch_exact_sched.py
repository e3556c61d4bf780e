"""Macro-exact serving of the port's internlm2-smoke model through the
continuous schedulers against the JAX reference's, on the CPU at f32, on
the same parameters (carried across by ``repro_torch.convert``) and the
same seeded prompts: the dense ``Scheduler`` and the gather and fused
``PagedScheduler`` (``tests/test_torch_exact.py`` holds the logits and
the bucket engine).

The reference's ``cim_mac`` runs through its oracle ``ref.cim_mac_ref``
and its fused paged read through ``paged_attention_ref`` (see the
reference's tokens below).

Bars: the dense pool and the gather read quantize each slot's
activations alone (``rows_as_calls``), and their tokens equal the
reference's per request on prompt seeds 4 and 5; the fused read gives
the reference's tokens but in at most ``FUSED_TIES`` requests a seed,
each at its first divergence a near tie.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.kernels import cim_mac as jcim_mac_module
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.models import registry
from repro_torch.serve import Request

jax.config.update("jax_platform_name", "cpu")


def _port_model():
    return registry.build(dataclasses.replace(
        configs.smoke("internlm2-1.8b"), dtype=torch.float32))


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


@functools.lru_cache(maxsize=None)
def _reference_model():
    """The reference's smoke model and params, made once per worker."""
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    jm = jregistry.build(jcfg)
    return jm, jax.jit(jm.init)(jax.random.key(2))


@functools.lru_cache(maxsize=None)
def _reference_tokens(kind):
    """The reference's dense Scheduler, gather or fused PagedScheduler in
    exact mode over both prompt seeds, its cim_mac and its fused paged
    read each through its oracle (the port's plain versions are those
    oracles' counterparts; the interpret-mode paged kernel's ``m`` is
    ~2e-6 off its oracle on this jax, and exact mode's activation codes
    are a step function).  It decodes the dense pool and the gather read
    one slot per call (each slot's activations quantized alone) and the
    fused read in one call over every slot.  Each kind is made by the
    case that holds it, so each case is charged its own reference."""
    from repro.kernels import paged_attention as jpa
    from repro.serve import PagedScheduler as JPagedScheduler
    from repro.serve import Scheduler as JScheduler
    mp = pytest.MonkeyPatch()
    mp.setattr(jcim_mac_module, "cim_mac",
               lambda x, w, adc_bits, **_: jref.cim_mac_ref(x, w, adc_bits))
    mp.setattr(jpa, "paged_attention",
               lambda q, kv, **_: jpa.paged_attention_ref(q, kv))
    try:
        jm, jparams = _reference_model()
        kw = dict(capacity=SCHED_CAP, slots=SCHED_SLOTS, chunk=SCHED_CHUNK,
                  cim=JCIMConfig(mode="exact"))
        if kind == "dense":
            eng = JScheduler(jm, jparams, **kw)
        else:
            eng = JPagedScheduler(jm, jparams, page_size=SCHED_PAGE,
                                  fused_attn=kind == "fused", **kw)
        return {seed: _serve_seed(eng, JRequest, jnp.asarray, seed)
                for seed in SCHED_SEEDS}
    finally:
        mp.undo()


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
def test_exact_schedulers_match_the_reference(kind, monkeypatch):
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
    params = params_from_reference(
        jax.tree.map(np.asarray, _reference_model()[1]), device="cpu")
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
        want = _reference_tokens(kind)[seed]
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

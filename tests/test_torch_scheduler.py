"""The port's continuous and paged serving against the JAX reference, on
the CPU at f32 smoke size, with the same base3-packed weights (carried
across by ``repro_torch.convert``) and the same seeded prompts.

The reference runs its plain ``xla`` matmul backend; its paged scheduler
runs the gather path, and once the Pallas kernel in interpret mode.  The
port runs its plain versions on the CPU (the fused read through
``paged_attn_torch``).  Bars: identical tokens per request; equal
``chunks_run``, ``decode_steps``, ``occupied_slot_steps``, ``steps_run``,
pages-in-use peak, resident-KV peak and prefix hit rate; and
``host_transfers == chunks_run``.  The trace generators give equal
arrivals from the same seed.
"""
import dataclasses
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.models import registry as jregistry
from repro.serve import PagedScheduler as JPagedScheduler
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro.serve import trace as jtrace
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.models import registry
from repro_torch.serve import (PagedScheduler, Request, Scheduler,
                               ServeEngine, trace)

jax.config.update("jax_platform_name", "cpu")

CAP = 32
# (uid, prompt length, max_new): mixed lengths and budgets, one request
# that never enters the decode loop, more requests than slots
SPECS = [(0, 8, 5), (1, 12, 3), (2, 6, 7), (3, 16, 4), (4, 9, 1), (5, 5, 6)]


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jternarize(jax.jit(jm.init)(jax.random.key(3)),
                         JCIMConfig(mode="ternary", packing="base3"))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jm, tm, jparams, tparams


def _jcim():
    return JCIMConfig(mode="ternary", packing="base3", backend="xla")


def _cim():
    return CIMConfig(mode="ternary", packing="base3")


def _prompts(specs, seed=9):
    rng = np.random.default_rng(seed)
    return {uid: rng.integers(0, 512, size=n).astype(np.int32)
            for uid, n, _ in specs}


def _shared_prompts():
    """Prompts sharing full pages (page size 4): the same 12 tokens
    twice, a 9-token cut of them, and their first 8 tokens followed by
    others; then one unrelated prompt."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 512, size=12).astype(np.int32)
    other = rng.integers(0, 512, size=7).astype(np.int32)
    prompts = {0: base, 1: base.copy(), 2: base[:9].copy(),
               3: np.concatenate([base[:8], base[:4]]), 4: other}
    budgets = {0: 6, 1: 4, 2: 4, 3: 3, 4: 5}
    return prompts, budgets


def _submit(eng, request_cls, prompts, budgets, eos=None, arrivals=None):
    for uid in sorted(prompts):
        p = prompts[uid]
        eng.submit(request_cls(
            uid=uid, prompt=jnp.asarray(p) if request_cls is JRequest else p,
            max_new=budgets[uid],
            eos_id=-1 if eos is None else eos.get(uid, -1),
            arrival_s=0.0 if arrivals is None else arrivals[uid]))


def _tokens(done):
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}


def _budgets(specs):
    return {uid: mn for uid, _, mn in specs}


@functools.lru_cache(maxsize=None)
def _eos_that_fires():
    """EOS ids that fire mid-chunk: request 2 stops at its third token,
    request 5 at its fourth (taken from a run without EOS)."""
    _, tm, _, tparams = _setup()
    eng = Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3, cim=_cim(),
                    device="cpu")
    _submit(eng, Request, _prompts(SPECS), _budgets(SPECS))
    free = _tokens(eng.run())
    return ((2, free[2][2]), (5, free[5][3]))


class FakeClock:
    """A serve clock that moves only when the pump sleeps, so arrivals
    replay identically in both packages."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _counts(eng):
    return (eng.chunks_run, eng.decode_steps, eng.occupied_slot_steps,
            eng.steps_run, eng.host_transfers)


# ------------------------------------------------------------- traces

def test_trace_generators_match_reference():
    for seed in (0, 5):
        assert trace.poisson_arrivals(9, 40.0, seed) == \
            jtrace.poisson_arrivals(9, 40.0, seed)
        assert trace.bursty_arrivals(16, bursts=2, gap_s=0.25, seed=seed) \
            == jtrace.bursty_arrivals(16, bursts=2, gap_s=0.25, seed=seed)
    assert trace.poisson_arrivals(3, 0.0) == [0.0, 0.0, 0.0]
    arr = trace.bursty_arrivals(6, bursts=3, gap_s=1.0, spread_s=0.1,
                                seed=2)
    args = (arr, [8, 16, 4], [3, 5], 7, [0, 1], [None, 0.5])
    assert trace.make_trace(*args) == jtrace.make_trace(*args)
    assert trace.make_trace(arr, [8], [4]) == jtrace.make_trace(arr, [8],
                                                                [4])


def test_load_and_save_trace_match_reference(tmp_path):
    raw = [{"arrival_s": 0.5, "prompt_len": 8, "max_new": 3},
           {"arrival_s": 0.7, "prompt_len": 4, "max_new": 2,
            "priority": 1, "deadline_s": 0.25}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(raw))
    assert trace.load_trace(str(path)) == jtrace.load_trace(str(path))
    out = tmp_path / "out.json"
    trace.save_trace(str(out), raw)
    assert jtrace.load_trace(str(out)) == trace.load_trace(str(path))
    bad = [[{"arrival_s": -1, "prompt_len": 8, "max_new": 3}],
           [{"arrival_s": 1.0, "prompt_len": 8, "max_new": 3},
            {"arrival_s": 0.5, "prompt_len": 8, "max_new": 3}],
           [{"arrival_s": 0.0, "prompt_len": 8}], {"not": "a list"},
           [{"arrival_s": 0.0, "prompt_len": 0, "max_new": 3}]]
    for b in bad:
        with pytest.raises(trace.TraceError) as got:
            trace.validate_trace(b)
        with pytest.raises(jtrace.TraceError) as want:
            jtrace.validate_trace(b)
        assert str(got.value) == str(want.value)
    path.write_text("{not json")
    with pytest.raises(trace.TraceError, match="unparseable"):
        trace.load_trace(str(path))


# ----------------------------------------------------- dense Scheduler

def test_scheduler_matches_reference():
    jm, tm, jparams, tparams = _setup()
    eos = dict(_eos_that_fires())
    prompts, budgets = _prompts(SPECS), _budgets(SPECS)
    jeng = JScheduler(jm, jparams, capacity=CAP, slots=3, chunk=3,
                      cim=_jcim())
    _submit(jeng, JRequest, prompts, budgets, eos)
    want = _tokens(jeng.run())
    teng = Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                     cim=_cim(), device="cpu")
    _submit(teng, Request, prompts, budgets, eos)
    got = _tokens(teng.run())
    assert got == want
    assert got[2][-1] == eos[2] and len(got[2]) == 3
    assert got[5][-1] == eos[5] and len(got[5]) == 4
    assert len(got[4]) == 1
    assert _counts(teng) == _counts(jeng)
    assert teng.host_transfers == teng.chunks_run
    assert teng.slot_occupancy == pytest.approx(jeng.slot_occupancy)
    assert teng.kv_bytes() == jeng.kv_bytes() == teng.kv_bytes_resident()
    assert teng.free_slots() == [0, 1, 2] and not teng.is_busy()


def test_scheduler_with_arrivals_matches_reference():
    """Requests arriving while the pool is busy, on an injected clock:
    the same admissions, rounds, tokens and latencies."""
    jm, tm, jparams, tparams = _setup()
    prompts, budgets = _prompts(SPECS), _budgets(SPECS)
    arrivals = {0: 0.0, 1: 0.0, 2: 0.25, 3: 0.25, 4: 0.5, 5: 1.0}
    jclock, tclock = FakeClock(), FakeClock()
    jeng = JScheduler(jm, jparams, capacity=CAP, slots=2, chunk=2,
                      cim=_jcim(), clock=jclock, sleep=jclock.sleep)
    _submit(jeng, JRequest, prompts, budgets, arrivals=arrivals)
    jdone = jeng.run()
    teng = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=2,
                     cim=_cim(), clock=tclock, sleep=tclock.sleep,
                     device="cpu")
    _submit(teng, Request, prompts, budgets, arrivals=arrivals)
    tdone = teng.run()
    assert _tokens(tdone) == _tokens(jdone)
    assert _counts(teng) == _counts(jeng)
    assert [(r.uid, r.admit_s, r.latency_s) for r in tdone] == \
        [(r.uid, r.admit_s, r.latency_s) for r in jdone]


def test_pump_api_drives_rounds_like_run():
    """try_admit / step_round from outside give run()'s tokens."""
    _, tm, _, tparams = _setup()
    prompts, budgets = _prompts(SPECS), _budgets(SPECS)
    ref = Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3, cim=_cim(),
                    device="cpu")
    _submit(ref, Request, prompts, budgets)
    want = _tokens(ref.run())
    eng = Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3, cim=_cim(),
                    device="cpu")
    pending = [Request(uid=u, prompt=prompts[u], max_new=budgets[u])
               for u in sorted(prompts)]
    while pending or eng.is_busy():
        while pending and eng.try_admit(pending[0], 0.0):
            pending.pop(0)
        eng.step_round(lambda: 0.0)
    assert _tokens(eng.completed) == want
    assert eng.host_transfers == eng.chunks_run == ref.chunks_run


def test_idle_pool_emits_tok0_with_zero_steps():
    _, tm, _, tparams = _setup()
    prompts = _prompts([(0, 6, 1), (1, 6, 1)])
    eng = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=4, cim=_cim(),
                    device="cpu")
    _submit(eng, Request, prompts, {0: 1, 1: 1})
    done = eng.run()
    assert all(len(r.out_tokens) == 1 for r in done)
    assert eng.decode_steps == 0
    assert eng.chunks_run == 1 == eng.host_transfers


# ------------------------------------------------------ PagedScheduler

def _paged_reference(fused_attn, **kw):
    jm, _, jparams, _ = _setup()
    prompts, budgets = _shared_prompts()
    jeng = JPagedScheduler(jm, jparams, capacity=CAP, slots=3, chunk=3,
                           page_size=4, cim=_jcim(), fused_attn=fused_attn,
                           **kw)
    _submit(jeng, JRequest, prompts, budgets)
    return _tokens(jeng.run()), jeng


@pytest.mark.parametrize("fused_attn", [True, False, "auto"])
def test_paged_scheduler_matches_reference(fused_attn):
    want, jeng = _paged_reference(False)
    _, tm, _, tparams = _setup()
    prompts, budgets = _shared_prompts()
    teng = PagedScheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                          page_size=4, cim=_cim(), fused_attn=fused_attn,
                          device="cpu")
    if fused_attn is False:
        assert teng.attn_plan is None
    else:
        assert teng.attn_plan.backend == "paged_attn_torch"
        assert teng.attn_plan.kv_layout == "paged"
    assert teng.cim.kv_layout == "paged" and teng.cim.backend == "torch"
    _submit(teng, Request, prompts, budgets)
    got = _tokens(teng.run())
    assert got == want
    assert _counts(teng) == _counts(jeng)
    assert teng.host_transfers == teng.chunks_run
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use
    assert teng.kv_bytes_resident_peak == jeng.kv_bytes_resident_peak
    assert teng.kv_bytes() == jeng.kv_bytes()
    assert teng.prefix_hit_rate == jeng.prefix_hit_rate > 0.0
    assert teng.pages_in_use == 0 == jeng.pages_in_use
    assert teng.kv_bytes_resident() == 0


def test_paged_fused_matches_reference_pallas_kernel():
    want, jeng = _paged_reference(True)
    assert jeng.attn_plan.backend == "paged_attn"
    _, tm, _, tparams = _setup()
    prompts, budgets = _shared_prompts()
    teng = PagedScheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                          page_size=4, cim=_cim(), fused_attn=True,
                          device="cpu")
    _submit(teng, Request, prompts, budgets)
    assert _tokens(teng.run()) == want
    assert _counts(teng) == _counts(jeng)


def test_paged_matches_dense_scheduler():
    _, tm, _, tparams = _setup()
    prompts, budgets = _prompts(SPECS), _budgets(SPECS)
    outs = []
    for eng in (Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                          cim=_cim(), device="cpu"),
                PagedScheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                               page_size=4, cim=_cim(), fused_attn=False,
                               device="cpu")):
        _submit(eng, Request, prompts, budgets)
        outs.append(_tokens(eng.run()))
    assert outs[0] == outs[1]


def test_pool_exhaustion_defers_and_rolls_back_prefix_stats():
    """Four requests with one 8-token prompt (two full pages of 4) and a
    pool of 3 usable pages: the second request's prefix lookups hit, its
    fresh page does not fit, and the hits are rolled back; every request
    is deferred until the pool frees, then served."""
    jm, tm, jparams, tparams = _setup()
    prompt = np.random.default_rng(4).integers(0, 512, 8).astype(np.int32)
    prompts = {i: prompt.copy() for i in range(4)}
    budgets = {i: 4 for i in range(4)}
    kw = dict(capacity=16, slots=4, chunk=4, page_size=4, num_pages=4)
    jeng = JPagedScheduler(jm, jparams, cim=_jcim(), fused_attn=False, **kw)
    _submit(jeng, JRequest, prompts, budgets)
    want = _tokens(jeng.run())
    teng = PagedScheduler(tm, tparams, cim=_cim(), device="cpu", **kw)
    _submit(teng, Request, prompts, budgets)
    got = _tokens(teng.run())
    assert got == want and len(got) == 4
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use <= 3
    assert (teng.allocator.prefix_hits, teng.allocator.prefix_lookups) == \
        (jeng.allocator.prefix_hits, jeng.allocator.prefix_lookups)
    assert _counts(teng) == _counts(jeng)


def test_oversized_requests_fail_loudly():
    _, tm, _, tparams = _setup()
    eng = PagedScheduler(tm, tparams, capacity=8, slots=1, chunk=2,
                         page_size=4, device="cpu")
    eng.submit(Request(uid=0, prompt=np.zeros(8, np.int32), max_new=8))
    with pytest.raises(ValueError, match="needs .* pages"):
        eng.run()
    eng = PagedScheduler(tm, tparams, capacity=32, slots=1, chunk=2,
                         page_size=4, num_pages=4, device="cpu")
    eng.submit(Request(uid=0, prompt=np.zeros(8, np.int32), max_new=8))
    with pytest.raises(ValueError, match="usable pages"):
        eng.run()


def test_fused_attn_choices(caplog):
    _, tm, _, tparams = _setup()
    with caplog.at_level(logging.INFO, "repro_torch.serve.engine"):
        eng = PagedScheduler(tm, tparams, capacity=CAP, slots=2,
                             fused_attn=False, device="cpu")
    assert eng.attn_plan is None
    assert any("gather" in r.getMessage() for r in caplog.records)
    with pytest.raises(ValueError, match="fused_attn"):
        PagedScheduler(tm, tparams, capacity=CAP, fused_attn="yes",
                       device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        Scheduler(tm, tparams, capacity=CAP, chunk=0, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        Scheduler(tm, tparams, capacity=CAP, slots=0, device="cpu")


def test_schedulers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA device")
    _, tm, _, tparams = _setup()
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler(tm, tparams, capacity=CAP)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedScheduler(tm, tparams, capacity=CAP)


# ------------------------------------------------ bucket engine traces

def test_run_trace_matches_reference():
    jm, tm, jparams, tparams = _setup()
    specs = [(0, 5, 4), (1, 5, 3), (2, 7, 5), (3, 5, 2), (4, 7, 3)]
    prompts, budgets = _prompts(specs, seed=12), _budgets(specs)
    arrivals = {0: 0.0, 1: 0.0, 2: 0.1, 3: 0.4, 4: 0.4}
    jclock, tclock = FakeClock(), FakeClock()
    jeng = JServeEngine(jm, jparams, capacity=CAP, max_batch=4,
                        cim=_jcim())
    _submit(jeng, JRequest, prompts, budgets, arrivals=arrivals)
    jdone = jeng.run_trace(clock=jclock, sleep=jclock.sleep)
    teng = ServeEngine(tm, tparams, capacity=CAP, max_batch=4, cim=_cim(),
                       device="cpu")
    _submit(teng, Request, prompts, budgets, arrivals=arrivals)
    tdone = teng.run_trace(clock=tclock, sleep=tclock.sleep)
    assert _tokens(tdone) == _tokens(jdone)
    assert [(r.uid, r.admit_s, r.latency_s) for r in tdone] == \
        [(r.uid, r.admit_s, r.latency_s) for r in jdone]
    assert teng.host_transfers == jeng.host_transfers
    assert teng.steps_run == jeng.steps_run

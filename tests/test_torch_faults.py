"""Device-fidelity serving of the port against the JAX reference
(``repro.faults``) on the CPU at f32 smoke size, with the same packed
weights (carried across by ``repro_torch.convert``) and the same seeded
inputs (numpy).

Bars, mirroring ``tests/test_faults.py``:

  * ``confusion_from_yields`` equal, with the same validation and
    clamping; ``inject_trit_errors`` bitwise per key, and a piece of a
    leaf's draw bitwise equal to the same elements of the whole draw;
  * ``tl_restore_yield``, ``sl_restore_yield`` and
    ``measured_fault_model``'s per-state yields equal on the tested
    seeds (the trials draw ``prng.normal``, within 4 ulp of jax's);
  * ``FaultModel.fault_trits`` bitwise (cached channel codes and fresh
    draws alike); ``conductance_multiplier`` within 1e-6 relative;
  * ``device_ternary_mac`` bitwise with ``variation`` off, base3 and
    trit2, clip counters equal; with variation on (f32 counts summed in
    another order) outputs equal but for at most 1% of them, each off by
    at most 2 ADC codes times 3^8 times the scales, counters within 1;
  * ``disturb_packed_params``, ``scrub_packed_params``, ``adc_probe`` and
    ``packed_trit_error_rate``: equal packed bytes and counters on the
    smoke params tree (stacked leaves, the reference's leaf order);
  * device-fidelity ``Scheduler`` serving under ``FaultModel(seed=0,
    restore_yield=YIELDS, drift_rate=0.002)``: the reference's tokens,
    ``scrubs_run``, clip counters and served bytes, ``host_transfers ==
    chunks_run``, prefill exact; the ``PagedScheduler`` the same tokens;
  * exact-fidelity hooks inert; capability routing and loud failures;
    launcher validation and output fields; ``num_trits < 5`` packing and
    ``ternarize_params(predicate=)``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import faults as jfaults
from repro.core import error_injection as jei
from repro.core import yield_model as jyield
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.kernels import execute as jexecute
from repro.kernels import ops as jops
from repro.kernels import plan_matmul as jplan_matmul
from repro.kernels import shape_of as jshape_of
from repro.models import registry as jregistry
from repro.serve import PagedScheduler as JPagedScheduler
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import configs, faults
from repro_torch.convert import params_from_reference
from repro_torch.core import error_injection as ei
from repro_torch.core import prng
from repro_torch.core import yield_model
from repro_torch.core.cim_linear import CIMConfig, linear, ternarize_params
from repro_torch.core.ternary import TernaryTensor
from repro_torch.kernels import (execute, get_backend, ops, plan_matmul,
                                 resolve_backend, shape_of)
from repro_torch.kernels.plan import route_fidelity
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry
from repro_torch.serve import PagedScheduler, Request, Scheduler

jax.config.update("jax_platform_name", "cpu")

YIELDS = (0.97, 0.995, 0.96)
GMUL_REL = 1e-6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _trits(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 2, size=shape).astype(np.int8)


@pytest.fixture(autouse=True)
def _restore_campaigns():
    jprev = jfaults.set_fault_model(jfaults.FaultModel())
    prev = faults.set_fault_model(faults.FaultModel())
    yield
    jfaults.set_fault_model(jprev)
    faults.set_fault_model(prev)


# ------------------------------------------------- confusion channel

@pytest.mark.parametrize("yields", [YIELDS, (1.0 + 1e-6, 0.5, -0.25),
                                    (0.9433594, 0.99975586, 1.0)])
def test_confusion_equal_and_clamped(yields):
    want = _np(jei.confusion_from_yields(jnp.asarray(yields)))
    got = ei.confusion_from_yields(yields).numpy()
    assert np.array_equal(want, got)
    assert np.allclose(got.sum(axis=-1), 1.0, atol=1e-6)


def test_confusion_validates():
    with pytest.raises(ValueError, match="shape"):
        ei.confusion_from_yields([0.9, 0.9])
    with pytest.raises(ValueError, match="finite"):
        ei.confusion_from_yields([0.9, float("nan"), 0.9])


@pytest.mark.parametrize("seed", [0, 7, 8])
def test_inject_trit_errors_bitwise(seed):
    tr = _trits((5, 64, 48), seed)
    want = _np(jei.inject_trit_errors(jnp.asarray(tr), jnp.asarray(YIELDS),
                                      jax.random.key(seed)))
    got = ei.inject_trit_errors(_t(tr), YIELDS, prng.key(seed)).numpy()
    assert np.array_equal(want, got)
    assert (got != tr).any()
    tt = ei.inject_restore_errors(TernaryTensor(_t(tr), torch.tensor(0.5)),
                                  YIELDS, prng.key(seed))
    assert np.array_equal(tt.trits.numpy(), got) and float(tt.scale) == 0.5
    # one layer's planes of a stacked leaf, drawn as a piece of the whole
    stacked = _trits((5, 3, 16, 24), seed)
    whole = ei.inject_trit_errors(_t(stacked), YIELDS, prng.key(seed))
    kn = 16 * 24
    blk = prng.Block(kn, 5, 3 * kn, kn)
    piece = ei.inject_trit_errors(_t(stacked[:, 1]), YIELDS, prng.key(seed),
                                  stacked.shape, blk)
    assert torch.equal(piece, whole[:, 1])


def test_expected_rate_equal():
    for prior in ((0.25, 0.5, 0.25), (1 / 3, 1 / 3, 1 / 3)):
        assert ei.expected_trit_error_rate(YIELDS, prior) == pytest.approx(
            jei.expected_trit_error_rate(YIELDS, prior), rel=1e-6)


# ------------------------------------------------------ yield model

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restore_yields_equal(seed):
    want = jyield.tl_restore_yield(jax.random.key(seed), 60, num_mc=2048)
    got = yield_model.tl_restore_yield(prng.key(seed), 60, num_mc=2048,
                                       device="cpu")
    assert np.array_equal(_np(want["per_state"]), got["per_state"].numpy())
    assert want["weighted"] == got["weighted"]
    for n in (6, 30):
        want = jyield.sl_restore_yield(jax.random.key(seed), n, num_mc=1024)
        got = yield_model.sl_restore_yield(prng.key(seed), n, num_mc=1024,
                                           device="cpu")
        assert np.array_equal(_np(want["per_state"]),
                              got["per_state"].numpy())


def test_sweeps_and_measured_model_equal():
    want = jyield.yield_sweep(jax.random.key(5), ns=(6, 60), num_mc=512)
    got = yield_model.yield_sweep(prng.key(5), ns=(6, 60), num_mc=512,
                                  device="cpu")
    for n in (6, 60):
        assert np.array_equal(_np(want[n]["per_state"]),
                              got[n]["per_state"].numpy())
    want = jyield.cluster_sweep(jax.random.key(5), ms=(1, 4), num_mc=512)
    got = yield_model.cluster_sweep(prng.key(5), ms=(1, 4), num_mc=512,
                                    device="cpu")
    for m in (1, 4):
        assert np.array_equal(_np(want[m]["per_state"]),
                              got[m]["per_state"].numpy())
    for seed in (0, 1):
        jm = jfaults.measured_fault_model(seed=seed, drift_rate=0.001)
        tm = faults.measured_fault_model(seed=seed, drift_rate=0.001)
        assert jm.restore_yield == tm.restore_yield
        assert jm.describe() == tm.describe()
    with pytest.raises(ValueError, match="restore_yield"):
        faults.FaultModel(restore_yield=(0.9, 0.9))
    with pytest.raises(ValueError, match="drift_rate"):
        faults.FaultModel(drift_rate=1.5)


# ---------------------------------------------------- fault channels

@pytest.mark.parametrize("kw", [
    dict(seed=3, restore_yield=YIELDS, stuck_rate=0.01),
    dict(seed=1, stuck_rate=0.05), dict(seed=2, restore_yield=YIELDS),
    dict(seed=4)])
def test_fault_trits_bitwise_and_gmul(kw):
    tr = _trits((5, 64, 48), 1)
    jm, tm = jfaults.FaultModel(**kw), faults.FaultModel(**kw)
    want = _np(jm.fault_trits(jnp.asarray(tr), "w"))
    faults.model.clear_code_cache()
    got = tm.fault_trits(_t(tr), "w").numpy()         # a fresh code
    again = tm.fault_trits(_t(tr), "w").numpy()       # the cached one
    assert np.array_equal(want, got) and np.array_equal(got, again)
    a = _np(jm.conductance_multiplier(jnp.asarray(tr), "g"))
    b = tm.conductance_multiplier(_t(tr), "g").numpy()
    assert np.abs(a - b).max() <= GMUL_REL * np.abs(a).max()


def _mac_operands(packing, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jw = jops.pack_weights(jnp.asarray(w), packing)
    tw = ops.pack_weights(_t(w), packing)
    assert np.array_equal(_np(jw.data), tw.data.numpy())
    return x, jw, tw


@pytest.mark.parametrize("packing", ["base3", "trit2"])
@pytest.mark.parametrize("variation,sigma", [(False, 0.0), (False, 0.5),
                                             (True, 0.0), (True, 0.5)])
def test_device_mac(packing, variation, sigma):
    x, jw, tw = _mac_operands(packing)
    kw = dict(seed=0, restore_yield=YIELDS, variation=variation,
              adc_noise_sigma=sigma, stuck_rate=0.01)
    jm, tm = jfaults.FaultModel(**kw), faults.FaultModel(**kw)
    jplanes = jfaults.weight_trit_planes(jw)
    planes = faults.weight_trit_planes(tw)
    assert np.array_equal(_np(jplanes), planes.numpy())
    ya, lo_a, hi_a = jfaults.device_ternary_mac(
        jnp.asarray(x), jplanes, jw.scale, jm, with_stats=True)
    yb, lo_b, hi_b = faults.device_ternary_mac(
        _t(x), planes, tw.scale, tm, with_stats=True)
    ya, yb = _np(ya), yb.numpy()
    if not variation:
        assert np.array_equal(ya, yb)
        assert (int(lo_a), int(hi_a)) == (int(lo_b), int(hi_b))
    else:
        xscale = np.abs(x).max() / 127
        bar = 2 * 3**8 * xscale * np.abs(tw.scale.numpy()).max() * 1.001
        assert (ya != yb).mean() <= 0.01
        assert np.abs(ya - yb).max() <= bar
        assert abs(int(lo_a) - int(lo_b)) <= 1
        assert abs(int(hi_a) - int(hi_b)) <= 1


def test_device_mac_per_row_is_one_call_per_row():
    x, _, tw = _mac_operands("base3")
    tm = faults.FaultModel(seed=1, restore_yield=YIELDS,
                           adc_noise_sigma=0.5)
    planes = faults.weight_trit_planes(tw)
    rows = torch.cat([faults.device_ternary_mac(_t(x[i:i + 1]), planes,
                                                tw.scale, tm)
                      for i in range(x.shape[0])])
    batched = faults.device_ternary_mac(_t(x), planes, tw.scale, tm,
                                        per_row=True)
    assert torch.equal(rows, batched)


@pytest.mark.parametrize("packing", ["base3", "trit2"])
@pytest.mark.parametrize("per_row", [False, True])
def test_device_mac_in_pieces_equals_the_whole(monkeypatch, packing,
                                               per_row):
    """Column pieces of the counts (``COUNT_PIECE``) and flat pieces of
    the channel code (``CODE_PIECE``), ragged at both ends, with ADC
    noise on: bitwise the unchunked port result and the reference's
    (one call, or one call per row when ``per_row``)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 72)).astype(np.float32)   # G = 5, padded
    w = rng.standard_normal((72, 48)).astype(np.float32)
    jw, tw = jops.pack_weights(jnp.asarray(w), packing), ops.pack_weights(
        _t(w), packing)
    kw = dict(seed=2, restore_yield=YIELDS, variation=False,
              adc_noise_sigma=0.5, stuck_rate=0.01)
    jm, tm = jfaults.FaultModel(**kw), faults.FaultModel(**kw)
    jplanes = jfaults.weight_trit_planes(jw)
    planes = faults.weight_trit_planes(tw)

    def port():
        faults.model.clear_code_cache()
        return faults.device_ternary_mac(_t(x), planes, tw.scale, tm,
                                         with_stats=True, per_row=per_row)

    whole = port()
    qi, g = 5, 5
    monkeypatch.setattr(faults.backend, "COUNT_PIECE", 7 * g * qi * 8)
    monkeypatch.setattr(faults.model, "CODE_PIECE", 1000)
    pieces = port()
    faults.model.clear_code_cache()
    for a, b in zip(whole, pieces):
        assert torch.equal(a, b)
    rows = [x] if not per_row else [x[i:i + 1] for i in range(8)]
    want = [jfaults.device_ternary_mac(jnp.asarray(r), jplanes, jw.scale,
                                       jm, with_stats=True) for r in rows]
    assert np.array_equal(np.concatenate([_np(y) for y, _, _ in want]),
                          pieces[0].numpy())
    assert sum(int(lo) for _, lo, _ in want) == int(pieces[1])
    assert sum(int(hi) for _, _, hi in want) == int(pieces[2])


@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_device_execute_deterministic_and_correlated(packing):
    x, _, tw = _mac_operands(packing)
    exact = execute(plan_matmul(shape_of(_t(x), tw), packing=packing,
                                platform="cpu"), _t(x), tw)
    faults.set_fault_model(faults.FaultModel(seed=0, restore_yield=YIELDS))
    plan = plan_matmul(shape_of(_t(x), tw), packing=packing,
                       fidelity="device", platform="cpu")
    assert plan.backend == "device" and plan.fidelity == "device"
    y1, y2 = execute(plan, _t(x), tw), execute(plan, _t(x), tw)
    assert torch.equal(y1, y2) and bool(torch.isfinite(y1).all())
    corr = np.corrcoef(y1.numpy().ravel(), exact.numpy().ravel())[0, 1]
    assert corr > 0.8


# ------------------------------------------------- scrub/drift repair

@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jternarize(jax.jit(jm.init)(jax.random.key(0)),
                         JCIMConfig(mode="ternary", packing="base3"))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jm, tm, jparams, _model_order(tparams, tm.param_specs)


def _model_order(tree, specs):
    """The converted tree (sorted keys, as jax.tree.map leaves it) in the
    port's own key order (``model.init``'s): leaf numbering must not
    depend on it."""
    if isinstance(tree, dict):
        return {k: _model_order(tree[k], specs[k]) for k in specs}
    return tree


def _packed_bytes_equal(jtree, ttree):
    jl = [x for x in jax.tree_util.tree_leaves(
        jtree, is_leaf=lambda x: isinstance(x, jops.PackedTernary))
        if isinstance(x, jops.PackedTernary)]
    tl = [leaf for _, leaf in faults.scrub.packed_leaves(ttree)]
    return len(jl) == len(tl) > 0 and all(
        np.array_equal(_np(a.data), b.data.numpy()) for a, b in zip(jl, tl))


def test_disturb_scrub_probe_equal_on_the_smoke_tree():
    _, _, _, jparams, tparams = _setup()
    assert list(tparams) != sorted(tparams)    # leaf order must be sorted
    jserved = jparams
    served = tparams
    for chunk in range(2):
        jserved = jfaults.disturb_packed_params(
            jserved, 0.01, jax.random.fold_in(jax.random.key(9), chunk))
        served = faults.disturb_packed_params(
            served, 0.01, prng.fold_in(prng.key(9), chunk))
        assert _packed_bytes_equal(jserved, served)
    assert faults.packed_trit_error_rate(served, tparams) == \
        jfaults.packed_trit_error_rate(jserved, jparams) > 0
    jscrub = jfaults.scrub_packed_params(jparams, YIELDS, jax.random.key(10))
    scrub = faults.scrub_packed_params(tparams, YIELDS, prng.key(10))
    assert _packed_bytes_equal(jscrub, scrub)
    post = faults.packed_trit_error_rate(scrub, tparams)
    assert post == jfaults.packed_trit_error_rate(jscrub, jparams) > 0
    assert post <= 2.0 * ei.expected_trit_error_rate(YIELDS,
                                                      (1 / 3, 1 / 3, 1 / 3))
    assert faults.scrub_packed_params(tparams, None, prng.key(1)) is tparams
    for bits in (3, 5):
        want = jfaults.adc_probe(jserved, adc_bits=bits)
        got = faults.adc_probe(served, adc_bits=bits)
        assert tuple(int(v) for v in want) == tuple(int(v) for v in got)


@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_packed_trit_roundtrip(packing):
    w = np.random.default_rng(6).standard_normal((2, 64, 96)).astype(
        np.float32)
    leaf = ternarize_params({"w1": _t(w)}, CIMConfig(
        mode="ternary", packing=packing))["w1"]
    back = faults.trits_to_packed(faults.packed_to_trits(leaf), leaf)
    assert torch.equal(back.data, leaf.data) and back.mode == leaf.mode
    jleaf = jternarize({"w1": jnp.asarray(w)}, JCIMConfig(
        mode="ternary", packing=packing))["w1"]
    assert np.array_equal(_np(jfaults.packed_to_trits(jleaf)),
                          faults.packed_to_trits(leaf).numpy())


# ------------------------------------------------- serving integration

def _prompts(count=2, length=8, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=length).astype(np.int32)
            for _ in range(count)]


FAULTS = dict(seed=0, restore_yield=YIELDS, drift_rate=0.002)


def _serve_port(cls, tm, tparams, faults_kw=FAULTS, **kw):
    faults.set_fault_model(faults.FaultModel(**faults_kw))
    cim = CIMConfig(mode="ternary", packing="base3", fidelity="device")
    s = cls(tm, tparams, capacity=64, slots=2, chunk=2, cim=cim,
            scrub_every=2, device="cpu", **kw)
    for i, p in enumerate(_prompts()):
        s.submit(Request(uid=i, prompt=p, max_new=4))
    return s, {r.uid: r.out_tokens for r in s.run()}


def test_device_serving_matches_the_reference():
    _, jm, tm, jparams, tparams = _setup()
    jfaults.set_fault_model(jfaults.FaultModel(**FAULTS))
    js = JScheduler(jm, jparams, capacity=64, slots=2, chunk=2,
                    cim=JCIMConfig(mode="ternary", packing="base3",
                                   fidelity="device"), scrub_every=2)
    for i, p in enumerate(_prompts()):
        js.submit(JRequest(uid=i, prompt=jnp.asarray(p), max_new=4))
    want = {r.uid: r.out_tokens for r in js.run()}
    s, got = _serve_port(Scheduler, tm, tparams)
    assert got == want
    assert all(len(t) == 4 for t in got.values())
    assert s.cim.backend == "device" and s.cim.fidelity == "device"
    assert s.cim_prefill.fidelity == "exact"
    assert s.cim_prefill.backend == "torch"
    assert s.host_transfers == s.chunks_run == js.chunks_run
    assert s.scrubs_run == js.scrubs_run >= 1
    assert (s.adc_clip_lo, s.adc_clip_hi) == (js.adc_clip_lo,
                                              js.adc_clip_hi)
    assert _packed_bytes_equal(js.params, s.params)
    err = faults.packed_trit_error_rate(s.params, s._params_pristine)
    bound = ei.expected_trit_error_rate(YIELDS, (1 / 3, 1 / 3, 1 / 3))
    assert 0.0 < err <= 3.0 * bound
    assert s.decode_per_slot


@pytest.mark.parametrize("fused", [True, False])
def test_device_paged_serving_matches_the_reference(fused):
    """The reference's fused read is one device-MAC call over every slot
    (one input scale, one ADC-noise draw); its gather read vmaps a
    one-slot decode.  The port's PagedScheduler must follow each."""
    _, jm, tm, jparams, tparams = _setup()
    fm = dict(FAULTS, adc_noise_sigma=0.5)
    jfaults.set_fault_model(jfaults.FaultModel(**fm))
    js = JPagedScheduler(jm, jparams, capacity=64, slots=2, chunk=2,
                         page_size=4, cim=JCIMConfig(
                             mode="ternary", packing="base3",
                             fidelity="device"),
                         scrub_every=2, fused_attn=fused)
    assert (js.attn_plan is not None) == fused
    for i, p in enumerate(_prompts()):
        js.submit(JRequest(uid=i, prompt=jnp.asarray(p), max_new=4))
    want = {r.uid: r.out_tokens for r in js.run()}
    ps, got = _serve_port(PagedScheduler, tm, tparams, faults_kw=fm,
                          page_size=4, fused_attn=fused)
    assert (ps.attn_plan is not None) == fused
    assert ps.decode_per_slot == (not fused)
    assert got == want
    assert ps.host_transfers == ps.chunks_run == js.chunks_run
    assert ps.scrubs_run == js.scrubs_run >= 1
    assert (ps.adc_clip_lo, ps.adc_clip_hi) == (js.adc_clip_lo,
                                                js.adc_clip_hi)
    assert _packed_bytes_equal(js.params, ps.params)


def test_exact_serving_hooks_inert():
    _, _, tm, _, tparams = _setup()
    cim = CIMConfig(mode="ternary", packing="base3")
    assert cim.resolve("cpu") == cim.resolve("cpu", phase="prefill")
    runs = []
    for _ in range(2):
        s = Scheduler(tm, tparams, capacity=64, slots=2, chunk=4, cim=cim,
                      device="cpu")
        for i, p in enumerate(_prompts(3)):
            s.submit(Request(uid=i, prompt=p, max_new=6))
        runs.append({r.uid: r.out_tokens for r in s.run()})
        assert s._fault_serving is False
        assert s._round_extras() == ()
        assert s.adc_clip_lo == s.adc_clip_hi == s.scrubs_run == 0
        assert s.host_transfers == s.chunks_run
        assert s.params is tparams
    assert runs[0] == runs[1]


# ------------------------------------------- fidelity capability axis

def test_device_backend_capability_cells():
    spec = get_backend("device")
    assert spec.fidelities == frozenset({"device"})
    assert spec.ops == frozenset({"ternary"})
    assert spec.platforms == frozenset({"cpu", "cuda"})
    assert spec.priority == 60
    for platform in ("cpu", "cuda"):
        assert resolve_backend("ternary", "auto", platform=platform,
                               fidelity="device").name == "device"
        assert resolve_backend("ternary", "auto", platform=platform,
                               fidelity="exact").name != "device"


def test_unsupported_fidelity_fails_loudly():
    with pytest.raises(ValueError, match="does not support fidelity"):
        resolve_backend("ternary", "cuda", platform="cuda",
                        fidelity="device")
    with pytest.raises(ValueError, match="does not support"):
        resolve_backend("cim", "device", platform="cpu", fidelity="device")
    with pytest.raises(ValueError, match="no registered backend"):
        resolve_backend("cim", "auto", platform="cpu", fidelity="device")
    with pytest.raises(ValueError, match="unknown fidelity"):
        plan_matmul((4, 64, 32), platform="cpu", fidelity="analog")
    with pytest.raises(ValueError, match="device"):
        CIMConfig(mode="float", fidelity="device").resolve("cpu")
    with pytest.raises(ValueError, match="PackedTernary"):
        faults.backend._run_device(plan_matmul(
            (4, 64, 32), platform="cpu", fidelity="device"),
            torch.zeros(4, 64), torch.zeros(64, 32))


def test_route_fidelity_prefill_exact():
    assert route_fidelity("device", "prefill") == "exact"
    assert route_fidelity("device", "decode") == "device"
    assert route_fidelity("device", "auto") == "device"
    assert route_fidelity("exact", "prefill") == "exact"
    plan = plan_matmul((4, 64, 32), platform="cpu", phase="prefill",
                       fidelity="device")
    assert plan.fidelity == "exact" and plan.backend != "device"
    plan = plan_matmul((4, 64, 32), platform="cpu", phase="decode",
                       fidelity="device")
    assert plan.fidelity == "device" and plan.backend == "device"
    assert plan.adc_bits == 5 and plan.num_trits == 5


# --------------------------------------------------------- launcher

def test_launcher_validation_and_fields(capsys):
    for argv, msg in ((["--fidelity", "device", "--continuous"], "--packed"),
                      (["--fidelity", "device", "--packed", "base3"],
                       "--continuous")):
        with pytest.raises(SystemExit):
            launch_serve.main(["--smoke", "--device", "cpu"] + argv)
        assert msg in capsys.readouterr().err
    out = launch_serve.main([
        "--smoke", "--device", "cpu", "--packed", "base3", "--continuous",
        "--slots", "2", "--chunk", "2", "--capacity", "32", "--requests",
        "3", "--prompt-len", "8", "--max-new", "5", "--fidelity", "device",
        "--scrub-every", "2"])
    assert out["fidelity"] == "device" and out["backend"] == "device"
    assert out["scrubs"] >= 1 and out["host_transfers"] == out["chunks"]
    assert {"adc_clip_lo", "adc_clip_hi"} <= set(out)
    assert faults.get_fault_model() == faults.measured_fault_model(
        seed=0, drift_rate=0.001)
    exact = launch_serve.main(["--smoke", "--device", "cpu", "--packed",
                               "base3", "--continuous", "--requests", "2",
                               "--prompt-len", "8", "--max-new", "3"])
    assert exact["fidelity"] == "exact" and "scrubs" not in exact


# ------------------------------------------------ small parity gaps

@pytest.mark.parametrize("num_trits", [3, 4])
def test_ternary_mode_packs_fewer_trits_as_the_reference(num_trits):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    jw = jops.pack_weights(jnp.asarray(w), "base3", num_trits)
    tw = ops.pack_weights(_t(w), "base3", num_trits)
    assert np.array_equal(_np(jw.data), tw.data.numpy())
    assert np.array_equal(_np(jw.scale), tw.scale.numpy())
    cim = CIMConfig(mode="ternary", packing="base3", num_trits=num_trits)
    assert cim.resolve("cpu").backend == "torch"
    jcim = JCIMConfig(mode="ternary", packing="base3", num_trits=num_trits,
                      backend="xla")
    from repro.core.cim_linear import linear as jlinear
    want = _np(jlinear(jnp.asarray(x), jnp.asarray(w), jcim))
    got = linear(_t(x), _t(w), cim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    want = _np(jexecute(jplan_matmul(jshape_of(jnp.asarray(x), jw),
                                     backend="xla"), jnp.asarray(x), jw))
    np.testing.assert_allclose(linear(_t(x), tw, cim).numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_ternarize_params_predicate():
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((64, 64)).astype(np.float32),
            "blk": {"b": rng.standard_normal((64, 96)).astype(np.float32),
                    "c": rng.standard_normal((64, 64)).astype(np.float32)}}

    def pred(path, x):
        name = str(getattr(path[-1], "key", path[-1])) if path else ""
        return getattr(x, "ndim", 0) == 2 and name != "c"

    cfg = CIMConfig(mode="ternary", packing="base3")
    want = jternarize(jax.tree.map(jnp.asarray, tree),
                      JCIMConfig(mode="ternary", packing="base3"),
                      predicate=pred)
    got = ternarize_params(jax.tree.map(_t, tree), cfg, predicate=pred)
    assert isinstance(got["a"], ops.PackedTernary)
    assert isinstance(got["blk"]["b"], ops.PackedTernary)
    assert isinstance(got["blk"]["c"], torch.Tensor)
    assert isinstance(want["blk"]["c"], jax.Array)
    assert np.array_equal(_np(want["blk"]["b"].data),
                          got["blk"]["b"].data.numpy())

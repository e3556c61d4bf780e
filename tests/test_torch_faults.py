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
  * capability routing and loud failures; ``num_trits < 5`` packing and
    ``ternarize_params(predicate=)``.

Device-fidelity serving, the exact-fidelity hooks and the launcher are
in ``tests/test_torch_faults_serving.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_faults_ref import (YIELDS, packed_bytes_equal,  # noqa: F401
                               restore_campaigns, smoke_setup)
from _torch_threads import one_thread  # noqa: F401
from repro import faults as jfaults
from repro.core import error_injection as jei
from repro.core import yield_model as jyield
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.kernels import execute as jexecute
from repro.kernels import ops as jops
from repro.kernels import plan_matmul as jplan_matmul
from repro.kernels import shape_of as jshape_of
from repro_torch import faults
from repro_torch.core import error_injection as ei
from repro_torch.core import prng
from repro_torch.core import yield_model
from repro_torch.core.cim_linear import CIMConfig, linear, ternarize_params
from repro_torch.core.ternary import TernaryTensor
from repro_torch.kernels import (execute, get_backend, ops, plan_matmul,
                                 resolve_backend, shape_of)
from repro_torch.kernels.plan import route_fidelity

jax.config.update("jax_platform_name", "cpu")

GMUL_REL = 1e-6


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _trits(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 2, size=shape).astype(np.int8)


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

def test_disturb_scrub_probe_equal_on_the_smoke_tree():
    _, _, _, jparams, tparams = smoke_setup()
    assert list(tparams) != sorted(tparams)    # leaf order must be sorted
    jserved = jparams
    served = tparams
    for chunk in range(2):
        jserved = jfaults.disturb_packed_params(
            jserved, 0.01, jax.random.fold_in(jax.random.key(9), chunk))
        served = faults.disturb_packed_params(
            served, 0.01, prng.fold_in(prng.key(9), chunk))
        assert packed_bytes_equal(jserved, served)
    assert faults.packed_trit_error_rate(served, tparams) == \
        jfaults.packed_trit_error_rate(jserved, jparams) > 0
    jscrub = jfaults.scrub_packed_params(jparams, YIELDS, jax.random.key(10))
    scrub = faults.scrub_packed_params(tparams, YIELDS, prng.key(10))
    assert packed_bytes_equal(jscrub, scrub)
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

"""The port's macro model (``core.cim``, ``core.device_models``) and the
ternary codec additions of the exact path, against the JAX reference on
the same seeded numpy inputs, on the CPU.

Bars: ``adc_transfer`` (with a given noise array), ``cim_matmul_int``
(K not a multiple of 16, q_i != q_w, adc_bits 3/4/5/8, the all-saturating
case) and ``cim_matmul`` bitwise; ``encode_inputs``, ``ternarize``
('truncate' and 'direct'), ``unpack_base3_to_planes`` and the Table 1
signal encodings bitwise in f32 and bf16; the store/restore table, the
ideal round trip and the restore at nominal resistances exactly; the
deterministic ``device_models`` functions to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.core import cim as jcim
from repro.core import device_models as jdm
from repro.core import packing as jpacking
from repro.core import ternary as jternary
from repro_torch.convert import to_tensor
from repro_torch.core import cim, device_models as dm, packing, ternary

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(a):
    return to_tensor(np.asarray(a), device="cpu")


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


def test_adc_transfer_bitwise_with_given_noise():
    rng = np.random.default_rng(0)
    count = rng.integers(0, 33, size=(4, 7, 9)).astype(np.int32)
    noise = (rng.standard_normal(count.shape) * 0.7).astype(np.float32)
    for bits in (3, 5, 8):
        for nz in (None, noise):
            want = jcim.adc_transfer(jnp.asarray(count), bits,
                                     None if nz is None else jnp.asarray(nz))
            got = cim.adc_transfer(_t(count), bits,
                                   None if nz is None else _t(nz))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("qi,qw,b,k,n,bits", [
    (5, 5, 4, 37, 13, 5), (3, 5, 6, 40, 8, 4), (5, 3, 2, 1000, 7, 3),
    (1, 1, 1, 16, 5, 8), (5, 5, 8, 48, 9, 4), (2, 4, 3, 5, 3, 5)])
def test_cim_matmul_int_bitwise(qi, qw, b, k, n, bits):
    rng = np.random.default_rng(qi * 100 + k)
    x, w = _trits(rng, (qi, b, k)), _trits(rng, (qw, k, n))
    cfg_j, cfg_t = jcim.MacroConfig(adc_bits=bits), cim.MacroConfig(
        adc_bits=bits)
    want = jcim.cim_matmul_int(jnp.asarray(x), jnp.asarray(w), cfg_j)
    got = cim.cim_matmul_int(_t(x), _t(w), cfg_t)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cim_matmul_int_saturating_groups():
    """x = +1 and w = -1 on every row: each full group's MAC is -16 and
    the 5-bit ADC clips it to -15; the partial last group (5 rows) is
    not clipped."""
    x = np.ones((5, 3, 37), np.int8)
    w = -np.ones((5, 37, 4), np.int8)
    got = cim.cim_matmul_int(_t(x), _t(w), cim.MacroConfig())
    want = jcim.cim_matmul_int(jnp.asarray(x), jnp.asarray(w),
                               jcim.MacroConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == (2 * -15 - 5) * 121 * 121


def test_cim_matmul_int_chunks_over_n(monkeypatch):
    """A chunk bound smaller than the problem gives the same answer."""
    rng = np.random.default_rng(3)
    x, w = _trits(rng, (5, 6, 70)), _trits(rng, (5, 70, 33))
    whole = cim.cim_matmul_int(_t(x), _t(w), cim.MacroConfig(adc_bits=4))
    monkeypatch.setattr(cim, "CHUNK_ELEMENTS", 5 * 5 * 16 * 4)
    chunked = cim.cim_matmul_int(_t(x), _t(w), cim.MacroConfig(adc_bits=4))
    assert torch.equal(whole, chunked)


def test_cim_matmul_int_noise_draws_from_the_generator():
    rng = np.random.default_rng(4)
    x, w = _t(_trits(rng, (5, 4, 64))), _t(_trits(rng, (5, 64, 6)))
    cfg = cim.MacroConfig()
    a = cim.cim_matmul_int(x, w, cfg, 0.8, torch.Generator().manual_seed(1))
    b = cim.cim_matmul_int(x, w, cfg, 0.8, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.equal(a, cim.cim_matmul_int(x, w, cfg))
    with pytest.raises(ValueError, match="Generator"):
        cim.cim_matmul_int(x, w, cfg, 0.8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["truncate", "direct"])
def test_cim_matmul_bitwise(dtype, method):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 70)).astype(np.float32)
    w = (rng.standard_normal((70, 24)) * 0.1).astype(np.float32)
    xj, wj = (jnp.asarray(a).astype(DTYPES[dtype]) for a in (x, w))
    want = jcim.cim_matmul(xj, wj, method=method)
    got = cim.cim_matmul(_t(xj), _t(wj), method=method)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_and_ternarize_bitwise(dtype):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((6, 50)) * 4).astype(np.float32)
    xj = jnp.asarray(x).astype(DTYPES[dtype])
    xt = _t(xj)
    pairs = [(jternary.encode_inputs(xj), ternary.encode_inputs(xt)),
             (jternary.encode_inputs(xj, 3), ternary.encode_inputs(xt, 3))]
    for method in ("truncate", "direct"):
        pairs.append((jternary.ternarize(xj, method=method),
                      ternary.ternarize(xt, method=method)))
    pairs.append((jternary.ternarize(xj, axis=0),
                  ternary.ternarize(xt, axis=0)))
    for want, got in pairs:
        assert got.trits.dtype == torch.int8
        np.testing.assert_array_equal(got.trits.numpy(),
                                      np.asarray(want.trits))
        np.testing.assert_array_equal(got.scale.float().numpy(),
                                      np.asarray(want.scale, np.float32))
        assert got.num_trits == want.num_trits
        np.testing.assert_array_equal(got.dequantize().numpy(),
                                      np.asarray(want.dequantize()))
    with pytest.raises(ValueError, match="truncate"):
        ternary.ternarize(xt, method="round")


def test_unpack_base3_to_planes_bitwise():
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 243, size=(3, 40, 17)).astype(np.uint8)
    want = jpacking.unpack_base3_to_planes(jnp.asarray(packed))
    got = packing.unpack_base3_to_planes(_t(packed))
    assert got.dtype == torch.int8 and got.shape == (5, 3, 40, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_signal_encodings_and_store_restore():
    trits = np.array([-1, 0, 1, 1, 0, -1], np.int8)
    tj, tt = jnp.asarray(trits), _t(trits)
    for jf, tf in ((jternary.input_signals, ternary.input_signals),
                   (jternary.weight_signals, ternary.weight_signals)):
        for want, got in zip(jf(tj), tf(tt)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q1, q2 = ternary.weight_signals(tt)
    assert torch.equal(ternary.signals_to_weight_trit(q1, q2), tt)
    levels = cim.store_trits_to_levels(tt)
    np.testing.assert_array_equal(levels.numpy(),
                                  np.asarray(jcim.store_trits_to_levels(tj)))
    assert torch.equal(cim.roundtrip_store_restore(tt), tt)
    assert cim.SIGNAL_TABLE == jcim.SIGNAL_TABLE
    assert (cim.HRS, cim.MRS, cim.LRS) == (jcim.HRS, jcim.MRS, jcim.LRS)
    assert cim.TRIT_TO_LEVEL == jcim.TRIT_TO_LEVEL
    assert cim.LEVEL_TO_TRIT == jcim.LEVEL_TO_TRIT


def test_restore_at_nominal_and_perturbed_resistances():
    d_j, d_t = jdm.DeviceParams(), dm.DeviceParams()
    trits = np.array([-1, 0, 1, 1, -1, 0, 0], np.int8)
    lv_j = jcim.store_trits_to_levels(jnp.asarray(trits))
    lv_t = cim.store_trits_to_levels(_t(trits))
    r_j, r_t = jdm.level_resistance(lv_j, d_j), dm.level_resistance(lv_t, d_t)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    got = cim.restore_levels_to_trits(lv_t, resistances=r_t, device=d_t)
    np.testing.assert_array_equal(got.numpy(), trits)
    # resistances spread around the decision points, a leak and offsets
    rng = np.random.default_rng(10)
    r = (np.asarray(r_j) * np.exp(rng.standard_normal(7) * 0.6)).astype(
        np.float32)
    n1 = (rng.standard_normal(7) * 1e-6).astype(np.float32)
    n2 = (rng.standard_normal(7) * 1e-6).astype(np.float32)
    want = jcim.restore_levels_to_trits(
        lv_j, resistances=jnp.asarray(r), g_leak=5e-7,
        cmp_noise=(jnp.asarray(n1), jnp.asarray(n2)), device=d_j)
    got = cim.restore_levels_to_trits(lv_t, resistances=_t(r), g_leak=5e-7,
                                      cmp_noise=(_t(n1), _t(n2)),
                                      device=d_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_models_deterministic_functions():
    for kw in ({}, dict(r_mrs=300e3, gap_3sigma_over_mu=0.2)):
        d_j, d_t = jdm.DeviceParams(**kw), dm.DeviceParams(**kw)
        assert d_t.mrs == pytest.approx(d_j.mrs, rel=1e-6)
        assert d_t.sigma_ln_r == pytest.approx(d_j.sigma_ln_r, rel=1e-6)
        np.testing.assert_allclose(dm.reference_conductances(d_t),
                                   jdm.reference_conductances(d_j),
                                   rtol=1e-6)
        for n, m in ((1, 1), (60, 4), (8, 2)):
            assert dm.leakage_conductance(n, m, d_t) == pytest.approx(
                jdm.leakage_conductance(n, m, d_j), rel=1e-6)
            assert dm.sl_nominal_threshold(n, d_t) == pytest.approx(
                jdm.sl_nominal_threshold(n, d_j), rel=1e-6)
        rng = np.random.default_rng(11)
        r = (rng.uniform(5e4, 2e6, size=(4, 9))).astype(np.float32)
        cmos = (rng.standard_normal((4, 9)) * 0.03).astype(np.float32)
        np.testing.assert_allclose(
            dm.discharge_conductance(_t(r), d_t, _t(cmos)).numpy(),
            np.asarray(jdm.discharge_conductance(jnp.asarray(r), d_j,
                                                 jnp.asarray(cmos))),
            rtol=1e-6)
        np.testing.assert_allclose(
            dm.sl_divider_voltage(_t(r[:, 0]), _t(r[:, 1:])).numpy(),
            np.asarray(jdm.sl_divider_voltage(jnp.asarray(r[:, 0]),
                                              jnp.asarray(r[:, 1:]))),
            rtol=1e-6)
    assert dm.optimal_mrs(80e3, 1e6) == pytest.approx(
        jdm.optimal_mrs(80e3, 1e6), rel=1e-12)


def test_device_models_sampling_takes_a_generator():
    d = dm.DeviceParams()
    levels = torch.tensor([0, 1, 2, 2], dtype=torch.int8)
    a = dm.sample_resistance(levels, torch.Generator().manual_seed(0), d)
    b = dm.sample_resistance(levels, torch.Generator().manual_seed(0), d)
    assert torch.equal(a, b) and a.dtype == torch.float32
    ratio = (a / dm.level_resistance(levels, d)).log().abs()
    assert float(ratio.max()) < 6 * d.sigma_ln_r
    g = dm.sample_reference_conductances(torch.Generator().manual_seed(0),
                                         d, shape=(1000,))
    nominal = dm.reference_conductances(d)
    for gi, ni in zip(g, nominal):
        assert gi.shape == (1000,)
        assert abs(float(gi.mean()) / ni - 1) < 0.05
    # ref1 (LRS|MRS) conducts most, ref3 (8 x LRS) least
    assert nominal[0] > nominal[1] > nominal[2]

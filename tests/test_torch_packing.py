"""Packed formats and quantizers of the PyTorch port against the JAX
reference, on the same seeded numpy inputs, on the CPU.

Bars: ``pack_weights`` bytes and scales identical (base3 and trit2, 2-D
and layer-stacked 3-D, f32 and bf16, K not a multiple of 4);
``quantize_acts_int8`` bitwise; the balanced-ternary codec round-trips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import ternary as jternary
from repro.kernels import ops as jops
from repro_torch.convert import to_tensor
from repro_torch.core import packing, ternary
from repro_torch.kernels import ops

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(130, 72), (3, 66, 80), (2048, 64)])
def test_pack_weights_bytes_identical(mode, dtype, shape):
    jdt = DTYPES[dtype]
    w = _weights(shape, seed=sum(shape))
    wj = jnp.asarray(w).astype(jdt)
    want = jops.pack_weights(wj, mode)
    got = ops.pack_weights(to_tensor(np.asarray(wj)), mode)
    assert got.mode == mode
    assert got.data.dtype == torch.uint8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == tuple(want.shape)
    assert got.kdim == want.kdim


def test_pack_weights_rejects_unknown_mode():
    with pytest.raises(ValueError, match="base3"):
        ops.pack_weights(torch.zeros(8, 8), "int4")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 200), (4, 1)])
def test_quantize_acts_int8_bitwise(dtype, shape):
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0] = 0.0                       # a zero row takes scale 1.0
    xj = jnp.asarray(x).astype(jdt)
    want_i, want_s = jops.quantize_acts_int8(xj)
    got_i, got_s = ops.quantize_acts_int8(to_tensor(np.asarray(xj)))
    assert got_i.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_acts_int8_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5]])
    xi, xs = ops.quantize_acts_int8(x)
    assert xs.item() == 1.0
    assert xi.tolist() == [[127, 0, 2, 2, 0]]


@pytest.mark.parametrize("num_trits", [3, 5])
def test_balanced_ternary_round_trip(num_trits):
    lim = ternary.trit_range(num_trits)
    vals = torch.arange(-lim - 3, lim + 4, dtype=torch.int32).reshape(1, -1)
    planes = ternary.to_balanced_ternary(vals, num_trits)
    assert planes.shape == (num_trits,) + tuple(vals.shape)
    assert set(planes.unique().tolist()) <= {-1, 0, 1}
    back = ternary.from_balanced_ternary(planes)
    np.testing.assert_array_equal(back.numpy(),
                                  vals.clamp(-lim, lim).numpy())
    want = jternary.to_balanced_ternary(jnp.asarray(vals.numpy()), num_trits)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(want))


def test_trit_codecs_match_reference():
    rng = np.random.default_rng(3)
    trits = rng.integers(-1, 2, size=(12, 5, 7)).astype(np.int8)
    got = packing.pack_trits2(torch.from_numpy(trits))
    want = jpacking.pack_trits2(jnp.asarray(trits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(packing.unpack_trits2(got, k=10).numpy(),
                                  trits[:10])
    vals = rng.integers(-130, 131, size=(9, 4)).astype(np.int32)
    b3 = packing.pack_base3(torch.from_numpy(vals))
    np.testing.assert_array_equal(
        b3.numpy(), np.asarray(jpacking.pack_base3(jnp.asarray(vals))))
    np.testing.assert_array_equal(packing.unpack_base3(b3).numpy(),
                                  np.clip(vals, -121, 121))
    planes = ternary.to_balanced_ternary(torch.from_numpy(vals))
    np.testing.assert_array_equal(
        packing.pack_trit_planes_base3(planes).numpy(), b3.numpy())
    with pytest.raises(ValueError, match="multiple of 4"):
        packing.pack_trits2(torch.zeros(6, 2, dtype=torch.int8))


@pytest.mark.parametrize("mode", ["base3", "trit2", "bf16"])
def test_packed_bytes_matches_reference(mode):
    for shape in [(2048, 2048), (24, 2048, 8192), (7, 3)]:
        assert packing.packed_bytes(shape, mode) == \
            jpacking.packed_bytes(shape, mode)

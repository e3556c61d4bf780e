"""``repro_torch.core.prng`` against ``jax.random`` (jax 0.9, threefry2x32
with ``jax_threefry_partitionable`` on) on the CPU.

Bars: keys (``key``, ``split``, ``fold_in``) and the draws ``bits``,
``uniform`` (spans 1 and 2, the port's; others raise), ``bernoulli`` and
``randint`` (spans below 2^15; others raise) bitwise, on several seeds
and shapes; any piece of a draw (a flat range, or runs strided like one
layer of a stacked leaf's planes) bitwise equal to the same elements of
the whole draw; ``normal_bf16`` bitwise ``jax.random.normal(...,
bfloat16)``; ``normal`` within 4 ulp of ``jax.random.normal`` with at
most 2% of the elements off at all (XLA's ``log1p`` is not torch's; 3 ulp
and 0.9% were measured over 2^20 draws).  Flat indices past 2^31 and
2^32 are held to the scalar threefry of the key functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro_torch.core import prng, yield_model
from repro_torch.kernels import threefry

jax.config.update("jax_platform_name", "cpu")

SEEDS = [0, 1, 12345, 2**31 - 1]
SHAPES = [(7,), (3, 5), (2, 4, 33)]


def _key_words(k):
    return tuple(int(v) for v in jax.random.key_data(k))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    jk, k = jax.random.key(seed), prng.key(seed)
    assert _key_words(jk) == tuple(k)
    for data in (0, 1, 77, 2**32 - 1):
        assert _key_words(jax.random.fold_in(jk, data)) == tuple(
            prng.fold_in(k, data))
    words = jax.random.key_data(jax.random.split(jk, 5))
    assert [tuple(int(v) for v in row) for row in words] == [
        tuple(x) for x in prng.split(k, 5)]
    with pytest.raises(ValueError, match="seed"):
        prng.key(-1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_draws_bitwise(seed, shape):
    jk, k = jax.random.key(seed), prng.key(seed)
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    assert np.array_equal(bits.view(np.int32), prng.bits(k, shape, "cpu").numpy())
    u = np.asarray(jax.random.uniform(jk, shape))
    assert np.array_equal(u.view(np.int32),
                          prng.uniform(k, shape, device="cpu").numpy().view(np.int32))
    for lo, hi in ((-1.0, 1.0), (-3.5, -2.5), (np.nextafter(
            np.float32(-1), np.float32(0)), 1.0)):
        u = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        assert np.array_equal(u, prng.uniform(k, shape, lo, hi, "cpu").numpy())
    with pytest.raises(ValueError, match="spans of 1 or 2"):
        prng.uniform(k, shape, -3.5, 2.25, "cpu")
    for p in (0.002, 0.3, 0.5):
        assert np.array_equal(np.asarray(jax.random.bernoulli(jk, p, shape)),
                              prng.bernoulli(k, p, shape, "cpu").numpy())
    for lo, hi in ((-1, 2), (0, 1000), (-5, 7), (3, 2**15 + 2)):
        assert np.array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi)),
            prng.randint(k, shape, lo, hi, "cpu").numpy()), (lo, hi)
    for lo, hi in ((3, 2**15 + 3), (2, 2)):
        with pytest.raises(ValueError, match="spans in"):
            prng.randint(k, shape, lo, hi, "cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_normal_within_ulp_bar(seed):
    shape = (1 << 16,)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape, "cpu").numpy()
    ulps = _ulps(want, got)
    assert ulps.max() <= 4
    assert (ulps > 0).mean() <= 0.02
    assert np.isfinite(got).all()


@pytest.mark.parametrize("seed,data,shape", [(7, 3, (4, 64, 128)),
                                             (0, 0, (3, 5, 7)),
                                             (2**31 - 1, 9, (2, 33, 96)),
                                             (12345, 1, (1,))])
def test_normal_bf16_bitwise(seed, data, shape):
    """``normal_bf16`` is ``jax.random.normal(..., bfloat16)`` bit for
    bit, an odd element count among the shapes; a block of the draw
    equals the same elements of the whole."""
    k = jax.random.fold_in(jax.random.key(seed), data)
    want = np.asarray(jax.random.normal(k, shape, jnp.bfloat16))
    tk = prng.fold_in(prng.key(seed), data)
    got = prng.normal_bf16(tk, shape, "cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    n = got.numel()
    part = prng.normal_bf16(tk, shape, "cpu",
                            block=prng.flat_range(n // 3, n - n // 3))
    assert torch.equal(part, got.reshape(-1)[n // 3:])


def test_pieces_equal_the_whole_draw():
    k = prng.key(9)
    shape = (5, 3, 16, 24)                   # (planes, layers, K, N)
    whole = {"bits": prng.bits(k, shape, "cpu"),
             "uniform": prng.uniform(k, shape, device="cpu"),
             "randint": prng.randint(k, shape, -1, 2, "cpu"),
             "normal": prng.normal(k, shape, "cpu")}
    kn = 16 * 24
    for layer in range(3):
        blk = prng.Block(layer * kn, 5, 3 * kn, kn)
        for name, full in whole.items():
            fn = getattr(prng, name)
            args = (-1, 2) if name == "randint" else ()
            piece = fn(k, shape, *args, device="cpu", block=blk)
            assert torch.equal(piece, full[:, layer].reshape(5, kn)), name
    flat = whole["uniform"].reshape(-1)
    assert torch.equal(prng.uniform(k, shape, device="cpu",
                                    block=prng.flat_range(17, 100)),
                       flat[17:117])
    with pytest.raises(ValueError, match="outside"):
        prng.bits(k, shape, "cpu", prng.flat_range(5 * 3 * kn - 2, 3))


def test_indices_past_2_31_and_2_32():
    k = prng.key(4)
    for start in (2**31 - 3, 2**32 - 2, 3 * 2**32 + 5):
        got = prng.bits(k, (start + 8,), "cpu", prng.flat_range(start, 6))
        want = []
        for idx in range(start, start + 6):
            y0, y1 = prng.threefry2x32(k, idx >> 32, idx & prng.MASK32)
            w = y0 ^ y1
            want.append(w - (1 << 32) if w >= 1 << 31 else w)
        assert got.tolist() == want


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    k, blk = prng.key(2), prng.Block(7, 3, 100, 40)
    before = threefry.LAUNCHES["threefry"]
    assert torch.equal(threefry.random_bits(k, blk, "cpu"),
                       prng.bits_torch(k, blk, "cpu"))
    assert threefry.LAUNCHES["threefry"] == before


ENTRY_POINTS = {
    "bits": lambda k: prng.bits(k, (4,)),
    "bits_torch": lambda k: prng.bits_torch(k, prng.flat_range(0, 4)),
    "uniform": lambda k: prng.uniform(k, (4,)),
    "bernoulli": lambda k: prng.bernoulli(k, 0.5, (4,)),
    "randint": lambda k: prng.randint(k, (4,), 0, 8),
    "normal": lambda k: prng.normal(k, (4,)),
    "normal_bf16": lambda k: prng.normal_bf16(k, (4,)),
    "tl_restore_yield": lambda k: yield_model.tl_restore_yield(k, 60),
    "sl_restore_yield": lambda k: yield_model.sl_restore_yield(k, 60),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: "
                    "the default device resolves")
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_ask_for_the_card_by_default(name):
    """With no ``device`` the draws and the yield Monte-Carlos ask for
    the card, and raise on a host without one."""
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name](prng.key(0))

"""The port's ``cim_mac`` and its ``op='cim'`` plans against the JAX
reference, on the same seeded numpy inputs, on the CPU, where the
wrapper computes its plain version (the card test of the kernel itself
is in tests/test_torch_cuda.py).

Bars, all bitwise (the MAC is integer-exact and the rescale is the same
f32 product in the same order):

* the plain ``cim_mac`` equals the reference's Pallas kernel in interpret
  mode at adc_bits = 5, and the oracle ``ref.cim_mac_ref`` at adc_bits
  3, 4, 5 and 8, with K not a multiple of 16, M = 1, q_i != q_w and the
  all-saturating case;
* ``execute(plan_matmul(op='cim'))`` with a float weight and with a base3
  ``PackedTernary`` equals the reference's interpret-mode plan on f32
  and bf16 activations; a trit2 weight raises;
* ``CIMConfig(mode='exact')`` resolves ``torch`` on the CPU and ``cuda``
  on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.kernels import execute as jexecute
from repro.kernels import ops as jops
from repro.kernels import plan_matmul as jplan_matmul
from repro.kernels import ref as jref
from repro.kernels import shape_of as jshape_of
from repro.kernels.cim_mac import cim_mac as jcim_mac
from repro_torch.convert import to_tensor
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.kernels import cim_mac as cm
from repro_torch.kernels import execute, ops, plan_matmul, ref, shape_of

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SHAPES = [(5, 5, 8, 37, 13), (3, 5, 1, 40, 8), (1, 1, 4, 16, 5),
          (5, 5, 3, 1000, 7), (5, 3, 8, 64, 300)]


def _t(a):
    return to_tensor(np.asarray(a), device="cpu")


def _planes(qi, qw, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, size=(qi, m, k)).astype(np.int8),
            rng.integers(-1, 2, size=(qw, k, n)).astype(np.int8))


@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_plain_cim_mac_equals_the_pallas_kernel_at_5_bits(qi, qw, m, k, n):
    x, w = _planes(qi, qw, m, k, n, seed=k + n)
    want = jcim_mac(jnp.asarray(x), jnp.asarray(w), adc_bits=5, bm=8, bn=16,
                    bk=32, interpret=True)
    before = cm.LAUNCHES["cim_mac"]
    got = cm.cim_mac(_t(x), _t(w), 5)
    assert cm.LAUNCHES["cim_mac"] == before       # no kernel on the CPU
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(16, 128, 64), (2, 64, 512)])
def test_plain_cim_mac_equals_the_pallas_kernel_at_default_blocks(m, k, n):
    """The smoke model's prefill w2 and decode unembed shapes, at the
    blocks the reference's cim plans run (CIM_DEFAULT_BLOCKS)."""
    x, w = _planes(5, 5, m, k, n, seed=m + k)
    want = jcim_mac(jnp.asarray(x), jnp.asarray(w), adc_bits=5,
                    interpret=True)
    before = cm.LAUNCHES["cim_mac"]
    got = cm.cim_mac(_t(x), _t(w), 5)
    assert cm.LAUNCHES["cim_mac"] == before       # no kernel on the CPU
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [3, 4, 5, 8])
@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_plain_cim_mac_equals_the_oracle(qi, qw, m, k, n, bits):
    x, w = _planes(qi, qw, m, k, n, seed=3 * k + n + bits)
    want = jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w), adc_bits=bits)
    got = cm.cim_mac(_t(x), _t(w), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ref.cim_mac_ref(_t(x), _t(w), bits))


@pytest.mark.parametrize("bits", [4, 5])
def test_plain_cim_mac_all_saturating(bits):
    """x = +1 against w = -1 on every row: each full group's MAC of -16
    clips to 16 - C, the 8-row last group's -8 to max(-8, 8 - C)."""
    x = np.ones((5, 8, 40), np.int8)
    w = -np.ones((5, 40, 8), np.int8)
    want = jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w), adc_bits=bits)
    got = cm.cim_mac(_t(x), _t(w), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = 2**bits - 1
    assert int(got[0, 0]) == (2 * (16 - c) + max(-8, 8 - c)) * 121 * 121


def test_cim_mac_wrapper_refusals():
    x, w = (_t(a) for a in _planes(5, 5, 2, 16, 4, seed=0))
    with pytest.raises(ValueError, match="K=16"):
        cm.cim_mac(x, w[:, :8])
    with pytest.raises(TypeError, match="int8"):
        cm.cim_mac(x.int(), w)
    with pytest.raises(ValueError, match="planes"):
        cm.cim_mac(torch.zeros((6, 2, 16), dtype=torch.int8), w)
    with pytest.raises(ValueError, match="adc_bits"):
        cm.cim_mac(x, w, 0)


def test_split_groups_covers_k_in_whole_steps():
    for m, k, n in ((8, 2048, 2048), (8, 8192, 2048), (8, 2048, 92672),
                    (1024, 2048, 1024), (1024, 2048, 8192), (3, 37, 5)):
        splits, per = cm.split_groups(m, k, n, sm_count=132)
        groups = -(-k // 16)
        assert per % cm.STAGE_GROUPS == 0
        assert (splits - 1) * per < groups <= splits * per


def _weights(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight", ["float", "base3"])
def test_execute_cim_plan_matches_the_reference(dtype, weight):
    jdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    xj = jnp.asarray(rng.standard_normal((2, 3, 72)).astype(np.float32)
                     ).astype(jdt)
    wj = jnp.asarray(_weights(72, 40, seed=13)).astype(jdt)
    if weight == "base3":
        wj = jops.pack_weights(wj, "base3")
        wt = ops.PackedTernary(_t(wj.data), _t(wj.scale), "base3")
    else:
        wt = _t(wj)
    jplan = jplan_matmul(jshape_of(xj, wj), op="cim", interpret=True, bm=8,
                         bn=16, bk=32)
    want = jexecute(jplan, xj, wj)
    plan = plan_matmul(shape_of(_t(xj), wt), op="cim", platform="cpu")
    assert plan.backend == "torch" and (plan.adc_bits, plan.num_trits) == (
        5, 5)
    got = execute(plan, _t(xj), wt)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cim_plan_refuses_trit2_weights():
    w = ops.pack_weights(_t(_weights(64, 16, seed=1)), "trit2")
    x = torch.zeros((2, 64))
    plan = plan_matmul(shape_of(x, w), op="cim", platform="cpu")
    with pytest.raises(ValueError, match="base3"):
        execute(plan, x, w)


def test_exact_config_resolves_the_cim_backends():
    cfg = CIMConfig(mode="exact")
    assert cfg.resolve("cpu").backend == "torch"
    assert cfg.resolve("cuda").backend == "cuda"
    assert CIMConfig(mode="exact", backend="torch").resolve(
        "cuda").backend == "torch"
    with pytest.raises(ValueError, match="op"):
        CIMConfig(mode="exact", backend="ref").resolve("cpu")
    with pytest.raises(ValueError, match="platform"):
        CIMConfig(mode="exact", backend="cuda").resolve("cpu")
    # ternary mode packs fewer trits as the reference does (the parity
    # test is tests/test_torch_faults.py)
    assert CIMConfig(mode="ternary", num_trits=3).resolve(
        "cpu").backend == "torch"


@pytest.mark.parametrize("k,bits,bk,differs", [
    (32, 4, 64, True), (40, 4, 16, True), (40, 5, 16, False),
    (48, 3, 16, False)])
def test_reference_pallas_kernel_departs_from_its_oracle_below_5_bits(
        k, bits, bk, differs):
    """A fault of the reference, kept as it is: the Pallas kernel clips
    every 16-row group to the full group's window [16 - 2^b + 1, 16],
    which holds 0 only for b >= 5, so below 5 bits its zero-padded
    groups add and its partial groups clip wrongly; the oracle treats
    missing rows as deactivated.  The port follows the oracle."""
    x, w = _planes(5, 5, 8, k, 8, seed=k * bits)
    pallas = np.asarray(jcim_mac(jnp.asarray(x), jnp.asarray(w),
                                 adc_bits=bits, bm=8, bn=8, bk=bk,
                                 interpret=True))
    oracle = np.asarray(jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w),
                                         adc_bits=bits))
    gap = int(np.abs(pallas.astype(np.int64) - oracle).max())
    print(f"K={k} adc_bits={bits} bk={bk}: max |pallas - oracle| = {gap}")
    assert (gap > 0) == differs
    np.testing.assert_array_equal(cm.cim_mac(_t(x), _t(w), bits).numpy(),
                                  oracle)

"""The code route of the port's ``cim_mac`` against the JAX reference, on
the CPU, on the same seeded numpy inputs (the card tests of its kernels
are in tests/test_torch_cuda.py).

The route rests on one identity: each 16-row group adds
``clamp(mac, r_g - C, r_g) = mac + relu(r_g - C - mac)``, and summed
with the powers of 3 the mac part is one integer product of the 5-trit
codes.  Bars, all bitwise (integer arithmetic):

* product + ``correction_torch`` equals the reference's oracle
  ``ref.cim_mac_ref`` for adc_bits 1 to 8, ragged K, q_i != q_w, planted
  saturating groups and the all-saturating case, and the Pallas kernel
  in interpret mode at 5 bits on a planted case;
* the correction kernel's algorithm, emulated here from the weight's
  full-group lists, equals the dense correction at 5 bits, and the lists
  equal a direct computation from the planes;
* the code entry's plain version equals the oracle, and the cuda
  backend's code-route runner (with its plain MAC on the CPU) equals the
  reference's interpret-mode cim plan;
* the weight cache holds exactly what ``ternarize`` gives on each call,
  is made again after an in-place change, and lets go of a dead weight.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro.core.packing import pack_trit_planes_base3 as jpack_planes
from repro.kernels import execute as jexecute
from repro.kernels import ops as jops
from repro.kernels import plan_matmul as jplan_matmul
from repro.kernels import ref as jref
from repro.kernels import shape_of as jshape_of
from repro.kernels.cim_mac import cim_mac as jcim_mac
from repro_torch.convert import to_tensor
from repro_torch.core.ternary import (from_balanced_ternary, ternarize,
                                      to_balanced_ternary)
from repro_torch.kernels import backends, ops, plan_matmul, shape_of
from repro_torch.kernels import cim_mac as cm

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(5, 5, 8, 37, 13), (3, 5, 4, 64, 9), (5, 3, 3, 100, 7),
          (1, 1, 4, 16, 5), (5, 5, 2, 48, 300)]


def _t(a):
    return to_tensor(np.asarray(a), device="cpu")


def _planted(qi, qw, m, k, n, seed, plants=6):
    """Seeded random trit planes with `plants` saturating spots: x_i's 16
    trits of a group all non-zero and w_j's of one column their negation
    (mac = -16), plus the same x_i against w_0 at the cross pair."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, size=(qi, m, k)).astype(np.int8)
    w = rng.integers(-1, 2, size=(qw, k, n)).astype(np.int8)
    for _ in range(plants if k >= 16 else 0):
        mm, g = rng.integers(m), rng.integers(k // 16)
        i, j, nn = rng.integers(qi), rng.integers(qw), rng.integers(n)
        rows = slice(16 * g, 16 * g + 16)
        x[i, mm, rows] = rng.choice([-1, 1], size=16)
        w[j, rows, nn] = -x[i, mm, rows]
    return x, w


def _decomposition(x, w, bits):
    """The code route in plain torch: X @ W + the clip's correction."""
    xt, wt = _t(x), _t(w)
    product = (from_balanced_ternary(xt).to(torch.int64)
               @ from_balanced_ternary(wt).to(torch.int64))
    return (product + cm.correction_torch(xt, wt, bits)).to(torch.int32)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_product_plus_correction_equals_the_oracle(qi, qw, m, k, n, bits):
    x, w = _planted(qi, qw, m, k, n, seed=k + n + bits)
    want = np.asarray(jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w),
                                       adc_bits=bits))
    np.testing.assert_array_equal(_decomposition(x, w, bits).numpy(), want)


@pytest.mark.parametrize("bits", [1, 3, 4, 5, 6, 8])
def test_product_plus_correction_all_saturating(bits):
    x = np.ones((5, 3, 40), np.int8)
    w = -np.ones((5, 40, 6), np.int8)
    want = np.asarray(jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w),
                                       adc_bits=bits))
    np.testing.assert_array_equal(_decomposition(x, w, bits).numpy(), want)


def test_correction_is_zero_from_6_bits():
    x, w = _planted(5, 5, 8, 256, 40, seed=9, plants=10)
    xt, wt = _t(x), _t(w)
    for bits in (6, 7, 8, 12):
        assert not cm.correction_torch(xt, wt, bits).any()
    c5 = cm.correction_torch(xt, wt, 5)
    assert c5.any() and bool((c5 >= 0).all())


def test_code_route_equals_the_pallas_kernel_at_5_bits():
    x, w = _planted(5, 5, 8, 64, 16, seed=4, plants=12)
    want = jcim_mac(jnp.asarray(x), jnp.asarray(w), adc_bits=5, bm=8,
                    bn=16, bk=32, interpret=True)
    got = _decomposition(x, w, 5)
    assert int(cm.correction_torch(_t(x), _t(w), 5).sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xc = from_balanced_ternary(_t(x)).to(torch.int8)
    np.testing.assert_array_equal(
        cm.cim_mac_codes(xc, cm.code_weight(_t(w)), 5).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("bits,want", [(1, "groups"), (3, "groups"),
                                       (4, "groups"), (5, "codes"),
                                       (6, "codes"), (8, "codes"),
                                       (30, "codes")])
def test_route_takes_codes_from_5_bits(bits, want):
    assert cm.route(bits) == want


def _direct_lists(w):
    """{(g, n): (planes full, [negative mask of each full plane])} from
    the planes, row by row."""
    qw, k, n = w.shape
    out = {}
    for g in range(k // 16):
        for nn in range(n):
            planes, pats = 0, [0] * 5
            for j in range(qw):
                col = w[j, 16 * g:16 * g + 16, nn]
                if (col != 0).all():
                    planes |= 1 << j
                    pats[j] = sum(1 << r for r in range(16) if col[r] < 0)
            if planes:
                out[(g, nn)] = (planes, pats)
    return out


def _lists(groups):
    off = groups.offsets.numpy()
    ent = groups.entries.numpy().view(np.uint32)
    out = {}
    for g in range(len(off) - 1):
        for nn, a, b, c in ent[off[g]:off[g + 1]]:
            out[(g, int(nn))] = (int(c >> 16), [int(a & 0xffff), int(a >> 16),
                                                int(b & 0xffff), int(b >> 16),
                                                int(c & 0xffff)])
    return out


@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_full_group_lists_equal_a_direct_computation(qi, qw, m, k, n):
    _, w = _planted(qi, qw, m, k, n, seed=2 * k + n, plants=8)
    groups = cm.full_groups(_t(w))
    assert groups.offsets.dtype == groups.entries.dtype == torch.int32
    assert groups.offsets.shape == (k // 16 + 1,)
    assert groups.entries.shape[1] == 4
    assert _lists(groups) == _direct_lists(w)
    # columns ascend inside each group
    off = groups.offsets.numpy()
    cols = groups.entries[:, 0].numpy()
    for g in range(k // 16):
        assert (np.diff(cols[off[g]:off[g + 1]]) > 0).all()


def _emulated_correction(x_codes, cw):
    """cim_correct_kernel's algorithm in numpy: per (row, full group),
    each x plane whose 16 digits are all non-zero against the group's
    listed columns, 3^(i+j) where w_j's negative mask is x_i's positive
    mask."""
    m, k = x_codes.shape
    lists = _lists(cw.groups)
    xt = to_balanced_ternary(_t(x_codes).to(torch.int32), 5).numpy()
    out = np.zeros((m, cw.data.shape[1]), np.int64)
    for (g, nn), (planes, pats) in lists.items():
        for mm in range(m):
            seg = xt[:, mm, 16 * g:16 * g + 16]
            for i in range(5):
                if not (seg[i] != 0).all():
                    continue
                positive = sum(1 << r for r in range(16) if seg[i][r] > 0)
                for j in range(5):
                    if planes >> j & 1 and pats[j] == positive:
                        out[mm, nn] += 3**(i + j)
    return out


@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES + [(5, 5, 2, 40, 3)])
def test_list_correction_equals_the_dense_correction(qi, qw, m, k, n):
    if (m, k, n) == (2, 40, 3):                  # every group saturates
        x = np.ones((qi, m, k), np.int8)
        w = -np.ones((qw, k, n), np.int8)
    else:
        x, w = _planted(qi, qw, m, k, n, seed=k * n, plants=8)
    xc = from_balanced_ternary(_t(x)).to(torch.int8)
    want = cm.correction_torch(_t(x), _t(w), 5).numpy()
    np.testing.assert_array_equal(
        _emulated_correction(xc.numpy(), cm.code_weight(_t(w))), want)


@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_code_weight_holds_the_base3_bytes(qi, qw, m, k, n):
    """The 5-trit base3 byte (code + 121) whatever the planes: fewer
    planes are the 5-trit code with zero high digits."""
    _, w = _planted(qi, qw, m, k, n, seed=n)
    w5 = np.concatenate([w, np.zeros((5 - qw, k, n), np.int8)])
    np.testing.assert_array_equal(cm.code_weight(_t(w)).data.numpy(),
                                  np.asarray(jpack_planes(jnp.asarray(w5))))


@pytest.mark.parametrize("bits", [5, 6, 8])
@pytest.mark.parametrize("qi,qw,m,k,n", SHAPES)
def test_code_entry_plain_version_equals_the_oracle(qi, qw, m, k, n, bits):
    x, w = _planted(qi, qw, m, k, n, seed=k + bits)
    want = np.asarray(jref.cim_mac_ref(jnp.asarray(x), jnp.asarray(w),
                                       adc_bits=bits))
    xc = from_balanced_ternary(_t(x)).to(torch.int8)
    before = dict(cm.ROUTES), cm.LAUNCHES["cim_mac"]
    got = cm.cim_mac_codes(xc, cm.code_weight(_t(w)), bits)
    assert (dict(cm.ROUTES), cm.LAUNCHES["cim_mac"]) == before  # CPU
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_code_entry_refusals():
    xc = torch.zeros((2, 32), dtype=torch.int8)
    cw = cm.code_weight(torch.zeros((5, 32, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="adc_bits"):
        cm.cim_mac_codes(xc, cw, 4)
    with pytest.raises(ValueError, match="K=16"):
        cm.cim_mac_codes(xc[:, :16], cw)
    with pytest.raises(TypeError, match="int8"):
        cm.cim_mac_codes(xc.to(torch.int32), cw)
    with pytest.raises(ValueError, match="codes"):
        cm.cim_mac_codes(xc[None], cw)


def _weights(k, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                            .astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_cache_holds_what_ternarize_gives(dtype):
    stack = torch.stack([_weights(64, 48, seed=s, dtype=dtype)
                         for s in range(3)])
    cache = backends.CodeWeightCache()
    for layer in range(3):
        cw, scale = cache.get(stack[layer], 5)
        tt = ternarize(stack[layer], 5)
        assert torch.equal(cw.data, cm.code_weight(tt.trits).data)
        assert torch.equal(scale, tt.scale) and scale.dtype == dtype
        for a, b in zip(cw.groups, cm.full_groups(tt.trits)):
            assert torch.equal(a, b)
    assert cache.fills == len(cache) == 3
    again, _ = cache.get(stack[1], 5)       # a new view of the same data
    assert again.data is cache.get(stack[1], 5)[0].data
    assert cache.fills == 3
    cache.get(stack[1], 3)                  # another trit count
    assert cache.fills == 4


def test_weight_cache_is_made_again_after_an_in_place_change():
    stack = torch.stack([_weights(64, 32, seed=s) for s in range(2)])
    cache = backends.CodeWeightCache()
    first, _ = cache.get(stack[0], 5)
    stack[0].mul_(-2.0)
    cw, scale = cache.get(stack[0], 5)
    tt = ternarize(stack[0], 5)
    assert cache.fills == 2
    assert torch.equal(cw.data, cm.code_weight(tt.trits).data)
    assert torch.equal(scale, tt.scale)
    assert not torch.equal(cw.data, first.data)
    cache.get(stack[1], 5)
    assert cache.fills == 3                 # the other layer's own entry


def test_weight_cache_lets_go_of_a_dead_weight():
    cache = backends.CodeWeightCache()
    w = _weights(32, 16, seed=1)
    cache.get(w, 5)
    assert len(cache) == 1
    del w
    gc.collect()
    assert len(cache) == 0
    # a new tensor, wherever it lands, is made anew
    w2 = _weights(32, 16, seed=2)
    cw, scale = cache.get(w2, 5)
    assert cache.fills == 2
    assert torch.equal(scale, ternarize(w2, 5).scale)


def test_weight_cache_takes_a_base3_packed_weight():
    w = ops.pack_weights(_weights(48, 16, seed=3), "base3")
    cw, scale = backends.CodeWeightCache().get(w, 5)
    assert torch.equal(cw.data, w.data) and scale is w.scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight", ["float", "base3"])
def test_code_route_runner_matches_the_reference_plan(dtype, weight):
    """The cuda backend's code-route runner (its MAC's plain version on
    the CPU, the cache included) against the reference's interpret-mode
    cim plan and the torch backend's per-call runner."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(21)
    xj = jnp.asarray(rng.standard_normal((2, 3, 80)).astype(np.float32)
                     ).astype(jdt)
    wj = jnp.asarray((rng.standard_normal((80, 24)) / 9).astype(np.float32)
                     ).astype(jdt)
    if weight == "base3":
        wj = jops.pack_weights(wj, "base3")
        wt = ops.PackedTernary(_t(wj.data), _t(wj.scale), "base3")
    else:
        wt = _t(wj)
    jplan = jplan_matmul(jshape_of(xj, wj), op="cim", interpret=True, bm=8,
                         bn=8, bk=16)
    want = np.asarray(jexecute(jplan, xj, wj))
    plan = plan_matmul(shape_of(_t(xj), wt), op="cim", platform="cpu")
    got = backends._run_cim_codes(plan, _t(xj), wt)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 24)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, backends._run_torch(plan, _t(xj), wt))

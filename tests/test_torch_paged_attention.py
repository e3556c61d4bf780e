"""The port's paged-attention read against the JAX reference, on the CPU.

Seeded numpy inputs go through the reference's gather oracle
(``paged_attention_ref``) and its Pallas kernel in interpret mode, and
through the port's plain version ``paged_attention_torch`` and its
wrapper (which takes the plain version on a CPU tensor).  The inputs hold
what the serving path gives the kernel: positions on and around page
boundaries, ``pos = 0`` slots (idle slots start there every chunk), slots
sharing prefix pages, and a null page (page 0) full of large finite
garbage that every unused table entry points at.

Bars (f32): ``m`` within 1e-5 * max(1, |m|); ``acc`` and ``l`` within 1e-4
of their per-row maximum.  The reference's own kernel and oracle differ by
up to ~2e-6 in ``m`` on this JAX version, and the summation orders of the
three implementations differ, so none of them is bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plan_matmul, resolve_backend

jax.config.update("jax_platform_name", "cpu")

PS, W = 16, 32                            # page size, windows: capacity 512
POS = [0, 1, 15, 16, 17, 511, 512]        # page edges, empty and full slots
GARBAGE = 3.0e4


def _inputs(kvh=2, rep=2, hd=16, pos=POS, seed=0):
    rng = np.random.default_rng(seed)
    s = len(pos)
    num_pages = 1 + s * W
    q = rng.standard_normal((s, kvh, rep, hd)).astype(np.float32)
    q /= np.sqrt(hd)
    k = rng.standard_normal((num_pages, PS, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, PS, kvh, hd)).astype(np.float32)
    k[0] = GARBAGE * rng.choice([-1.0, 1.0], size=k[0].shape)
    v[0] = GARBAGE * rng.choice([-1.0, 1.0], size=v[0].shape)
    ids = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = np.zeros((s, W), np.int32)
    for i, p in enumerate(pos):
        n = -(-p // PS)                   # pages holding live positions
        table[i, :n] = ids[i * W: i * W + n]
    # slots 3 and 5 share slot 6's first page (a shared prompt prefix)
    table[3, 0] = table[5, 0] = table[6, 0]
    return q, k, v, table, np.asarray(pos, np.int32)


def _port(q, k, v, table, pos):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    return pa.PagedAttentionKV(t(k), t(v), t(table), t(pos)), t(q)


def _check(got, want):
    acc, m, l = (np.asarray(x) for x in got)
    acc_r, m_r, l_r = (np.asarray(x) for x in want)
    assert np.all(np.abs(m - m_r) <= 1e-5 * np.maximum(1.0, np.abs(m_r)))
    l_scale = np.abs(l_r)
    assert np.all(np.abs(l - l_r) <= 1e-4 * l_scale)
    acc_scale = np.abs(acc_r).max(axis=-1, keepdims=True)
    assert np.all(np.abs(acc - acc_r) <= 1e-4 * acc_scale)


@pytest.mark.parametrize("kvh,rep,hd", [(2, 2, 16), (1, 4, 8)])
def test_plain_version_matches_reference_oracle(kvh, rep, hd):
    q, k, v, table, pos = _inputs(kvh, rep, hd)
    want = jpa.paged_attention_ref(
        jnp.asarray(q), jpa.PagedAttentionKV(jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(table),
                                             jnp.asarray(pos)))
    kv, tq = _port(q, k, v, table, pos)
    got = pa.paged_attention_torch(tq, kv)
    _check([x.numpy() for x in got], want)
    # the pos = 0 slot: m = -1e30 and l = every position of its table
    m, l = got[1].numpy(), got[2].numpy()
    assert np.all(m[0] == np.float32(pa.NEG_INF))
    assert np.all(l[0] == W * PS)


def test_plain_version_matches_reference_pallas_kernel():
    q, k, v, table, pos = _inputs()
    want = jpa.paged_attention(
        jnp.asarray(q), jpa.PagedAttentionKV(jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(table),
                                             jnp.asarray(pos)),
        interpret=True)
    kv, tq = _port(q, k, v, table, pos)
    _check([x.numpy() for x in pa.paged_attention_torch(tq, kv)], want)


def test_null_page_contributes_exactly_zero_to_live_slots():
    q, k, v, table, pos = _inputs()
    kv, tq = _port(q, k, v, table, pos)
    k0, v0 = k.copy(), v.copy()
    k0[0] = 0.0
    v0[0] = 0.0
    kv0, _ = _port(q, k0, v0, table, pos)
    got = pa.paged_attention_torch(tq, kv)
    clean = pa.paged_attention_torch(tq, kv0)
    live = pos > 0
    for a, b in zip(got, clean):
        assert torch.equal(a[live], b[live])


def test_cpu_wrapper_is_the_plain_version():
    q, k, v, table, pos = _inputs(seed=3)
    kv, tq = _port(q, k, v, table, pos)
    pa.reset_launches()
    got = pa.paged_attention(tq, kv)
    want = pa.paged_attention_torch(tq, kv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert pa.LAUNCHES["paged_attention"] == 0     # no kernel on the CPU


def test_shape_checks():
    q, k, v, table, pos = _inputs()
    kv, tq = _port(q, k, v, table, pos)
    with pytest.raises(ValueError, match="q \\(slots, KV, rep, hd\\)"):
        pa.paged_attention(tq[0], kv)
    with pytest.raises(ValueError, match="does not match q"):
        pa.paged_attention(tq[..., :8], kv)
    with pytest.raises(ValueError, match="does not match q"):
        pa.paged_attention(tq, kv._replace(v_pages=kv.v_pages[:-1]))
    with pytest.raises(ValueError, match="do not cover"):
        pa.paged_attention(tq, kv._replace(page_table=kv.page_table[:-1]))
    with pytest.raises(ValueError, match="do not cover"):
        pa.paged_attention(tq, kv._replace(pos=kv.pos[:-1]))
    assert kv.shape == (16, W * PS)


def test_attention_plans_resolve_the_kernel_on_the_card_only():
    shape = (8 * 16, 128, 512)
    on_card = plan_matmul(shape, platform="cuda", op="attention",
                          kv_layout="paged")
    assert on_card.backend == "paged_attn" and on_card.kv_layout == "paged"
    on_cpu = plan_matmul(shape, platform="cpu", op="attention",
                         kv_layout="paged")
    assert on_cpu.backend == "paged_attn_torch"
    named = plan_matmul(shape, platform="cuda", op="attention",
                        kv_layout="paged", backend="paged_attn_torch")
    assert named.backend == "paged_attn_torch"
    with pytest.raises(ValueError, match="no registered backend"):
        plan_matmul(shape, platform="cuda", op="attention")   # dense
    with pytest.raises(ValueError, match="no registered backend"):
        plan_matmul(shape, platform="cuda", op="attention",
                    kv_layout="paged", domain="int8")
    with pytest.raises(ValueError, match="does not support platform"):
        plan_matmul(shape, platform="cpu", op="attention",
                    kv_layout="paged", backend="paged_attn")
    # the matmul backends serve both layouts
    assert resolve_backend("ternary", platform="cuda",
                           kv_layout="paged").name == "cuda"
    with pytest.raises(ValueError, match="unknown kv layout"):
        resolve_backend("ternary", platform="cuda", kv_layout="ragged")

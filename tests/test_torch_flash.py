"""The port's long-prompt attention against the JAX reference, on the CPU:
``flash_attention`` (the flash recurrence over KV chunks) and ``attend``
(direct masked attention up to 2048 positions, flash above), with dense
and paged (``PagedKV``) operands, and the smoke internlm2 model with a
2100-token prompt.

Bars: flash_attention within 1e-5 of the reference's in f32; attend on
paged views bitwise equal to attend on dense K/V; the smoke model those
of ``tests/test_torch_model.py`` (f32 within 1e-4 and the same argmax,
bf16 within 10% of the logit scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import paged_kv as jpaged
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention, paged_kv, registry

jax.config.update("jax_platform_name", "cpu")

KVH, HD = 2, 16


def _cfgs(window=0):
    j = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                            dtype=jnp.float32, sliding_window=window)
    t = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                            dtype=torch.float32, sliding_window=window)
    return j, t


def _qkv(b, s, t, rep, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, KVH * rep, HD)).astype(np.float32)
    k = rng.standard_normal((b, t, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((b, t, KVH, HD)).astype(np.float32)
    return q, k, v


# (S, T, causal, q_offset, window); chunk 16, so T = 40 leaves a ragged
# last chunk and T = 48 none
FLASH_CASES = {
    "causal": (40, 40, True, 0, 0),
    "causal-whole-chunks": (48, 48, True, 0, 0),
    "not-causal": (24, 40, False, 0, 0),
    "q-offset": (8, 40, True, 32, 0),
    "window": (40, 40, True, 0, 10),
    "window-q-offset": (12, 40, True, 28, 7),
}


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(case, rep):
    s, t, causal, off, window = FLASH_CASES[case]
    jcfg, tcfg = _cfgs(window)
    q, k, v = _qkv(2, s, t, rep, seed=rep)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jcfg, causal=causal,
                                 q_offset=off, chunk=16)
    got = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tcfg,
        causal=causal, q_offset=off, chunk=16)
    assert got.shape == (2, s, KVH * rep * HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["causal", "not-causal", "window"])
def test_flash_attention_agrees_with_direct_attention(case):
    """The recurrence gives the direct masked attention's output (f32
    round-off), so the switch at the threshold changes nothing else."""
    s, t, causal, _, window = FLASH_CASES[case]
    _, tcfg = _cfgs(window)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, s, t, 2, seed=7))
    mask = attention.causal_mask(s, t, window) if causal else None
    direct = attention._gqa_attend(q, k, v, mask)
    flash = attention.flash_attention(q, k, v, tcfg, causal=causal, chunk=16)
    np.testing.assert_allclose(flash.numpy(), direct.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("s,t,off", [(40, 40, 0), (8, 40, 32), (8, 40, 0)])
def test_causal_mask_matches_reference(s, t, off):
    for window in (0, 5):
        want = np.asarray(jattn.causal_mask(s, t, window, off))
        got = attention.causal_mask(s, t, window, off).numpy()
        np.testing.assert_array_equal(got, want)


def test_attend_above_the_threshold_matches_reference():
    """2100 positions: both attend through flash (chunk 512, a ragged last
    chunk), the direct mask's offset asymmetry included."""
    jcfg, tcfg = _cfgs()
    q, k, v = _qkv(1, 2100, 2100, 2, seed=3)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg)
    got = attention.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _paged(b, t, ps, seed):
    """Dense k/v and the same rows scattered into a shuffled page pool."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, t, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((b, t, KVH, HD)).astype(np.float32)
    n = t // ps
    perm = rng.permutation(np.arange(1, 1 + b * n)).reshape(b, n)
    pool_k = np.zeros((1 + b * n, ps, KVH, HD), np.float32)
    pool_v = np.zeros_like(pool_k)
    for row in range(b):
        for j in range(n):
            pool_k[perm[row, j]] = k[row, j * ps:(j + 1) * ps]
            pool_v[perm[row, j]] = v[row, j * ps:(j + 1) * ps]
    return k, v, pool_k, pool_v, perm.astype(np.int32)


@pytest.mark.parametrize("causal", [True, False])
def test_attend_accepts_paged_views_bitwise(causal):
    """attend and flash_attention on PagedKV views equal the dense
    operands' results bit for bit (the views are gathered first), and
    both agree with the reference's on the same views."""
    jcfg, tcfg = _cfgs()
    b, t, ps = 2, 32, 8
    k, v, pool_k, pool_v, perm = _paged(b, t, ps, seed=11)
    q = np.random.default_rng(12).standard_normal(
        (b, 4, KVH * 2, HD)).astype(np.float32)
    tq = torch.from_numpy(q)
    pk = paged_kv.PagedKV(torch.from_numpy(pool_k), torch.from_numpy(perm))
    pv = paged_kv.PagedKV(torch.from_numpy(pool_v), torch.from_numpy(perm))
    assert torch.equal(paged_kv.materialize(pk), torch.from_numpy(k))
    assert paged_kv.materialize(tq) is tq
    dk, dv = torch.from_numpy(k), torch.from_numpy(v)
    got = attention.attend(tq, pk, pv, tcfg, causal=causal, q_offset=28)
    dense = attention.attend(tq, dk, dv, tcfg, causal=causal, q_offset=28)
    assert torch.equal(got, dense)
    got_f = attention.flash_attention(tq, pk, pv, tcfg, causal=causal,
                                      q_offset=28, chunk=8)
    dense_f = attention.flash_attention(tq, dk, dv, tcfg, causal=causal,
                                        q_offset=28, chunk=8)
    assert torch.equal(got_f, dense_f)
    jpk = jpaged.PagedKV(jnp.asarray(pool_k), jnp.asarray(perm))
    jpv = jpaged.PagedKV(jnp.asarray(pool_v), jnp.asarray(perm))
    want = jattn.attend(jnp.asarray(q), jpk, jpv, jcfg, causal=causal,
                        q_offset=28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    want_f = jattn.flash_attention(jnp.asarray(q), jpk, jpv, jcfg,
                                   causal=causal, q_offset=28, chunk=8)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)


LONG, LONG_CAP, LONG_STEPS = 2100, 2112, 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_long_prompt_smoke_model_matches_reference(dtype):
    """internlm2-smoke with a 2100-token prompt: the prefill takes the
    flash path in both packages, then two decode steps read the cache."""
    jcfg = jconfigs.smoke("internlm2-1.8b")
    tcfg = configs.smoke("internlm2-1.8b")
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 512, size=(1, LONG)).astype(np.int32)
    feed = rng.integers(0, 512, size=(LONG_STEPS, 1, 1)).astype(np.int32)
    jl, jstate = jax.jit(jm.prefill, static_argnums=(2,))(
        jparams, {"tokens": jnp.asarray(prompt)}, LONG_CAP)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), LONG_CAP)
    pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
    jdecode = jax.jit(jm.decode)
    for tok in feed:
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate)
        pairs.append((np.asarray(jl.astype(jnp.float32)),
                      tl.float().numpy()))
    for want, got in pairs:
        assert got.shape == want.shape == (1, 1, 512)
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=0.1 * np.abs(want).max())
    assert tstate["pos"] == int(jstate["pos"]) == LONG + LONG_STEPS

"""The port's int8 KV caches against the JAX reference, on the CPU in f32
at smoke size, mirroring ``tests/test_int8_kv.py``: ``quantize_kv``
codes and scales bitwise; the cache's scale buffers allocated up front
(dense and paged); prefill and decode logits of internlm2, glm4 and
mixtral (whose cache rolls at its window of 16); the bucket engine, the
dense ``Scheduler`` and the gather ``PagedScheduler`` on the reference's
mixed-length trace; the fused read declined (``'auto'``) or refused
(``True``) for an int8 pool.

The reference's decode write is faulty (ROADMAP queue 3): it quantizes
the fresh k/v after casting them to the int8 cache dtype, which
truncates them, so each decoded position's codes hold the truncated
values (mostly zeros).  The port quantizes the k/v as computed.  So the
decode logits are held, step by step, to an oracle made of the
reference's own functions with that one cast removed (its read, its
``quantize_kv``, its layers): within 1e-4 of the logit scale and the same
argmax, the first step also to the reference's own decode (its read is
right, and no decoded position has been written yet).  The served tokens
are held to the oracle's greedy tokens.  The fault itself is pinned.
"""
import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro.models.layers import rms_norm as jrms_norm
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention, paged_kv, registry
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4             # logits, relative to max|logit|
CAP = 24
ARCHS = ("internlm2-1.8b", "glm4-9b", "mixtral-8x7b")


def test_quantize_kv_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # amax 0: the 1e-6 floor
    x[0, 0, 1] = 1e-8
    x[1, 2, 3, :4] = [127.0, 63.5, -0.5, 1.5]      # ties: half to even
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    tq, ts = attention.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # bf16 input: amax and the division in f32, as the reference's
    jb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    jq, js = jattn.quantize_kv(jb)
    tq, ts = attention.quantize_kv(tb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the round trip is within half a code step
    deq = tq.float() * ts[..., None]
    assert float(((deq - tb.float()).abs() / ts[..., None]).max()) \
        <= 0.5 + 1e-4


def test_int8_caches_allocate_their_scales_up_front():
    """The dense cache, ``attention.init_cache`` and the page pool: int8
    codes with per-(row, position, KV head) f32 scales, as the
    reference's ``cache_defs`` / ``init_cache`` / ``init_page_pool``."""
    cfg = dataclasses.replace(configs.get("qwen3-14b"),
                              kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jconfigs.get("qwen3-14b"),
                               kv_cache_dtype="int8")
    specs = registry.build(cfg).cache_specs(4, 128)
    jdefs = jregistry.build(jcfg).cache_defs(4, 128)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert specs[name].shape == jdefs[name].shape, name
        assert str(specs[name].dtype).split(".")[-1] == jnp.dtype(
            jdefs[name].dtype).name, name
    c = attention.init_cache(2, 16, 4, 8, kv_cache_dtype="int8",
                             device="cpu")
    assert c.k.dtype == c.v.dtype == torch.int8
    assert c.k_scale.shape == (2, 16, 4) and c.k_scale.dtype == torch.float32
    c = attention.init_cache(2, 16, 4, 8, device="cpu")
    assert c.k_scale is None and c.v_scale is None
    small = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                                kv_cache_dtype="int8")
    pool = paged_kv.init_page_pool(small, 5, 4, "cpu")
    assert pool.k_pages.dtype == torch.int8
    assert pool.k_scale_pages.shape == (2, 5, 4, 2)
    assert pool.page_bytes == 2 * (4 * 2 * 16 + 4 * 2 * 4) * 2
    with pytest.raises(ValueError, match="float-KV only"):
        paged_kv.raw_pool_view(pool)


# ------------------------------------------------------------ logits

@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32)
    j8 = jregistry.build(dataclasses.replace(jcfg, kv_cache_dtype="int8"))
    t8 = registry.build(dataclasses.replace(tcfg, kv_cache_dtype="int8"))
    jparams = jax.jit(jregistry.build(jcfg).init)(jax.random.key(4))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return j8, t8, registry.build(tcfg), jparams, tparams


def _oracle_decode(jm, params, token, state):
    """The reference's int8 decode with its write repaired: its layer
    scan, read and ``quantize_kv``, the code buffers handed to the read
    in the compute dtype (the same values), so that the fresh k/v come
    back as computed instead of cast to int8."""
    cfg = jm.cfg
    x = jnp.take(params["embed"], token, axis=0).astype(cfg.dtype)

    def body(x, inp):
        wl, k_l, v_l, ks_l, vs_l = inp
        cache = jattn.KVCache(k_l.astype(cfg.dtype), v_l.astype(cfg.dtype),
                              state["pos"], ks_l, vs_l)
        out, kt, vt = jattn.decode_attention_read(
            jrms_norm(x, wl["ln1"], cfg.norm_eps), wl, cfg, cache)
        x = x + out
        m, _ = jm._mlp(jrms_norm(x, wl["ln2"], cfg.norm_eps), wl, None)
        return x + m, (kt, vt)

    x, (kts, vts) = jax.lax.scan(body, x, (
        params["blocks"], state["k"], state["v"], state["k_scale"],
        state["v_scale"]))
    cap = state["k"].shape[2]
    pos = state["pos"]
    slot = pos % cap if cfg.sliding_window and cap == cfg.sliding_window \
        else pos
    zero = jnp.zeros((), jnp.int32)
    idx = (zero, zero, slot.astype(jnp.int32), zero, zero)
    new = dict(state, pos=pos + 1)
    for name, val in (("k", kts), ("v", vts)):
        q, sc = jattn.quantize_kv(val)
        new[name] = jax.lax.dynamic_update_slice(state[name], q, idx)
        new[name + "_scale"] = jax.lax.dynamic_update_slice(
            state[name + "_scale"], sc, idx[:-1])
    x = jrms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["unembed"], new


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    j8 = _setup(arch)[0]
    return (jax.jit(j8.prefill, static_argnums=(2,)), jax.jit(j8.decode),
            jax.jit(functools.partial(_oracle_decode, j8)))


def _hold_logits(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * scale, (what, err, scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _hold_codes(tstate, jstate, what):
    """Codes within one step of the reference's (a value one ulp from a
    rounding boundary moves a code), scales within f32 round-off."""
    for name in ("k", "v"):
        diff = np.abs(tstate[name].numpy().astype(np.int32)
                      - np.asarray(jstate[name]).astype(np.int32))
        assert diff.max() <= 1, (what, name)
        assert (diff > 0).mean() < 1e-3, (what, name)
        np.testing.assert_allclose(tstate[name + "_scale"].numpy(),
                                   np.asarray(jstate[name + "_scale"]),
                                   rtol=1e-5, atol=0, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_logits_match_reference(arch):
    """Prefill: the float-KV model's logits (the cache is built in the
    compute dtype, then quantized) and the reference's codes and scales.
    Decode (6 steps; mixtral's 12-token prompt crosses its window of 16
    at step 4, rolling the cache): each step's logits against the
    oracle's, the first against the reference's own decode too; and the
    int8 logits stay near the float-KV model's."""
    j8, t8, tfloat, jparams, tparams = _setup(arch)
    jprefill, jdecode, joracle = _jitted(arch)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP)
    tl, tstate = t8.prefill(tparams, torch.from_numpy(prompt), CAP)
    fl, fstate = tfloat.prefill(tparams, torch.from_numpy(prompt), CAP)
    assert tstate["k"].dtype == torch.int8
    assert torch.allclose(tl, fl, rtol=0, atol=1e-6)
    _hold_logits(tl, jl, "prefill")
    _hold_codes(tstate, jstate, "prefill")
    cap = tstate["k"].shape[2]
    assert cap == (16 if arch == "mixtral-8x7b" else CAP)
    for step in range(6):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        if step == 0:
            _hold_logits(t8.decode(tparams, torch.from_numpy(tok),
                                   {k: (v.clone() if torch.is_tensor(v)
                                        else v)
                                    for k, v in tstate.items()})[0],
                         jdecode(jparams, jnp.asarray(tok), jstate)[0],
                         "first step vs the reference's decode")
        jl, jstate = joracle(jparams, jnp.asarray(tok), jstate)
        tl, tstate = t8.decode(tparams, torch.from_numpy(tok), tstate)
        fl, fstate = tfloat.decode(tparams, torch.from_numpy(tok), fstate)
        _hold_logits(tl, jl, f"step {step}")
        _hold_codes(tstate, jstate, f"step {step}")
        # int8 quantization noise against the float cache (the
        # reference's own bars)
        denom = float(fl.abs().max())
        assert float((tl - fl).abs().max()) / denom < 0.25
        assert float((tl - fl).abs().mean()) / denom < 0.05
    assert tstate["pos"] == 18


def test_reference_decode_write_truncates_the_fresh_kv():
    """ROADMAP queue 3: the reference's decode returns the fresh k/v
    cast to the cache dtype, int8, and then quantizes those: the codes
    written for a decoded position are ``quantize_kv(int8(k))``.  The
    port writes ``quantize_kv(k)``."""
    j8, t8, _, jparams, tparams = _setup("internlm2-1.8b")
    jprefill, jdecode, joracle = _jitted("internlm2-1.8b")
    prompt = np.random.default_rng(5).integers(0, 512, size=(2, 12)).astype(
        np.int32)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP)
    tok = jnp.asarray(np.asarray(jl).argmax(-1).astype(np.int32))
    _, jfault = jdecode(jparams, tok, jstate)
    _, jright = joracle(jparams, tok, jstate)
    _, tstate = t8.prefill(tparams, torch.from_numpy(prompt), CAP)
    _, tstate = t8.decode(tparams, torch.tensor(np.asarray(tok)), tstate)
    fault = np.asarray(jfault["k"][:, :, 12])
    right = np.asarray(jright["k"][:, :, 12])
    # the truncated values are a few integers: mostly zero codes
    assert (fault == 0).mean() > 0.5 > (right == 0).mean()
    assert np.abs(tstate["k"][:, :, 12].numpy().astype(int)
                  - right.astype(int)).max() <= 1
    # every other slot is written alike
    np.testing.assert_array_equal(np.asarray(jfault["k"][:, :, :12]),
                                  np.asarray(jright["k"][:, :, :12]))


# ------------------------------------------------------------ serving

def _trace():
    """The reference test's mixed-length trace: prompts drawn from
    ``jax.random`` as it draws them, as numpy."""
    key = jax.random.key(1)
    return [(i, np.asarray(jax.random.randint(jax.random.fold_in(key, i),
                                              (plen,), 0, 512)), mn)
            for i, (plen, mn) in enumerate([(6, 4), (10, 6), (8, 3),
                                            (6, 5)])]


def _oracle_tokens(arch):
    """Greedy batch-1 decode of every request through the reference's
    prefill and the repaired decode."""
    _, _, _, jparams, _ = _setup(arch)
    jprefill, _, joracle = _jitted(arch)
    out = {}
    for uid, prompt, max_new in _trace():
        lg, st = jprefill(jparams, {"tokens": jnp.asarray(prompt)[None]}, 32)
        toks = [int(np.asarray(lg).argmax())]
        while len(toks) < max_new:
            lg, st = joracle(jparams, jnp.asarray([[toks[-1]]], jnp.int32),
                             st)
            toks.append(int(np.asarray(lg).argmax()))
        out[uid] = toks
    return out


def _serve(eng):
    for uid, prompt, max_new in _trace():
        eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


def test_int8_serving_on_the_mixed_length_trace():
    """The bucket engine (batch 1), the dense Scheduler (int8 code and
    f32 scale lanes on the slot axis) and the gather PagedScheduler
    (scale pages beside the code pages) give the oracle's tokens."""
    _, t8, _, _, tparams = _setup("internlm2-1.8b")
    want = _oracle_tokens("internlm2-1.8b")
    assert _serve(ServeEngine(t8, tparams, capacity=32, max_batch=1,
                              device="cpu")) == want
    dense = Scheduler(t8, tparams, capacity=32, slots=2, chunk=3,
                      device="cpu")
    assert dense.pool["k"].dtype == torch.int8
    assert dense.pool["k_scale"].shape[1] == 2            # slot axis
    assert _serve(dense) == want
    assert dense.host_transfers == dense.chunks_run
    cfg = t8.cfg
    assert dense.kv_bytes() == 2 * (cfg.num_layers * 2 * 32
                                    * cfg.num_kv_heads * (cfg.hd + 4))
    paged = PagedScheduler(t8, tparams, capacity=32, slots=2, chunk=3,
                           page_size=4, device="cpu")
    assert paged.pool.k_pages.dtype == torch.int8
    assert paged.pool.k_scale_pages is not None
    assert paged.attn_plan is None and paged.decode_per_slot
    assert _serve(paged) == want
    assert paged.host_transfers == paged.chunks_run


def test_fused_read_is_declined_or_refused_for_an_int8_pool(caplog):
    """'auto' serves an int8 pool through the gather path and logs why;
    fused_attn=True raises with the reference's reason; a float pool
    still resolves the fused read."""
    _, t8, tfloat, _, tparams = _setup("internlm2-1.8b")
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.engine"):
        eng = PagedScheduler(t8, tparams, capacity=32, slots=2, chunk=3,
                             page_size=4, fused_attn="auto", device="cpu")
    assert eng.attn_plan is None
    assert "int8 KV pool" in caplog.text
    with pytest.raises(ValueError, match="int8 KV pool"):
        PagedScheduler(t8, tparams, capacity=32, slots=2, chunk=3,
                       page_size=4, fused_attn=True, device="cpu")
    eng = PagedScheduler(tfloat, tparams, capacity=32, slots=2, chunk=3,
                         page_size=4, fused_attn="auto", device="cpu")
    assert eng.attn_plan is not None

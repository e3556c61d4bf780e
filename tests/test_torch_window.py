"""The port's sliding-window models against the JAX reference, on the
CPU at f32 smoke size: mixtral-smoke (window 16, 4 experts top-2) whose
cache, capped at the window, rolls (position p in slot p % 16).

Positions pass the window two ways: a 20-token prompt, whose prefill
keeps its last 16 positions rolled into place, and a 10-token prompt
that decodes across position 16; a third case caps the cache below the
window (12 slots), where it does not roll.  Held to the reference:
prefill and decode logits within 1e-4 and the same argmax, the rolled
k/v caches within 1e-5, the bucket engine's (host position) and the
dense ``Scheduler``'s (a device position per slot) tokens, and
device-fidelity serving through the ``Scheduler`` (served bytes after
drift and scrub, ADC clips, tokens).  A windowed model is refused by
the ``PagedScheduler`` and by ``--kv paged``, as in the reference.
Parameters come from the reference (``repro_torch.convert``), inputs
from numpy seeds; the reference runs its plain ``xla`` backend.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro import faults as jfaults
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs, faults
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.models import attention, registry
from repro_torch.models.layers import rms_norm
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

jax.config.update("jax_platform_name", "cpu")

ARCH = "mixtral-8x7b"
WINDOW = 16
LOGIT_TOL = 1e-4             # logits, absolute (f32)
CACHE_TOL = 1e-5             # k/v caches, absolute (f32)
YIELDS = (0.97, 0.995, 0.96)


@pytest.fixture(autouse=True)
def _restore_campaigns():
    jprev = jfaults.set_fault_model(jfaults.FaultModel())
    prev = faults.set_fault_model(faults.FaultModel())
    yield
    jfaults.set_fault_model(jprev)
    faults.set_fault_model(prev)


@functools.lru_cache(maxsize=None)
def _setup(weights, **over):
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(configs.smoke(ARCH), dtype=torch.float32,
                               **over)
    assert jcfg.sliding_window == tcfg.sliding_window
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    if weights != "float":
        cim = JCIMConfig(mode="ternary", packing=weights)
        jparams = jax.jit(lambda p: jternarize(p, cim))(jparams)
    return jm, tm, jparams, params_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(weights):
    jm = _setup(weights)[0]
    return (jax.jit(jm.prefill, static_argnums=(2,),
                    static_argnames=("cim",)),
            jax.jit(jm.decode, static_argnames=("cim",)))


def _cims(weights):
    if weights == "float":
        return None, None
    return (JCIMConfig(mode="ternary", packing=weights, backend="xla"),
            CIMConfig(mode="ternary", packing=weights))


# (prompt length, decode steps, capacity): a prompt past the window, a
# short prompt decoding across it, a cache capped below the window
CASES = {"long-prompt": (20, 3, 32), "decode-across": (10, 10, 32),
         "below-window": (8, 3, 12)}


@pytest.mark.parametrize("weights,case", [
    ("float", "long-prompt"), ("float", "decode-across"),
    ("base3", "long-prompt"), ("base3", "decode-across"),
    ("base3", "below-window")])
def test_window_logits_and_rolled_caches(weights, case):
    prompt_len, steps, capacity = CASES[case]
    _, tm, jparams, tparams = _setup(weights)
    jprefill, jdecode = _jitted(weights)
    jcim, tcim = _cims(weights)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, prompt_len)).astype(np.int32)
    feed = rng.integers(0, 512, size=(steps, 2, 1)).astype(np.int32)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)},
                          capacity, cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), capacity,
                            cim=tcim)
    cap = min(capacity, WINDOW)
    assert tstate["k"].shape == jstate["k"].shape == (2, 2, cap, 2, 16)
    assert attention.rolling(tm.cfg, cap) == (cap == WINDOW)

    def hold(jl, tl):
        want, got = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for name in ("k", "v"):        # the port writes its cache in place
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]), rtol=0,
                                       atol=CACHE_TOL)
    hold(jl, tl)
    for tok in feed:
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate, cim=jcim)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate,
                               cim=tcim)
        hold(jl, tl)
    assert tstate["pos"] == int(jstate["pos"]) == prompt_len + steps


def test_rolled_prefill_puts_each_position_at_its_slot():
    """After a 20-token prefill into a 16-slot rolling cache, slot j
    holds the k of the position p in 4..19 with p % 16 == j: the same
    values as a 32-slot cache of a windowless copy holds at p."""
    _, tm, _, tparams = _setup("float")
    _, tm_full, _, _ = _setup("float", sliding_window=0)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, size=(1, 20)).astype(np.int32))
    _, rolled = tm.prefill(tparams, prompt, 32)
    # the first layer's k does not depend on the attention mask
    full = tm_full.init_cache(1, 32, "cpu")
    x = tparams["embed"][prompt.long()]
    wl = {k: v[0] for k, v in tparams["blocks"].items()}
    attention.prefill_attention(
        rms_norm(x, wl["ln1"], tm.cfg.norm_eps), wl, tm_full.cfg,
        attention.KVCache(full["k"][0], full["v"][0], 0))
    for p in range(4, 20):
        assert torch.equal(rolled["k"][0, 0, p % WINDOW],
                           full["k"][0, 0, p])


def test_decode_with_device_positions_equals_host_positions():
    """decode at a (B,) device position per row (the Scheduler's pool)
    equals decode at a host position (the bucket engine's), across the
    window."""
    _, tm, _, tparams = _setup("base3")
    _, tcim = _cims("base3")
    rng = np.random.default_rng(8)
    prompt = torch.from_numpy(rng.integers(0, 512, size=(2, 12)).astype(
        np.int32))
    _, host = tm.prefill(tparams, prompt, 32, cim=tcim)
    dev = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in host.items()}
    dev["pos"] = torch.full((2,), host["pos"], dtype=torch.int32)
    for _ in range(8):
        tok = torch.from_numpy(rng.integers(0, 512, size=(2, 1)).astype(
            np.int32))
        lh, host = tm.decode(tparams, tok, host, cim=tcim)
        ld, dev = tm.decode(tparams, tok, dev, cim=tcim)
        assert torch.equal(lh, ld)
    assert torch.equal(host["k"], dev["k"])
    assert host["pos"] == 20 and dev["pos"].tolist() == [20, 20]


# ------------------------------------------------------------ serving

# (uid, prompt length, max_new): past the window, decoding across it,
# and one inside it
SPECS = [(0, 20, 6), (1, 10, 9), (2, 14, 5)]
# the device-fidelity run: two prompts of one length (one prefill
# compile in the reference) whose decode crosses position 16, in few
# chunks (every chunk drifts and probes the whole tree)
DEVICE_SPECS = [(0, 14, 4), (1, 14, 3)]


def _prompts(specs, seed=9):
    rng = np.random.default_rng(seed)
    return {uid: rng.integers(0, 512, size=n).astype(np.int32)
            for uid, n, _ in specs}


def _serve(eng, request_cls, specs=SPECS):
    prompts = _prompts(specs)
    for uid, _, max_new in specs:
        p = prompts[uid]
        eng.submit(request_cls(
            uid=uid, prompt=jnp.asarray(p) if request_cls is JRequest else p,
            max_new=max_new))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


def test_windowed_serving_matches_the_reference():
    """The bucket engine (one position for the batch, on the host) and
    the dense Scheduler (a device position per slot) roll the cache as
    the reference does; the pool is bounded by the window."""
    jm, tm, jparams, tparams = _setup("base3")
    jcim, cim = _cims("base3")
    want = _serve(JScheduler(jm, jparams, capacity=32, slots=2, chunk=3,
                             cim=jcim), JRequest)
    eng = Scheduler(tm, tparams, capacity=32, slots=2, chunk=3, cim=cim,
                    device="cpu")
    assert _serve(eng, Request) == want
    assert eng.host_transfers == eng.chunks_run
    assert eng.pool["k"].shape[2] == WINDOW
    assert eng.kv_bytes() == 2 * 2 * 2 * WINDOW * 2 * 16 * 4
    want_bucket = _serve(JServeEngine(jm, jparams, capacity=32, max_batch=1,
                                      cim=jcim), JRequest)
    got_bucket = _serve(ServeEngine(tm, tparams, capacity=32, max_batch=1,
                                    cim=cim, device="cpu"), Request)
    assert got_bucket == want_bucket == want


def test_sliding_window_models_reject_paged(capsys):
    """A rolling cache does not page: the PagedScheduler and the
    launcher's --kv paged refuse a windowed model (the reference's
    message); the same config without its window pages, with the dense
    pool's tokens."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch_serve
    _, tm, _, tparams = _setup("float")
    assert not tm.supports_paged_kv
    with pytest.raises(ValueError, match="does not support paged KV"):
        PagedScheduler(tm, tparams, capacity=32, slots=1, chunk=2,
                       device="cpu")
    argv = ["--arch", ARCH, "--smoke", "--continuous", "--kv", "paged",
            "--requests", "1", "--prompt-len", "8", "--max-new", "2",
            "--capacity", "32"]
    for main in (lambda a: launch_serve.main(a + ["--device", "cpu"]),
                 jlaunch.main):
        with pytest.raises(ValueError, match="does not support paged KV"):
            main(argv)
    _, tm2, _, tparams2 = _setup("float", sliding_window=0)
    assert tm2.supports_paged_kv
    got = _serve(PagedScheduler(tm2, tparams2, capacity=32, slots=2,
                                chunk=3, page_size=4, device="cpu"), Request)
    ref = _serve(Scheduler(tm2, tparams2, capacity=32, slots=2, chunk=3,
                           device="cpu"), Request)
    assert got == ref


def _packed_bytes_equal(jtree, ttree):
    jl = [x for x in jax.tree_util.tree_leaves(
        jtree, is_leaf=lambda x: isinstance(x, jops.PackedTernary))
        if isinstance(x, jops.PackedTernary)]
    tl = [leaf for _, leaf in faults.scrub.packed_leaves(ttree)]
    return len(jl) == len(tl) > 0 and all(
        np.array_equal(np.asarray(a.data), b.data.numpy())
        for a, b in zip(jl, tl))


def test_device_fidelity_serving_matches_the_reference():
    """--fidelity device through the Scheduler on mixtral-smoke: the
    first packed leaf is blocks/w1 (L, E, K, N), so the ADC probe takes
    its stacked branch; drift and scrub walk the 4-D expert leaves in
    the reference's draw blocks; the experts stay float-domain exact."""
    jm, tm, jparams, tparams = _setup("base3")
    fm = dict(seed=0, restore_yield=YIELDS, drift_rate=0.002)
    assert faults.scrub.packed_leaves(tparams)[0][0] == ("blocks", "w1")
    jfaults.set_fault_model(jfaults.FaultModel(**fm))
    js = JScheduler(jm, jparams, capacity=32, slots=2, chunk=2,
                    cim=JCIMConfig(mode="ternary", packing="base3",
                                   fidelity="device"), scrub_every=2)
    want = _serve(js, JRequest, DEVICE_SPECS)
    faults.set_fault_model(faults.FaultModel(**fm))
    s = Scheduler(tm, tparams, capacity=32, slots=2, chunk=2,
                  cim=CIMConfig(mode="ternary", packing="base3",
                                fidelity="device"), scrub_every=2,
                  device="cpu")
    assert _serve(s, Request, DEVICE_SPECS) == want
    assert s.cim.backend == "device" and s.decode_per_slot
    assert s.host_transfers == s.chunks_run == js.chunks_run
    assert s.scrubs_run == js.scrubs_run >= 1
    assert (s.adc_clip_lo, s.adc_clip_hi) == (js.adc_clip_lo,
                                              js.adc_clip_hi)
    assert _packed_bytes_equal(js.params, s.params)
    assert faults.packed_trit_error_rate(s.params, s._params_pristine) > 0

"""Macro-exact inference (``CIMConfig(mode="exact")``) of the port's
internlm2-smoke model against the JAX reference, on the CPU at f32, on
the same parameters (carried across by ``repro_torch.convert``) and the
same seeded tokens: every ``dense()`` goes through ``plan_matmul(op=
"cim")``, which encodes the activations and ternarizes the float weights
on every call.

The reference's exact plan runs its Pallas ``cim_mac`` kernel; here it
runs through that kernel's own oracle ``ref.cim_mac_ref`` (the kernel in
interpret mode compiles for a minute per model phase on this host).  The
two are equal at the model's 5-bit ADC, which
tests/test_torch_cim_mac.py holds for the port's plain version, the
oracle and the interpret-mode kernel, at the default blocks of the
reference's plan included.

Bars:

* logits of a prefill and two decode steps within 3% of the logit scale
  and the same argmax.  The MAC is bitwise (the per-layer test) but the
  activation codes are a per-tensor quantization, a step function: a
  one-ulp difference between XLA's CPU ``rsqrt`` and PyTorch's that lands
  on a rounding boundary moves one trit code, as in the int8 domain of
  tests/test_torch_model.py;
* the bucket ``ServeEngine`` gives the reference's greedy tokens, with
  one host transfer per bucket;
* the exact config routes through the cim plan in ``dense`` and resolves
  ``torch`` in the engine on the CPU.

The schedulers' exact-mode parity is in ``tests/test_torch_exact_sched.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.kernels import cim_mac as jcim_mac_module
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.kernels import cim_mac as cm
from repro_torch.models import layers, registry
from repro_torch.serve import Request, ServeEngine

jax.config.update("jax_platform_name", "cpu")

B, S, CAP, STEPS = 2, 8, 16, 2
LENGTHS, MAX_NEW = [6, 6, 6], [4, 3, 4]


@pytest.fixture(scope="module")
def reference():
    """The JAX side, computed once: logits of a prefill and two decode
    steps, and the tokens of a short bucket, in exact mode."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcim_mac_module, "cim_mac",
               lambda x, w, adc_bits, **_: jref.cim_mac_ref(x, w, adc_bits))
    try:
        jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                                   dtype=jnp.float32)
        jm = jregistry.build(jcfg)
        jparams = jax.jit(jm.init)(jax.random.key(2))
        cim = JCIMConfig(mode="exact")
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, 512, size=(B, S)).astype(np.int32)
        feed = rng.integers(0, 512, size=(STEPS, B, 1)).astype(np.int32)
        prefill = jax.jit(jm.prefill, static_argnums=(2,),
                          static_argnames=("cim",))
        decode = jax.jit(jm.decode, static_argnames=("cim",))
        lg, state = prefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP,
                            cim=cim)
        logits = [np.asarray(lg)]
        for tok in feed:
            lg, state = decode(jparams, jnp.asarray(tok), state, cim=cim)
            logits.append(np.asarray(lg))
        prompts = [rng.integers(0, 512, size=n).astype(np.int32)
                   for n in LENGTHS]
        eng = JServeEngine(jm, jparams, capacity=CAP, max_batch=4, cim=cim)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(uid=i, prompt=jnp.asarray(p),
                                max_new=MAX_NEW[i]))
        tokens = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    finally:
        mp.undo()
    return dict(params=jax.tree.map(np.asarray, jparams), prompt=prompt,
                feed=feed, logits=logits, prompts=prompts, tokens=tokens,
                transfers=eng.host_transfers)


def _port_model():
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    return registry.build(tcfg)


def test_exact_logits_match_the_reference(reference):
    tm = _port_model()
    params = params_from_reference(reference["params"], device="cpu")
    cim = CIMConfig(mode="exact")
    lg, state = tm.prefill(params, torch.from_numpy(reference["prompt"]),
                           CAP, cim=cim)
    got = [lg.numpy()]
    for tok in reference["feed"]:
        lg, state = tm.decode(params, torch.from_numpy(tok), state, cim=cim)
        got.append(lg.numpy())
    assert len(got) == len(reference["logits"]) == 1 + STEPS
    for want, g in zip(reference["logits"], got):
        assert g.shape == want.shape == (B, 1, 512)
        scale = np.abs(want).max()
        np.testing.assert_allclose(g, want, rtol=0, atol=0.03 * scale)
        np.testing.assert_array_equal(g.argmax(-1), want.argmax(-1))


def test_exact_bucket_tokens_match_the_reference(reference):
    tm = _port_model()
    params = params_from_reference(reference["params"], device="cpu")
    eng = ServeEngine(tm, params, capacity=CAP, max_batch=4,
                      cim=CIMConfig(mode="exact"), device="cpu")
    assert eng.cim.backend == "torch"
    for i, p in enumerate(reference["prompts"]):
        eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW[i]))
    got = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    assert got == reference["tokens"]
    assert eng.host_transfers == reference["transfers"] == 1


def test_dense_routes_an_exact_config_through_the_cim_plan(monkeypatch):
    calls = []
    real = cm.cim_mac_torch
    monkeypatch.setattr(cm, "cim_mac_torch",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.randn(3, 5, 64)
    w = torch.randn(64, 32) * 0.1
    y = layers.dense(x, w, CIMConfig(mode="exact").resolve("cpu"))
    assert y.shape == (3, 5, 32) and y.dtype == x.dtype
    assert calls == [(5, 15, 64)]
    ref_y = (x @ w).abs().max()
    assert float((y - x @ w).abs().max()) < 0.05 * float(ref_y)


def test_rows_as_calls_quantizes_each_row_alone():
    """Inside ``rows_as_calls`` an exact plan's rows equal one call per
    row, bitwise; outside, the rows share one scale."""
    from repro_torch.kernels.plan import rows_as_calls
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 1, 64, generator=gen) * torch.tensor(
        [1.0, 20.0, 0.05])[:, None, None]
    w = torch.randn(64, 32, generator=gen) * 0.1
    cim = CIMConfig(mode="exact").resolve("cpu")
    one_by_one = torch.cat([layers.dense(x[i:i + 1], w, cim)
                            for i in range(3)])
    with rows_as_calls():
        per_row = layers.dense(x, w, cim)
    assert torch.equal(per_row, one_by_one)
    assert not torch.equal(layers.dense(x, w, cim), one_by_one)

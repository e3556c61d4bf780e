"""The PyTorch port's internlm2-smoke model against the JAX reference:
prefill plus three decode steps on the same parameters (carried across by
``repro_torch.convert``) and the same seeded tokens, on the CPU.

The reference runs ``CIMConfig(mode="ternary", backend="xla")``, its own
plain path.  Cases: float weights packed on every call, base3- and
trit2-packed weights, each in the float and the int8 domain, plus plain
float mode.  Bars:

* f32, float domain: logits within 1e-4 and the same argmax.
* f32, int8 domain: logits within 3% of the logit scale and the same
  argmax.  The per-row int8 quantization of activations is a step
  function: XLA's CPU ``rsqrt`` and row sums differ from PyTorch's in the
  last bit, and a one-ulp difference that lands on a rounding boundary
  moves one int8 code by one, which every later layer carries.  The
  matmul itself is bitwise (tests/test_torch_ternary_matmul.py).
* bf16 (the default dtype): logits within 10% of the logit scale (bf16
  keeps 8 significant bits, and the two frameworks round at different
  places).
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
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.convert import params_from_reference, to_tensor
from repro_torch.core.cim_linear import CIMConfig, hbm_bytes, ternarize_params
from repro_torch.kernels.ops import PackedTernary
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

B, S, CAP, STEPS = 2, 8, 16, 3
CASES = [("float", None, None), ("float", "base3", "float"),
         ("float", "base3", "int8"), ("base3", "base3", "float"),
         ("base3", "base3", "int8"), ("trit2", "trit2", "float"),
         ("trit2", "trit2", "int8")]
CASE_IDS = [f"{w}-w_{p}-{d}" for w, p, d in CASES]


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg = jconfigs.smoke("internlm2-1.8b")
    tcfg = configs.smoke("internlm2-1.8b")
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jregistry.build(jcfg), registry.build(tcfg)


@functools.lru_cache(maxsize=None)
def _reference_params(dtype, weights):
    jm, _ = _models(dtype)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    if weights != "float":
        cim = JCIMConfig(mode="ternary", packing=weights)
        jparams = jax.jit(lambda p: jternarize(p, cim))(jparams)
    return jparams


@functools.lru_cache(maxsize=None)
def _jitted(dtype):
    jm, _ = _models(dtype)
    return (jax.jit(jm.prefill, static_argnums=(2,), static_argnames=("cim",)),
            jax.jit(jm.decode, static_argnames=("cim",)))


def _run_both(weights, packing, domain, dtype):
    _, tm = _models(dtype)
    jparams = _reference_params(dtype, weights)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    if packing is None:
        jcim = tcim = None
    else:
        jcim = JCIMConfig(mode="ternary", packing=packing, domain=domain,
                          backend="xla")
        tcim = CIMConfig(mode="ternary", packing=packing, domain=domain)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    feed = rng.integers(0, 512, size=(STEPS, B, 1)).astype(np.int32)

    jprefill, jdecode = _jitted(dtype)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP,
                          cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), CAP, cim=tcim)
    pairs = [(np.asarray(jl.astype(jnp.float32)), tl.float().numpy())]
    for tok in feed:
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate, cim=jcim)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate,
                               cim=tcim)
        pairs.append((np.asarray(jl.astype(jnp.float32)),
                      tl.float().numpy()))
    return pairs, jstate, tstate


@pytest.mark.parametrize("weights,packing,domain", CASES, ids=CASE_IDS)
def test_smoke_logits_match_reference_f32(weights, packing, domain):
    pairs, jstate, tstate = _run_both(weights, packing, domain, "f32")
    for want, got in pairs:
        assert got.shape == want.shape == (B, 1, 512)
        atol = 0.03 * np.abs(want).max() if domain == "int8" else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert tstate["pos"] == int(jstate["pos"]) == S + STEPS
    if domain != "int8":
        np.testing.assert_allclose(tstate["k"].numpy(),
                                   np.asarray(jstate["k"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("weights,packing,domain", CASES[::2],
                         ids=CASE_IDS[::2])
def test_smoke_logits_match_reference_bf16(weights, packing, domain):
    pairs, _, _ = _run_both(weights, packing, domain, "bf16")
    for want, got in pairs:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1 * scale)


def test_ternarize_params_packs_what_the_reference_packs():
    tparams = params_from_reference(
        jax.tree.map(np.asarray, _reference_params("f32", "float")),
        device="cpu")
    for packing in ("base3", "trit2"):
        jp = _reference_params("f32", packing)
        tp = ternarize_params(tparams, CIMConfig(mode="ternary",
                                                 packing=packing))
        for name in ("wq", "wo", "w1", "w2", "w3"):
            assert isinstance(tp["blocks"][name], PackedTernary)
            np.testing.assert_array_equal(tp["blocks"][name].data.numpy(),
                                          np.asarray(jp["blocks"][name].data))
        # SMOKE wk/wv are (2, 64, 32): min(64, 32) < 64, so they stay float
        assert not isinstance(tp["blocks"]["wk"], PackedTernary)
        assert isinstance(tp["unembed"], PackedTernary)
        assert not isinstance(tp["embed"], PackedTernary)
        from repro.core.cim_linear import hbm_bytes as jhbm
        assert hbm_bytes(tp) == jhbm(jp)


def test_init_follows_the_param_rules():
    _, tm = _models("f32")
    gen = torch.Generator().manual_seed(0)
    p = tm.init(gen, device="cpu")
    assert p["blocks"]["ln1"].shape == (2, 64)
    assert torch.equal(p["final_norm"], torch.ones(64))
    assert abs(p["embed"].std().item() - 1.0) < 0.05
    assert abs(p["blocks"]["w2"].std().item() * np.sqrt(128) - 1.0) < 0.05
    again = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["unembed"], again["unembed"])
    assert p["unembed"].shape == (64, 512)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tm.init(gen)


def test_attend_refuses_the_flash_range(monkeypatch):
    """attend no longer refuses the range past FLASH_THRESHOLD positions:
    there it dispatches to flash_attention, as the reference does, and up
    to it to the direct masked attention (tests/test_torch_flash.py holds
    both against the reference)."""
    from repro_torch.models import attention
    cfg = configs.smoke("internlm2-1.8b")
    calls = []
    flash = attention.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape[1])
        return flash(*args, **kwargs)
    monkeypatch.setattr(attention, "flash_attention", counted)
    for s in (attention.FLASH_THRESHOLD, attention.FLASH_THRESHOLD + 1):
        gen = torch.Generator().manual_seed(s)
        q = torch.randn(1, s, 4, 16, generator=gen)
        k = torch.randn(1, s, 2, 16, generator=gen)
        out = attention.attend(q, k, k, cfg)
        assert out.shape == (1, s, 64) and bool(torch.isfinite(out).all())
    assert calls == [attention.FLASH_THRESHOLD + 1]


def test_to_tensor_keeps_bf16_bits():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = to_tensor(x, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))

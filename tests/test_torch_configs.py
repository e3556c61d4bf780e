"""The port's three other dense configurations against the JAX reference:
glm4-9b (1 KV head at smoke size, 4 grouped queries), phi3-mini-3.8b (as
many KV heads as query heads) and qwen3-14b (qk-RMSNorm), each at its
SMOKE size: prefill plus three decode steps on the same parameters
(carried across by ``repro_torch.convert``) and the same seeded tokens,
on the CPU.  The reference runs ``CIMConfig(mode="ternary",
backend="xla")``, its own plain path.

Bars, those of ``tests/test_torch_model.py``: f32 float domain within
1e-4 and the same argmax; f32 int8 domain within 3% of the logit scale
and the same argmax; bf16 within 10% of the logit scale.

Also: the full-size configurations are the reference's field for field,
``ternarize_params`` packs what the reference packs (qwen3's q_norm /
k_norm stay float), and packing a stacked weight one layer at a time
gives the bytes and scales of packing it whole.
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
from repro.core.cim_linear import hbm_bytes as jhbm_bytes
from repro.core.cim_linear import ternarize_params as jternarize
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig, hbm_bytes, ternarize_params
from repro_torch.kernels import ops
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("glm4-9b", "phi3-mini-3.8b", "qwen3-14b")
B, S, CAP, STEPS = 2, 8, 16, 3
CASES = [("float", None, None), ("base3", "base3", "float"),
         ("base3", "base3", "int8")]
CASE_IDS = [f"{w}-w_{p}-{d}" for w, p, d in CASES]


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    jcfg, tcfg = jconfigs.smoke(arch), configs.smoke(arch)
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jregistry.build(jcfg), registry.build(tcfg)


@functools.lru_cache(maxsize=None)
def _reference_params(arch, dtype, weights):
    jm, _ = _models(arch, dtype)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    if weights != "float":
        cim = JCIMConfig(mode="ternary", packing=weights)
        jparams = jax.jit(lambda p: jternarize(p, cim))(jparams)
    return jparams


def _run_both(arch, weights, packing, domain, dtype):
    jm, tm = _models(arch, dtype)
    jparams = _reference_params(arch, dtype, weights)
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
    jprefill = jax.jit(jm.prefill, static_argnums=(2,),
                       static_argnames=("cim",))
    jdecode = jax.jit(jm.decode, static_argnames=("cim",))
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
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_match_reference_f32(arch, weights, packing, domain):
    pairs, jstate, tstate = _run_both(arch, weights, packing, domain, "f32")
    for want, got in pairs:
        assert got.shape == want.shape == (B, 1, 512)
        atol = 0.03 * np.abs(want).max() if domain == "int8" else 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert tstate["pos"] == int(jstate["pos"]) == S + STEPS
    if domain != "int8":
        np.testing.assert_allclose(tstate["k"].numpy(),
                                   np.asarray(jstate["k"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("weights,packing,domain", CASES[:2],
                         ids=CASE_IDS[:2])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_logits_match_reference_bf16(arch, weights, packing, domain):
    pairs, _, _ = _run_both(arch, weights, packing, domain, "bf16")
    for want, got in pairs:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1 * scale)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_copy_the_reference(arch):
    """Every field the port has holds the reference's value, at full size
    and at smoke size, for every ported architecture, ``remat`` included
    (the port leaves out the fields of the families it has not ported)."""
    for get in ("get", "smoke"):
        mine = getattr(configs, get)(arch)
        ref = getattr(jconfigs, get)(arch)
        for f in dataclasses.fields(mine):
            if f.name == "dtype":
                continue
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.hd == ref.hd and mine.padded_vocab == ref.padded_vocab
    assert arch in configs.ARCHS


def test_recurrent_configs_carry_the_assigned_values():
    """zamba2-7b and xlstm-125m hold the assigned hyperparameters of
    ``tests/test_archs.py`` (layers, width, heads, KV heads, d_ff,
    vocab; zamba2's SSM state), the reference's derived properties, and
    their models the reference's parameter counts."""
    table = {"zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
             "xlstm-125m": (12, 768, 4, 4, 0, 50304)}
    for arch, want in table.items():
        cfg, ref = configs.get(arch), jconfigs.get(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == want
        assert cfg.sub_quadratic and ref.sub_quadratic
        assert cfg.n_ssm_heads == ref.n_ssm_heads
        model = registry.build(cfg)
        assert model.param_bytes() == 2 * ref.param_count(), arch
    assert configs.get("zamba2-7b").ssm_state == 64
    assert configs.get("zamba2-7b").attn_every == 6
    assert not configs.get("internlm2-1.8b").sub_quadratic
    assert configs.get("mixtral-8x7b").sub_quadratic
    zamba = registry.build(configs.get("zamba2-7b"))
    assert (zamba.n_groups, zamba.n_tail) == (13, 3)
    assert type(zamba).__name__ == "ZambaModel"
    assert type(registry.build(configs.get("xlstm-125m"))).__name__ == \
        "XLSTMModel"


def test_cross_configs_carry_the_assigned_values():
    """whisper-large-v3 and llama-3.2-vision-90b hold the assigned
    hyperparameters of ``tests/test_archs.py`` (layers, width, heads, KV
    heads, d_ff, vocab) and their encoder and cross fields; their models
    are the reference's families with its parameter counts (the VLM's
    f32 gates take 4 bytes each), and at full size the default
    predicate would pack exactly the VLM's two stacked norms."""
    table = {"whisper-large-v3": (32, 1280, 20, 20, 5120, 51866),
             "llama-3.2-vision-90b": (100, 8192, 64, 8, 28672, 128256)}
    for arch, want in table.items():
        cfg, ref = configs.get(arch), jconfigs.get(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == want
        assert (cfg.encoder_layers, cfg.encoder_seq, cfg.cross_attn_every) \
            == (ref.encoder_layers, ref.encoder_seq, ref.cross_attn_every)
        model = registry.build(cfg)
        assert type(model).__name__ == type(jregistry.build(ref)).__name__
        gates = model.n_cross if cfg.cross_attn_every else 0
        assert model.param_bytes() == 2 * ref.param_count() + 2 * gates
    whisper = registry.build(configs.get("whisper-large-v3"))
    assert (whisper.cfg.encoder_layers, whisper.cfg.encoder_seq) == (32, 1500)
    assert whisper.packing_faults() == []
    vlm = registry.build(configs.get("llama-3.2-vision-90b"))
    assert (vlm.n_cross, vlm.cfg.encoder_seq) == (20, 1601)
    assert vlm.packing_faults() == ["blocks.ln1", "blocks.ln2"]


def test_qk_norm_params_follow_the_reference():
    """qwen3's per-layer q_norm / k_norm are (L, hd) ones, carried across
    as float, and both ternarize_params leave them float (min(L, hd) <
    64), as they leave the other leaves the reference leaves."""
    _, tm = _models("qwen3-14b", "f32")
    assert tm.param_specs["blocks"]["q_norm"].shape == (2, 16)
    jparams = _reference_params("qwen3-14b", "f32", "float")
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    for name in ("q_norm", "k_norm"):
        assert tparams["blocks"][name].dtype == torch.float32
        assert torch.equal(tparams["blocks"][name], torch.ones(2, 16))
    for packing in ("base3", "trit2"):
        jp = _reference_params("qwen3-14b", "f32", packing)
        tp = ternarize_params(tparams, CIMConfig(mode="ternary",
                                                 packing=packing))
        for name, leaf in tp["blocks"].items():
            want = jp["blocks"][name]
            packed = isinstance(leaf, ops.PackedTernary)
            assert packed == hasattr(want, "mode"), name
            if packed:
                np.testing.assert_array_equal(leaf.data.numpy(),
                                              np.asarray(want.data))
                # base3's amax / 127 may round differently in XLA
                np.testing.assert_allclose(leaf.scale.numpy(),
                                           np.asarray(want.scale),
                                           rtol=1e-6, atol=0)
        assert not isinstance(tp["blocks"]["q_norm"], ops.PackedTernary)
        assert isinstance(tp["unembed"], ops.PackedTernary)
        assert hbm_bytes(tp) == jhbm_bytes(jp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["base3", "trit2"])
def test_stacked_packing_per_layer_equals_whole(mode, dtype):
    """pack_weights packs a stacked weight one (K, N) matrix at a time;
    the bytes and scales equal packing the whole stack in one go (every
    step is per column), K ragged for trit2's padding."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((3, 2, 130, 70), generator=gen).to(dtype)
    got = ops.pack_weights(w, mode)
    whole = ops._pack_matrix(w, mode)
    assert got.data.shape == whole.data.shape
    assert got.scale.shape == whole.scale.shape == (3, 2, 70)
    assert torch.equal(got.data, whole.data)
    assert torch.equal(got.scale, whole.scale)
    for i in range(3):
        one = ops.pack_weights(w[i, 1], mode)
        assert torch.equal(got[i].data[1], one.data)


@pytest.mark.parametrize("m,k,n", [(1024, 13696, 4096), (1024, 17408, 5120),
                                   (1024, 4096, 13696), (300, 8192, 2048),
                                   (9, 17408, 64)])
def test_float_mma_plan_bounds_the_accumulator_chain(m, k, n):
    """The float domain's mma plan splits K so that no accumulator chain
    covers more than MMA_FLOAT_CHAIN rows (glm4-9b's and qwen3-14b's w2),
    in whole 64-row stages that cover K; at K <= MMA_FLOAT_CHAIN it is
    the plan without the bound, and int8 never takes the bound."""
    from repro_torch.kernels import ternary_matmul as tm
    bm, splits, per = tm.mma_plan(m, k, n, 132, tm.MMA_FLOAT_CHAIN)
    assert per <= tm.MMA_FLOAT_CHAIN and per % tm.MMA_K_CHUNK == 0
    assert splits * per >= k > (splits - 1) * per
    free = tm.mma_plan(m, k, n, 132)
    if k <= tm.MMA_FLOAT_CHAIN:
        assert (bm, splits, per) == free
    else:
        assert splits >= -(-k // tm.MMA_FLOAT_CHAIN) and free[2] >= per

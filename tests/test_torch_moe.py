"""The port's MoE family against the JAX reference, on the CPU at f32
smoke size: ``moe_block`` on its own (float, base3 and trit2 experts;
capacity that binds, pad rows, a tie in the router's probabilities),
``ternarize_params`` and the per-layer packed init on MoE trees, kimi's
prefill and decode logits, and serving mixtral-smoke with its window
off (so that the paged pool takes it) through the bucket engine, the
dense ``Scheduler`` (each slot its own routing group), the
``PagedScheduler`` (gather: per slot; fused: one group) and the int8
domain, plus the launcher.  Parameters come from the reference
(``repro_torch.convert``); prompts from numpy seeds.

Bars: ``moe_block``'s y within 1e-5 of max|y| and aux within 1e-6
relative (f32 summation order only; the reference casts ``dec*scale``
before its einsum, the port's plain product applies the scale in the
same f32); logits within 1e-4 and the same argmax; served tokens equal.
The reference runs its plain ``xla`` matmul backend.  Sliding-window
serving is ``tests/test_torch_window.py``.
"""
import dataclasses
import functools
import logging
import math

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
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.serve import PagedScheduler as JPagedScheduler
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig, hbm_bytes, ternarize_params
from repro_torch.kernels import ops
from repro_torch.models import moe, registry
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

jax.config.update("jax_platform_name", "cpu")

Y_TOL = 1e-5                 # moe_block y, relative to max|y|
LOGIT_TOL = 1e-4             # logits, absolute (f32)
CAP = 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------ moe_block

def _block_case(case, weights, seed=0):
    """Router, experts and x for one moe_block case of mixtral-smoke's
    widths (d 64, f 128, 4 experts, top 2), in both packages."""
    cfg = configs.smoke("mixtral-8x7b")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    rng = np.random.default_rng(seed)
    b, s, group = (2, 20, 16) if case == "pad" else (2, 24, moe.MOE_GROUP)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / math.sqrt(d)).astype(np.float32)
    if case == "binding":
        # every token leans to expert 0: 48 assignments for 30 slots
        mu = rng.standard_normal(d).astype(np.float32)
        x += 2.0 * mu
        router[:, 0] += 2.0 * mu / float(mu @ mu)
    if case == "tie":
        router[:, 2] = router[:, 1]        # equal probabilities, always
    w = {"router": router,
         "w1": (rng.standard_normal((e, d, f)) / math.sqrt(d)),
         "w3": (rng.standard_normal((e, d, f)) / math.sqrt(d)),
         "w2": (rng.standard_normal((e, f, d)) / math.sqrt(f))}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    if weights != "float":
        jw = jternarize(jw, JCIMConfig(mode="ternary", packing=weights))
        assert hasattr(jw["w1"], "mode")
    tw = params_from_reference(_np(jw), device="cpu")
    return cfg, x, jw, tw, group


@pytest.mark.parametrize("case", ["binding", "pad", "tie"])
@pytest.mark.parametrize("weights", ["float", "base3", "trit2"])
def test_moe_block_matches_reference(weights, case):
    cfg, x, jw, tw, group = _block_case(case, weights)
    jcfg = dataclasses.replace(jconfigs.smoke("mixtral-8x7b"),
                               dtype=jnp.float32)
    want_y, want_aux = jmoe.moe_block(jnp.asarray(x), jw, jcfg,
                                      group_size=group)
    got_y, got_aux = moe.moe_block(torch.from_numpy(x), tw, cfg,
                                   group_size=group)
    want_y = np.asarray(want_y)
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0,
                               atol=Y_TOL * np.abs(want_y).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    if weights != "float":
        assert isinstance(tw["w1"], ops.PackedTernary)
        assert tw["w1"].data.shape[:1] == (cfg.num_experts,)
    t = x.shape[0] * x.shape[1]
    g = min(group, t)
    xg = torch.nn.functional.pad(torch.from_numpy(x).reshape(t, -1),
                                 (0, 0, 0, -t % g)).reshape(-1, g, x.shape[2])
    dispatch, _, _, _ = moe.route(xg, tw["router"], cfg, torch.float32)
    kept = int(dispatch.sum())
    if case == "binding":                   # capacity drops assignments
        assert dispatch.shape[-1] == 30 and kept < t * 2
    if case == "pad":                       # the 8 pad rows take slots
        rows = dispatch.reshape(xg.shape[0] * g, -1)
        assert xg.shape[0] * g - t == 8 and int(rows[t:].sum()) > 0


def test_top_k_ties_go_to_the_lower_expert_index():
    """With two experts' router columns equal, the choice order (and so
    the slot order and the dropped assignment) is jax.lax.top_k's."""
    cfg, x, jw, tw, _ = _block_case("tie", "float")
    xg = torch.from_numpy(x).reshape(1, -1, cfg.d_model)
    _, _, probs, onehot = moe.route(xg, tw["router"], cfg, torch.float32)
    assert bool((probs[..., 1] == probs[..., 2]).all())
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()),
                            cfg.experts_per_token)
    np.testing.assert_array_equal(onehot.argmax(-1).numpy(),
                                  np.asarray(want))
    assert bool((onehot.argmax(-1)[..., 0] != 2).all())


def test_expert_products_are_pinned_to_the_float_domain():
    """Whatever the config asks of the other weights (int8 domain,
    device fidelity, the macro-exact mode), a packed expert product is
    a float-domain ternary plan at exact fidelity, on the caller's
    backend when that is an exact one."""
    for cim in (None, CIMConfig(mode="ternary", domain="int8"),
                CIMConfig(mode="ternary", fidelity="device"),
                CIMConfig(mode="exact", backend="torch"),
                CIMConfig(mode="ternary", packing="trit2", backend="ref")):
        for packing in ("base3", "trit2"):
            got = moe.expert_cim(cim, packing)
            assert (got.mode, got.domain, got.fidelity, got.packing) == (
                "ternary", "float", "exact", packing)
            want = ("auto" if cim is None or cim.fidelity == "device"
                    else cim.backend)
            assert got.backend == want


# ------------------------------------------------- parameter trees

@functools.lru_cache(maxsize=None)
def _setup(arch, weights, **over):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32,
                               **over)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    if weights != "float":
        cim = JCIMConfig(mode="ternary", packing=weights)
        jparams = jax.jit(lambda p: jternarize(p, cim))(jparams)
    return jm, tm, jparams, params_from_reference(_np(jparams),
                                                  device="cpu")


@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_ternarize_params_packs_what_the_reference_packs(packing):
    """On mixtral-smoke the 4-D expert leaves' bytes and scales equal the
    reference's, the f32 router stays float, and the density is the
    reference's (kimi-smoke's experts, d_ff 32, stay float in both:
    ``test_kimi_smoke_logits_match_reference``)."""
    _, tm, jfloat, tfloat = _setup("mixtral-8x7b", "float")
    assert tm.param_specs["blocks"]["router"].dtype == torch.float32
    assert tfloat["blocks"]["router"].dtype == torch.float32
    jcim = JCIMConfig(mode="ternary", packing=packing)
    jp = jax.jit(lambda p: jternarize(p, jcim))(jfloat)
    tp = ternarize_params(tfloat, CIMConfig(mode="ternary",
                                            packing=packing))
    for name, leaf in tp["blocks"].items():
        want = jp["blocks"][name]
        packed = isinstance(leaf, ops.PackedTernary)
        assert packed == hasattr(want, "mode"), name
        if packed:
            np.testing.assert_array_equal(leaf.data.numpy(),
                                          np.asarray(want.data))
            np.testing.assert_allclose(leaf.scale.numpy(),
                                       np.asarray(want.scale),
                                       rtol=1e-6, atol=0)
    assert tp["blocks"]["router"].dtype == torch.float32
    assert tp["blocks"]["w1"].data.dim() == 4
    assert hbm_bytes(tp) == jhbm_bytes(jp)


def test_init_packed_packs_one_layer_at_a_time():
    """init_packed draws every leaf that ternarize_params packs one
    layer at a time (the rest whole, in param_specs order) and packs
    each layer: the same tree as packing those draws whole, and the same
    structure and density as ternarize_params(init(...))."""
    cfg = dataclasses.replace(configs.smoke("mixtral-8x7b"),
                              dtype=torch.float32)
    tm = registry.build(cfg)
    cim = CIMConfig(mode="ternary", packing="base3")
    got = tm.init_packed(torch.Generator().manual_seed(4), cim, device="cpu")
    gen = torch.Generator().manual_seed(4)

    def redraw(tree):
        out = {}
        for k, spec in tree.items():
            if isinstance(spec, dict):
                out[k] = redraw(spec)
            elif k in ("w1", "w2", "w3", "wq", "wk", "wv", "wo"):
                out[k] = torch.stack([
                    spec._replace(shape=spec.shape[1:]).initialize(
                        gen, "cpu", cfg.dtype)
                    for _ in range(spec.shape[0])])
            else:
                out[k] = spec.initialize(gen, "cpu", cfg.dtype)
        return out
    want = ternarize_params(redraw(tm.param_specs), cim)
    whole = ternarize_params(tm.init(torch.Generator().manual_seed(4),
                                     device="cpu"), cim)

    def same(a, b, values):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k], values)
        elif isinstance(a, ops.PackedTernary):
            assert a.data.shape == b.data.shape and a.mode == b.mode
            if values:
                assert torch.equal(a.data, b.data)
                assert torch.equal(a.scale, b.scale)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype
            if values:
                assert torch.equal(a, b)
    same(got, want, values=True)
    same(got, whole, values=False)
    assert hbm_bytes(got) == hbm_bytes(whole)
    assert tm.param_bytes() == hbm_bytes(tm.init(torch.Generator(),
                                                 device="cpu"))


# -------------------------------------------------------- logits

def _logits_pairs(arch, weights, prompt_len, steps, **over):
    jm, tm, jparams, tparams = _setup(arch, weights, **over)
    cim = None if weights == "float" else dict(mode="ternary",
                                               packing=weights)
    jcim = None if cim is None else JCIMConfig(**cim, backend="xla")
    tcim = None if cim is None else CIMConfig(**cim)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, prompt_len)).astype(np.int32)
    feed = rng.integers(0, 512, size=(steps, 2, 1)).astype(np.int32)
    jprefill = jax.jit(jm.prefill, static_argnums=(2,),
                       static_argnames=("cim",))
    jdecode = jax.jit(jm.decode, static_argnames=("cim",))
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP,
                          cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), CAP, cim=tcim)
    pairs = [(np.asarray(jl), tl.numpy())]
    for tok in feed:
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate, cim=jcim)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate,
                               cim=tcim)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs, jstate, tstate


def _hold_logits(pairs):
    for want, got in pairs:
        assert got.shape == want.shape == (2, 1, 512)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("weights", ["float", "base3"])
def test_kimi_smoke_logits_match_reference(weights):
    """kimi-smoke's experts (d_ff 32) are under the 64 rows and columns
    both packing predicates ask, so they stay float under base3 too."""
    _, _, jparams, tparams = _setup("kimi-k2-1t-a32b", weights)
    assert not hasattr(jparams["blocks"]["w1"], "mode")
    assert not isinstance(tparams["blocks"]["w1"], ops.PackedTernary)
    assert isinstance(tparams["blocks"]["wq"], ops.PackedTernary) == (
        weights == "base3")
    pairs, jstate, tstate = _logits_pairs("kimi-k2-1t-a32b", weights, 8, 3)
    _hold_logits(pairs)
    assert tstate["pos"] == int(jstate["pos"]) == 11
    np.testing.assert_allclose(tstate["k"].numpy(), np.asarray(jstate["k"]),
                               rtol=0, atol=1e-5)


# ------------------------------------------------------------ serving

SPECS = [(0, 8, 5), (1, 12, 3), (2, 6, 6), (3, 9, 4)]


def _prompts(specs, seed=9):
    rng = np.random.default_rng(seed)
    return {uid: rng.integers(0, 512, size=n).astype(np.int32)
            for uid, n, _ in specs}


def _serve(eng, request_cls, specs, seed=9):
    prompts = _prompts(specs, seed)
    for uid, _, max_new in specs:
        p = prompts[uid]
        eng.submit(request_cls(
            uid=uid, prompt=jnp.asarray(p) if request_cls is JRequest else p,
            max_new=max_new))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


def _cims(domain="float"):
    return (JCIMConfig(mode="ternary", packing="base3", domain=domain,
                       backend="xla"),
            CIMConfig(mode="ternary", packing="base3", domain=domain))


@pytest.mark.parametrize("domain", ["float", "int8"])
def test_bucket_engine_tokens_match_reference(domain):
    """The bucket's batch is one routing group; under the int8 domain
    the attention and unembedding run int8 and the experts float."""
    jm, tm, jparams, tparams = _setup("mixtral-8x7b", "base3",
                                      sliding_window=0)
    jcim, cim = _cims(domain)
    specs = [(0, 7, 5), (1, 7, 4), (2, 7, 6)]
    want = _serve(JServeEngine(jm, jparams, capacity=CAP, max_batch=4,
                               cim=jcim), JRequest, specs)
    eng = ServeEngine(tm, tparams, capacity=CAP, max_batch=4, cim=cim,
                      device="cpu")
    assert _serve(eng, Request, specs) == want
    assert eng.host_transfers == 1


class _OneGroup(Scheduler):
    """A Scheduler that routes every slot's token in one group."""

    @property
    def decode_per_slot(self) -> bool:
        return False


def test_scheduler_routes_each_slot_as_its_own_group():
    """The reference vmaps a batch-1 decode over slots: each slot's
    token is its own group (capacity 1 per expert, nothing dropped).  A
    group of all 3 slots (capacity int(3*2*1.25/4) = 1) drops
    assignments that it keeps and changes the tokens."""
    jm, tm, jparams, tparams = _setup("mixtral-8x7b", "base3",
                                      sliding_window=0)
    jcim, cim = _cims()
    want = _serve(JScheduler(jm, jparams, capacity=CAP, slots=3, chunk=3,
                             cim=jcim), JRequest, SPECS)
    eng = Scheduler(tm, tparams, capacity=CAP, slots=3, chunk=3, cim=cim,
                    device="cpu")
    assert _serve(eng, Request, SPECS) == want
    assert eng.host_transfers == eng.chunks_run
    batched = _serve(_OneGroup(tm, tparams, capacity=CAP, slots=3, chunk=3,
                               cim=cim, device="cpu"), Request, SPECS)
    assert batched != want


@pytest.mark.parametrize("fused", [False, True])
def test_paged_scheduler_tokens_match_reference(fused):
    """Without its window mixtral pages: the gather read routes per
    slot (the reference vmaps it), the fused read routes every slot in
    one group (the reference's is one call)."""
    jm, tm, jparams, tparams = _setup("mixtral-8x7b", "base3",
                                      sliding_window=0)
    jcim, cim = _cims()
    js = JPagedScheduler(jm, jparams, capacity=CAP, slots=3, chunk=3,
                         page_size=4, cim=jcim, fused_attn=fused)
    want = _serve(js, JRequest, SPECS)
    eng = PagedScheduler(tm, tparams, capacity=CAP, slots=3, chunk=3,
                         page_size=4, cim=cim, fused_attn=fused,
                         device="cpu")
    assert (eng.attn_plan is not None) == fused == (js.attn_plan is not None)
    assert eng.decode_per_slot == (not fused)
    assert _serve(eng, Request, SPECS) == want
    assert eng.host_transfers == eng.chunks_run == js.chunks_run


def test_auto_declines_the_fused_read_under_moe(caplog):
    _, tm, _, tparams = _setup("kimi-k2-1t-a32b", "float")
    with caplog.at_level(logging.INFO, "repro_torch.serve.engine"):
        eng = PagedScheduler(tm, tparams, capacity=CAP, slots=2, chunk=3,
                             page_size=4, device="cpu")
    assert eng.attn_plan is None and eng.decode_per_slot
    assert any("MoE" in r.getMessage() for r in caplog.records)
    dense_cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                                    dtype=torch.float32)
    dense = registry.build(dense_cfg)
    eng = PagedScheduler(dense, dense.init(torch.Generator(), device="cpu"),
                         capacity=CAP, slots=2, chunk=3, page_size=4,
                         device="cpu")
    assert eng.attn_plan is not None


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("extra", [[], ["--continuous", "--slots", "2",
                                        "--chunk", "2"]])
def test_launcher_serves_mixtral_smoke(extra, capsys):
    """--arch mixtral-8x7b --smoke: the reference launcher's JSON fields
    and its request, token and step counts (the weights differ: each
    package draws its own)."""
    import json
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", "mixtral-8x7b", "--smoke", "--packed", "base3",
            "--requests", "3", "--prompt-len", "20", "--max-new", "5",
            "--capacity", "32"] + extra
    out = launch_serve.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jlaunch.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(out)
    for key in ("requests", "generated_tokens", "steps", "host_transfers",
                "decode_loop"):
        assert out[key] == want[key], key
    assert out["arch"] == "mixtral-smoke" and out["generated_tokens"] == 15
    if extra:
        assert out["chunks"] == want["chunks"] == out["host_transfers"]

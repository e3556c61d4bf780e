"""The port's recurrent families against the JAX reference, on the CPU in
f32 at smoke size: ``ZambaModel`` (zamba2-smoke with 7 Mamba2 layers, so
two shared-block invocations and a tail of one) and ``XLSTMModel``
(xlstm-smoke, two (mLSTM, sLSTM) pairs), with float weights and with
base3 and trit2 weights packed by the reference's ``ternarize_params``
and carried across by ``params_from_reference``.

Held to the reference: the prefill and 8 decode steps' logits within
1e-4 of the logit scale and the same argmax, with the carried states
within 1e-5 of their scale; the bucket engine's and the dense
``Scheduler``'s tokens on a trace whose third request enters a freed
slot (every slot at its own position: the shared block's per-slot KV
write); the
``PagedScheduler``'s and ``--kv paged``'s refusal, with the reference's
message; the launcher's counts at ``--smoke``.  Then the reference fault
of packing sLSTM's recurrent weight (ROADMAP queue 3): the reference
fails on it; the port names it and keeps it float (``pack_predicate``),
and serves the tree the launcher draws, with the reference's tokens.
The reference runs its plain ``xla`` matmul backend.
"""
import dataclasses
import functools
import json
import re

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
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.core.cim_linear import CIMConfig, ternarize_params
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4             # logits, relative to max|logit|
STATE_TOL = 1e-5             # carried states, relative to their max
CAP = 32
ARCHS = {"zamba": ("zamba2-7b", dict(num_layers=7)),
         "xlstm": ("xlstm-125m", {})}
STATES = {"zamba": ("h", "conv", "k", "v"),
          "xlstm": ("m_C", "m_n", "m_m", "s_c", "s_n", "s_m", "s_h")}


@functools.lru_cache(maxsize=None)
def _models(kind):
    """The reference and port models, and the reference's float draw,
    which every weight form of ``kind`` starts from."""
    arch, over = ARCHS[kind]
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32,
                               **over)
    jm = jregistry.build(jcfg)
    return jm, registry.build(tcfg), jax.jit(jm.init)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _setup(kind, weights):
    jm, tm, jparams = _models(kind)
    if weights != "float":
        jparams = jax.jit(lambda p: jternarize(
            p, JCIMConfig(mode="ternary", packing=weights)))(jparams)
    return jm, tm, jparams, params_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(kind, weights):
    jm = _setup(kind, weights)[0]
    return (jax.jit(jm.prefill, static_argnums=(2,),
                    static_argnames=("cim",)),
            jax.jit(jm.decode, static_argnames=("cim",)))


def _cims(weights):
    if weights == "float":
        return None, None
    return (JCIMConfig(mode="ternary", packing=weights, backend="xla"),
            CIMConfig(mode="ternary", packing=weights))


def test_shapes_of_the_smoke_models():
    """zamba2-smoke at 7 layers: two groups of 3 and a tail of 1; the
    trees and decode states have the reference's shapes."""
    for kind in ARCHS:
        jm, tm, jparams, tparams = _setup(kind, "float")
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        tflat = dict(_flat(tparams))
        assert len(jleaves) == len(tflat)
        for path, leaf in jleaves:
            key = tuple(p.key for p in path)
            assert tuple(tflat[key].shape) == leaf.shape, key
        jstate = jm.init_cache(2, CAP)
        tstate = tm.init_cache(2, CAP, "cpu")
        assert set(jstate) == set(tstate)
        for name in STATES[kind]:
            assert tuple(tstate[name].shape) == jstate[name].shape, name
            assert str(tstate[name].dtype).split(".")[-1] == str(
                jstate[name].dtype), name
    assert (_setup("zamba", "float")[1].n_groups,
            _setup("zamba", "float")[1].n_tail) == (2, 1)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("kind", list(ARCHS))
@pytest.mark.parametrize("weights", ["float", "base3", "trit2"])
def test_prefill_and_decode_logits_match_reference(kind, weights):
    jm, tm, jparams, tparams = _setup(kind, weights)
    jprefill, jdecode = _jitted(kind, weights)
    jcim, tcim = _cims(weights)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, CAP,
                          cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), CAP,
                            cim=tcim)

    def hold(jl, tl, what):
        want, got = np.asarray(jl), tl.numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale, what
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for name in STATES[kind]:      # the port updates state in place
            w = np.asarray(jstate[name])
            err = float(np.abs(tstate[name].numpy() - w).max())
            assert err <= STATE_TOL * max(float(np.abs(w).max()), 1e-30), \
                (what, name, err)
    hold(jl, tl, "prefill")
    for step in range(8):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate, cim=jcim)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate,
                               cim=tcim)
        hold(jl, tl, f"step {step}")
    assert tstate["pos"] == int(jstate["pos"]) == 20


def test_decode_with_device_positions_equals_host_positions():
    """decode at a (B,) device position (the Scheduler's pool) equals
    decode at a host position (the bucket engine's), rows at the same
    position; the shared block's KV write lands at each row's slot."""
    _, tm, _, tparams = _setup("zamba", "base3")
    _, tcim = _cims("base3")
    rng = np.random.default_rng(8)
    prompt = torch.from_numpy(rng.integers(0, 512, size=(2, 9)).astype(
        np.int32))
    _, host = tm.prefill(tparams, prompt, CAP, cim=tcim)
    dev = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in host.items()}
    dev["pos"] = torch.full((2,), host["pos"], dtype=torch.int32)
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, 512, size=(2, 1)).astype(
            np.int32))
        lh, host = tm.decode(tparams, tok, host, cim=tcim)
        ld, dev = tm.decode(tparams, tok, dev, cim=tcim)
        assert torch.equal(lh, ld)
    for name in STATES["zamba"]:
        assert torch.equal(host[name], dev[name]), name
    assert host["pos"] == 13 and dev["pos"].tolist() == [13, 13]


# ------------------------------------------------------------ serving

# (uid, prompt length, max_new): two buckets of max_batch 2; the third
# request enters the Scheduler's freed slot while the other slot is 3
# positions further on.  One prompt length: one reference prefill to
# compile
SPECS = [(0, 12, 6), (1, 12, 4), (2, 12, 7)]


def _serve(eng, request_cls):
    rng = np.random.default_rng(9)
    for uid, n, max_new in SPECS:
        p = rng.integers(0, 512, size=n).astype(np.int32)
        eng.submit(request_cls(
            uid=uid, prompt=jnp.asarray(p) if request_cls is JRequest else p,
            max_new=max_new))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.mark.parametrize("kind,weights", [
    ("zamba", "float"), ("zamba", "base3"), ("xlstm", "float"),
    ("xlstm", "trit2")])
def test_served_tokens_match_reference(kind, weights):
    """The bucket engine (batches of equal prompt length) and the dense
    Scheduler (2 slots at their own positions, chunks of 3) give the
    reference Scheduler's tokens (which its bucket engine gives too,
    ``tests/test_continuous.py``), with one transfer per bucket or
    chunk."""
    jm, tm, jparams, tparams = _setup(kind, weights)
    jcim, tcim = _cims(weights)
    want = _serve(JScheduler(jm, jparams, capacity=CAP, slots=2, chunk=3,
                             cim=jcim), JRequest)
    sched = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=3,
                      cim=tcim, device="cpu")
    assert _serve(sched, Request) == want
    assert sched.host_transfers == sched.chunks_run
    assert set(sched.pool) == set(STATES[kind])
    assert sched.kv_bytes() == sum(
        t.numel() * t.element_size() for t in sched.pool.values())
    bucket = ServeEngine(tm, tparams, capacity=CAP, max_batch=2, cim=tcim,
                         device="cpu")
    assert _serve(bucket, Request) == want
    assert bucket.host_transfers == 2                 # one per bucket


def test_paged_kv_is_refused_as_in_the_reference():
    """The reference's PagedScheduler message, from the port's
    PagedScheduler and its launcher's --kv paged."""
    from repro.serve import PagedScheduler as JPagedScheduler
    from repro_torch.launch import serve as launch_serve
    for kind in ARCHS:
        jm, tm, jparams, tparams = _setup(kind, "float")
        assert not tm.supports_paged_kv
        with pytest.raises(ValueError, match="does not support paged KV"):
            JPagedScheduler(jm, jparams, capacity=CAP, slots=1, chunk=2)
        with pytest.raises(ValueError, match="does not support paged KV"):
            PagedScheduler(tm, tparams, capacity=CAP, slots=1, chunk=2,
                           device="cpu")
        with pytest.raises(NotImplementedError, match="dense slot pool"):
            tm.decode_paged(tparams, None, None, None, None)
        argv = ["--arch", ARCHS[kind][0], "--smoke", "--continuous", "--kv",
                "paged", "--requests", "1", "--prompt-len", "8",
                "--max-new", "2", "--capacity", "32"]
        with pytest.raises(ValueError, match="does not support paged KV"):
            launch_serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("arch,extra", [
    ("zamba2-7b", []),
    ("xlstm-125m", ["--continuous", "--slots", "2", "--chunk", "2"])])
def test_launcher_serves_the_smoke_models(arch, extra, capsys):
    """--arch zamba2-7b / xlstm-125m --smoke: the reference launcher's
    JSON fields and its request, token and step counts (the weights
    differ: each package draws its own); then the port's --packed base3
    run, with the same counts."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--prompt-len",
            "10", "--max-new", "4", "--capacity", "32"] + extra
    out = launch_serve.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jlaunch.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(out)
    keys = ("requests", "generated_tokens", "steps", "host_transfers",
            "decode_loop")
    for key in keys:
        assert out[key] == want[key], key
    assert out["generated_tokens"] == 12
    if extra:
        assert out["chunks"] == want["chunks"] == out["host_transfers"]
    packed = launch_serve.main(argv + ["--device", "cpu", "--packed",
                                       "base3"])
    assert packed["packed"] == "base3"
    assert packed["weight_bytes_served"] < out["weight_bytes_served"]
    for key in keys:
        assert packed[key] == want[key], key


# ------------------------------------------------ the reference's fault

def _wide_xlstm(jax_side: bool):
    """xlstm-smoke widened to d_model 256 with 2 heads: sLSTM's head dim
    is 128, so the default predicate packs its (n, 2, 128, 512) wr."""
    mod = jconfigs if jax_side else configs
    dtype = jnp.float32 if jax_side else torch.float32
    return dataclasses.replace(mod.smoke("xlstm-125m"), d_model=256,
                               num_heads=2, num_kv_heads=2, dtype=dtype)


def test_reference_fails_on_a_packed_slstm_recurrent_weight():
    """ROADMAP queue 3: the reference's default ``ternarize_params``
    predicate packs sLSTM's recurrent ``wr`` once its trailing dims
    reach 64, and ``slstm_block`` then calls ``astype`` on it."""
    from repro.models import ssm as jssm
    cfg = _wide_xlstm(True)
    # one layer of the reference's sLSTM tree, seeded values of its shapes
    rng = np.random.default_rng(0)
    slstm = {k: jnp.asarray(0.02 * rng.standard_normal(d.shape),
                            jnp.float32)
             for k, d in jssm.slstm_defs(cfg, 1).items()}
    packed = jternarize({"wr": slstm["wr"]}, JCIMConfig(mode="ternary"))
    assert type(packed["wr"]).__name__ == "PackedTernary"
    slstm["wr"] = packed["wr"]
    layer = jax.tree.map(lambda a: a[0], slstm)
    with pytest.raises(AttributeError, match="astype"):
        jssm.slstm_block(jnp.zeros((1, 2, cfg.d_model), jnp.float32), layer,
                         cfg)


def test_port_refuses_the_packed_slstm_recurrent_weight_by_name(capsys):
    """The port's default predicate is the reference's
    (``ternarize_params`` packs the same wr), so serving such a tree
    would fail as the reference does.  The port refuses to pack it:
    ``packing_faults`` names it, the launcher's report names it on
    stderr and keeps it float, and the tree narrowed to the model's
    matmul weights (``pack_predicate``) serves, for the widened smoke
    and for xlstm-125m itself."""
    from repro_torch.launch import serve as launch_serve
    tm = registry.build(_wide_xlstm(False))
    assert tm.packing_faults() == ["slstm.wr"]
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    packed = ternarize_params(params, CIMConfig(mode="ternary"))
    assert isinstance(packed["slstm"]["wr"], ops.PackedTernary)
    assert launch_serve.report_packing_faults(tm, "base3") == ["slstm.wr"]
    assert re.search(r"keeping slstm\.wr .*float.*ROADMAP queue 3",
                     capsys.readouterr().err)
    served = ternarize_params(params, CIMConfig(mode="ternary"),
                              predicate=tm.pack_predicate)
    assert not isinstance(served["slstm"]["wr"], ops.PackedTernary)
    assert isinstance(served["slstm"]["wx"], ops.PackedTernary)
    logits, _ = tm.prefill(served, torch.zeros((1, 4), dtype=torch.int32),
                           8, cim=CIMConfig(mode="ternary"))
    assert bool(torch.isfinite(logits).all())
    full = registry.build(configs.get("xlstm-125m"))
    assert full.packing_faults() == ["slstm.wr"]
    # zamba2-7b at full depth: 81 stacked norms and biases reach 64 too
    assert "mamba_ln" in registry.build(
        configs.get("zamba2-7b")).packing_faults()


def _to_reference(tree):
    """The port's params (CPU tensors, packed leaves included) as the
    reference's tree: jax arrays and its ``PackedTernary``."""
    from repro.kernels.ops import PackedTernary as JPacked
    if isinstance(tree, dict):
        return {k: _to_reference(v) for k, v in tree.items()}
    if isinstance(tree, ops.PackedTernary):
        return JPacked(jnp.asarray(tree.data.numpy()),
                       jnp.asarray(tree.scale.numpy()), tree.mode)
    return jnp.asarray(tree.numpy())


def _narrowed(names):
    """The reference's default ``ternarize_params`` predicate narrowed to
    the leaves named `names`: what ``pack_predicate`` packs."""
    def pred(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        return (isinstance(x, jax.Array) and x.ndim in (2, 3, 4)
                and x.dtype in (jnp.float32, jnp.bfloat16)
                and min(x.shape[-2:]) >= 64
                and name not in ("embed", "router") and name in names)
    return pred


def test_launcher_tree_of_the_widened_xlstm_serves_as_the_reference():
    """The widened smoke drawn as the launcher draws it,
    ``init_packed(predicate=pack_predicate)``: wr stays float, every
    matmul weight is packed, and the dense Scheduler's tokens on it
    equal the reference Scheduler's on the same tree.  The same
    narrowing of the reference's predicate packs, from one float draw,
    the bytes and scales ``pack_predicate`` packs."""
    jcfg, tcfg = _wide_xlstm(True), _wide_xlstm(False)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    cim = CIMConfig(mode="ternary", packing="base3")
    tparams = tm.init_packed(torch.Generator().manual_seed(1), cim,
                             device="cpu", predicate=tm.pack_predicate)
    assert not isinstance(tparams["slstm"]["wr"], ops.PackedTernary)
    for group, names in registry.XLSTMModel.MATMULS.items():
        for name in names:
            if name != "wif":            # (d, 2 heads): under 64 wide
                assert isinstance(tparams[group][name], ops.PackedTernary)
    jcim = JCIMConfig(mode="ternary", packing="base3", backend="xla")
    want = _serve(JScheduler(jm, _to_reference(tparams), capacity=CAP,
                             slots=2, chunk=3, cim=jcim), JRequest)
    sched = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=3, cim=cim,
                      device="cpu")
    assert _serve(sched, Request) == want
    assert sched.host_transfers == sched.chunks_run
    matmuls = {n for names in registry.XLSTMModel.MATMULS.values()
               for n in names} | {"unembed"}
    jfloat = jax.jit(jm.init)(jax.random.key(2))
    jpacked = jternarize(jfloat, JCIMConfig(mode="ternary"),
                         predicate=_narrowed(matmuls))
    mine = ternarize_params(params_from_reference(
        jax.tree.map(np.asarray, jfloat), device="cpu"),
        CIMConfig(mode="ternary"), predicate=tm.pack_predicate)
    for path, leaf in _flat(mine):
        ref = functools.reduce(lambda t, k: t[k], path, jpacked)
        assert isinstance(leaf, ops.PackedTernary) == hasattr(ref, "mode"), \
            path
        if isinstance(leaf, ops.PackedTernary):
            np.testing.assert_array_equal(leaf.data.numpy(),
                                          np.asarray(ref.data))
            np.testing.assert_allclose(leaf.scale.numpy(),
                                       np.asarray(ref.scale), rtol=1e-6)


def test_launcher_packs_xlstm_125m_through_pack_predicate(monkeypatch,
                                                          capsys):
    """``--arch xlstm-125m --packed base3`` at full size: the launcher no
    longer refuses; it names ``slstm.wr`` and draws its tree through
    ``init_packed(predicate=model.pack_predicate)`` (stopped there: the
    draw and pack of 125M weights takes ~25 s on one CPU thread; the
    card serves it in chip_smoke.py)."""
    from repro_torch.launch import serve as launch_serve

    class Drawn(Exception):
        pass
    seen = {}

    def spy(self, generator, cim, device="cuda", dtype=None,
            predicate=None):
        seen.update(model=self, cim=cim, predicate=predicate)
        raise Drawn
    monkeypatch.setattr(registry.BaseModel, "init_packed", spy)
    with pytest.raises(Drawn):
        launch_serve.main(["--arch", "xlstm-125m", "--packed", "base3",
                           "--device", "cpu", "--requests", "1",
                           "--prompt-len", "4", "--max-new", "2"])
    model = seen["model"]
    assert model.cfg.name == "xlstm-125m"
    assert seen["predicate"] == model.pack_predicate
    assert seen["cim"].packing == "base3"
    assert "keeping slstm.wr of xlstm-125m float" in capsys.readouterr().err

"""The port's cross-attending VLM (``TransformerLM`` with
``cross_attn_every``, llama-vision-smoke: 4 layers, a gated cross block
after every 2, 16 patches) against the JAX reference, on the CPU in f32,
with float weights and with base3 and trit2 weights packed by the
reference's ``ternarize_params`` and carried across by
``params_from_reference``.  The patches are seeded N(0, 1) values.

Both packages initialize each cross block's f32 ``gate`` to zero, and
``tanh(0) = 0`` makes every cross block add nothing: at ``init`` the
logits ignore the patches in both, so a missing or wrong cross path
would pass any comparison made there.  That is pinned first; every
other check sets the gates to the same seeded nonzero values in both
packages.

Held to the reference: the prefill and 8 decode steps' logits within
1e-4 of the logit scale with the same argmax, the self and cross caches
within 1e-5 of theirs; logits that move with the patches; the bucket
engine's and the dense ``Scheduler``'s tokens equal the reference
Scheduler's with the same ``extra_inputs``; the ``PagedScheduler``'s and
``--kv paged``'s refusal, with the reference's message; the launcher's
counts at ``--smoke`` (zero patches).  Then the reference fault at 64
layers, where the default predicate packs the stacked norms (ROADMAP
queue 3): the reference fails, the port serves through
``pack_predicate`` with the tokens of the reference's narrowed
predicate.  The reference runs its plain ``xla`` matmul backend.
"""
import dataclasses
import functools
import json

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

ARCH = "llama-3.2-vision-90b"
LOGIT_TOL = 1e-4             # logits, relative to max|logit|
STATE_TOL = 1e-5             # caches, relative to their max
CAP = 32
STATES = ("k", "v", "xk", "xv")
MATMULS = set(registry.TransformerLM.MATMULS)


def _gated(jparams, seed=3):
    """The tree with every cross block's gate set to seeded nonzero
    values (f32, magnitudes 0.5-1.5, both signs)."""
    n = jparams["cross_blocks"]["gate"].shape
    rng = np.random.default_rng(seed)
    gate = rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)
    return {**jparams, "cross_blocks": {
        **jparams["cross_blocks"], "gate": jnp.asarray(gate, jnp.float32)}}


@functools.lru_cache(maxsize=None)
def _models(layers=None):
    over = {} if layers is None else dict(num_layers=layers)
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(configs.smoke(ARCH), dtype=torch.float32,
                               **over)
    jm = jregistry.build(jcfg)
    return jm, registry.build(tcfg), jax.jit(jm.init)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _setup(weights, gated=True):
    jm, tm, jparams = _models()
    if gated:
        jparams = _gated(jparams)
    if weights != "float":
        jparams = jax.jit(lambda p: jternarize(
            p, JCIMConfig(mode="ternary", packing=weights)))(jparams)
    return jm, tm, jparams, params_from_reference(
        jax.tree.map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(layers=None):
    jm = _models(layers)[0]
    return (jax.jit(jm.prefill, static_argnums=(2,),
                    static_argnames=("cim",)),
            jax.jit(jm.decode, static_argnames=("cim",)))


def _cims(weights):
    if weights == "float":
        return None, None
    return (JCIMConfig(mode="ternary", packing=weights, backend="xla"),
            CIMConfig(mode="ternary", packing=weights))


def _patches(seed, b=1):
    cfg = configs.smoke(ARCH)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _rel(want, got):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _prefill_both(weights, gated, patches, prompt):
    jm, tm, jparams, tparams = _setup(weights, gated)
    jcim, tcim = _cims(weights)
    jl, _ = _jitted()[0](jparams, {"tokens": jnp.asarray(prompt),
                                   "patches": jnp.asarray(patches)}, CAP,
                         cim=jcim)
    tl, _ = tm.prefill(tparams, torch.from_numpy(prompt), CAP, cim=tcim,
                       patches=torch.from_numpy(patches))
    return np.asarray(jl), tl.numpy()


def test_shapes_of_the_smoke_model():
    """The params tree (``cross_blocks`` with its f32 gate) and the
    decode state have the reference's shapes and dtypes, float and
    packed; the gate stays f32 through ``init``, ``init_packed`` and
    the carry-across."""
    jm, tm, jparams, tparams = _setup("trit2")
    jleaves = jax.tree_util.tree_leaves_with_path(
        jparams, is_leaf=lambda x: hasattr(x, "mode"))
    tflat = dict(_flat(tparams))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        key = tuple(p.key for p in path)
        assert isinstance(tflat[key], ops.PackedTernary) == \
            hasattr(leaf, "mode"), key
        assert tuple(tflat[key].shape) == tuple(leaf.shape), key
    assert set(tparams["cross_blocks"]) == {"ln", "gate", "wq", "wk", "wv",
                                            "wo"}
    assert tparams["cross_blocks"]["gate"].dtype == torch.float32
    gen = torch.Generator().manual_seed(0)
    for tree in (tm.init(gen, device="cpu"),
                 tm.init_packed(gen, CIMConfig(mode="ternary"), device="cpu",
                                predicate=tm.pack_predicate)):
        gate = tree["cross_blocks"]["gate"]
        assert gate.dtype == torch.float32 and not bool(gate.any())
    jstate = jm.init_cache(2, CAP)
    tstate = tm.init_cache(2, CAP, "cpu")
    assert set(jstate) == set(tstate)
    for name in STATES:
        assert tuple(tstate[name].shape) == jstate[name].shape, name
    assert tm.n_cross == 2 and not tm.supports_paged_kv
    assert tm.packing_faults() == []
    assert tm.matmul_leaf(("cross_blocks", "wk"))
    assert not tm.matmul_leaf(("cross_blocks", "gate"))


def test_zero_gates_ignore_patches_in_both_packages():
    """At ``init``'s zero gates the logits are the same for any patches,
    in the reference and in the port: comparisons made there cannot see
    the cross path."""
    prompt = np.random.default_rng(4).integers(0, 512, size=(1, 6)).astype(
        np.int32)
    ja, ta = _prefill_both("float", False, _patches(10), prompt)
    jb, tb = _prefill_both("float", False, _patches(11), prompt)
    np.testing.assert_array_equal(ja, jb)
    np.testing.assert_array_equal(ta, tb)
    assert _rel(ja, ta) <= LOGIT_TOL


@pytest.mark.parametrize("weights", ["float", "base3"])
def test_gated_logits_move_with_patches_as_the_reference(weights):
    """With seeded nonzero gates in both, two patches tensors give logits
    more than 1% of the scale apart, and each matches the reference."""
    prompt = np.random.default_rng(4).integers(0, 512, size=(1, 6)).astype(
        np.int32)
    ja, ta = _prefill_both(weights, True, _patches(10), prompt)
    jb, tb = _prefill_both(weights, True, _patches(11), prompt)
    assert _rel(ja, jb) > 0.01
    assert _rel(ta, tb) > 0.01
    assert _rel(ja, ta) <= LOGIT_TOL and _rel(jb, tb) <= LOGIT_TOL


@pytest.mark.parametrize("weights", ["float", "base3", "trit2"])
def test_prefill_and_decode_logits_match_reference(weights):
    jm, tm, jparams, tparams = _setup(weights)
    jprefill, jdecode = _jitted()
    jcim, tcim = _cims(weights)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    patches = _patches(2, b=2)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt),
                                    "patches": jnp.asarray(patches)}, CAP,
                          cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), CAP,
                            cim=tcim, patches=torch.from_numpy(patches))

    def hold(jl, tl, what):
        assert _rel(jl, tl.numpy()) <= LOGIT_TOL, what
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
        for name in STATES:
            assert _rel(jstate[name], tstate[name].numpy()) <= STATE_TOL, \
                (what, name)
    hold(jl, tl, "prefill")
    for step in range(8):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate, cim=jcim)
        tl, tstate = tm.decode(tparams, torch.from_numpy(tok), tstate,
                               cim=tcim)
        hold(jl, tl, f"step {step}")
    assert tstate["pos"] == int(jstate["pos"]) == 20


def test_inputs_are_checked_and_device_positions_equal_host_positions():
    """A VLM prefill without patches, or with frames, is refused; decode
    at a (B,) device position (the Scheduler's pool) equals decode at a
    host position (the bucket engine's)."""
    _, tm, _, tparams = _setup("base3")
    _, tcim = _cims("base3")
    rng = np.random.default_rng(8)
    prompt = torch.from_numpy(rng.integers(0, 512, size=(2, 9)).astype(
        np.int32))
    with pytest.raises(TypeError, match="patches"):
        tm.prefill(tparams, prompt, CAP)
    with pytest.raises(TypeError):
        tm.prefill(tparams, prompt, CAP, frames=torch.zeros(2, 16, 64))
    _, host = tm.prefill(tparams, prompt, CAP, cim=tcim,
                         patches=torch.from_numpy(_patches(5, b=2)))
    dev = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in host.items()}
    dev["pos"] = torch.full((2,), host["pos"], dtype=torch.int32)
    for _ in range(3):
        tok = torch.from_numpy(rng.integers(0, 512, size=(2, 1)).astype(
            np.int32))
        lh, host = tm.decode(tparams, tok, host, cim=tcim)
        ld, dev = tm.decode(tparams, tok, dev, cim=tcim)
        assert torch.equal(lh, ld)
    for name in STATES:
        assert torch.equal(host[name], dev[name]), name


# ------------------------------------------------------------ serving

# (uid, prompt length, max_new): two buckets of max_batch 2; the third
# request enters the Scheduler's freed slot
SPECS = [(0, 10, 6), (1, 10, 4), (2, 10, 7)]


def _serve(eng, request_cls):
    rng = np.random.default_rng(9)
    for uid, n, max_new in SPECS:
        p = rng.integers(0, 512, size=n).astype(np.int32)
        eng.submit(request_cls(
            uid=uid, prompt=jnp.asarray(p) if request_cls is JRequest else p,
            max_new=max_new))
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


@pytest.mark.parametrize("weights", ["float", "base3"])
def test_served_tokens_match_reference(weights):
    """One seeded patches tensor that ``extra_inputs`` expands to the
    batch, nonzero gates: the bucket engine and the dense Scheduler (2
    slots, chunks of 3) give the reference Scheduler's tokens, one
    transfer per bucket or chunk; the pool holds ``xk``/``xv`` lanes."""
    jm, tm, jparams, tparams = _setup(weights)
    jcim, tcim = _cims(weights)
    patches = _patches(6)[0]
    want = _serve(JScheduler(
        jm, jparams, capacity=CAP, slots=2, chunk=3, cim=jcim,
        extra_inputs={"patches": lambda b: jnp.broadcast_to(
            jnp.asarray(patches), (b,) + patches.shape)}), JRequest)
    extra = {"patches": lambda b: torch.from_numpy(patches).expand(
        (b,) + patches.shape)}
    sched = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=3,
                      cim=tcim, device="cpu", extra_inputs=extra)
    assert _serve(sched, Request) == want
    assert sched.host_transfers == sched.chunks_run
    assert set(sched.pool) == set(STATES)
    bucket = ServeEngine(tm, tparams, capacity=CAP, max_batch=2, cim=tcim,
                         device="cpu", extra_inputs=extra)
    assert _serve(bucket, Request) == want
    assert bucket.host_transfers == 2                 # one per bucket


def test_paged_kv_is_refused_as_in_the_reference():
    from repro.serve import PagedScheduler as JPagedScheduler
    from repro_torch.launch import serve as launch_serve
    jm, tm, jparams, tparams = _setup("float")
    with pytest.raises(ValueError, match="does not support paged KV") as je:
        JPagedScheduler(jm, jparams, capacity=CAP, slots=1, chunk=2)
    with pytest.raises(ValueError, match="does not support paged KV") as te:
        PagedScheduler(tm, tparams, capacity=CAP, slots=1, chunk=2,
                       device="cpu")
    assert str(je.value) == str(te.value)
    with pytest.raises(NotImplementedError, match="dense slot pool"):
        tm.decode_paged(tparams, None, None, None, None)
    with pytest.raises(ValueError, match="does not support paged KV"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--continuous",
                           "--kv", "paged", "--requests", "1",
                           "--prompt-len", "8", "--max-new", "2",
                           "--capacity", "32", "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--continuous", "--slots", "2",
                                        "--chunk", "2"]],
                         ids=["bucket", "continuous"])
def test_launcher_serves_the_smoke_model(extra, capsys):
    """--arch llama-3.2-vision-90b --smoke: the reference launcher's JSON
    fields and its request, token and step counts (zero patches; the
    weights differ: each package draws its own); then --packed trit2
    with the same counts."""
    from repro.launch import serve as jlaunch
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", ARCH, "--smoke", "--requests", "3", "--prompt-len",
            "8", "--max-new", "4", "--capacity", "32"] + extra
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
    packed = launch_serve.main(argv + ["--device", "cpu", "--packed",
                                       "trit2"])
    assert packed["weight_bytes_served"] < out["weight_bytes_served"]
    for key in keys:
        assert packed[key] == want[key], key


# ------------------------------------------------ the reference's fault

def _narrowed(path, x):
    """The reference's default ``ternarize_params`` predicate narrowed to
    the model's matmul weights: what ``pack_predicate`` packs."""
    name = str(getattr(path[-1], "key", path[-1]))
    return (isinstance(x, jax.Array) and x.ndim in (2, 3, 4)
            and x.dtype in (jnp.float32, jnp.bfloat16)
            and min(x.shape[-2:]) >= 64
            and name not in ("embed", "router") and name in MATMULS)


def test_64_layer_vlm_serves_where_the_reference_fails():
    """At 64 layers ``blocks.ln1``/``ln2`` are (64, 64): the default
    predicate packs them and the reference's prefill fails on the packed
    norm.  The port names them, keeps them float through
    ``pack_predicate`` (its launcher's path, ``init_packed``), and on the
    reference's draw gives the reference's greedy tokens under the
    narrowed predicate."""
    jm, tm, jfloat = _models(64)
    assert tm.packing_faults() == ["blocks.ln1", "blocks.ln2"]
    jfloat = _gated(jfloat)
    jcim = JCIMConfig(mode="ternary", packing="base3", backend="xla")
    prompt = np.random.default_rng(12).integers(0, 512, size=(2, 8)).astype(
        np.int32)
    patches = _patches(13)[0]
    batch = {"tokens": jnp.asarray(prompt), "patches": jnp.broadcast_to(
        jnp.asarray(patches), (2,) + patches.shape)}
    jprefill, jdecode = _jitted(64)
    broken = jternarize(jfloat, JCIMConfig(mode="ternary"))
    assert hasattr(broken["blocks"]["ln1"], "mode")
    with pytest.raises(TypeError, match="PackedTernary"):
        jprefill(broken, batch, CAP, cim=jcim)
    jparams = jternarize(jfloat, JCIMConfig(mode="ternary"),
                         predicate=_narrowed)
    jl, jstate = jprefill(jparams, batch, CAP, cim=jcim)
    want = [np.asarray(jl).argmax(-1)]
    for _ in range(3):
        jl, jstate = jdecode(jparams, jnp.asarray(want[-1], jnp.int32),
                             jstate, cim=jcim)
        want.append(np.asarray(jl).argmax(-1))
    want = np.concatenate(want, axis=1)
    tparams = ternarize_params(params_from_reference(
        jax.tree.map(np.asarray, jfloat), device="cpu"),
        CIMConfig(mode="ternary"), predicate=tm.pack_predicate)
    assert not isinstance(tparams["blocks"]["ln1"], ops.PackedTernary)
    eng = ServeEngine(tm, tparams, capacity=CAP, max_batch=2,
                      cim=CIMConfig(mode="ternary"), device="cpu",
                      extra_inputs={"patches": lambda b: torch.from_numpy(
                          patches).expand((b,) + patches.shape)})
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=prompt[uid], max_new=4))
    got = {r.uid: r.out_tokens for r in eng.run()}
    np.testing.assert_array_equal(np.array([got[0], got[1]]), want)
    drawn = tm.init_packed(torch.Generator().manual_seed(0),
                           CIMConfig(mode="ternary"), device="cpu",
                           predicate=tm.pack_predicate)
    assert not isinstance(drawn["blocks"]["ln1"], ops.PackedTernary)
    assert isinstance(drawn["blocks"]["w1"], ops.PackedTernary)
    assert isinstance(drawn["cross_blocks"]["wq"], ops.PackedTernary)

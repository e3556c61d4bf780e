"""The port's encoder-decoder (``EncDecModel``, whisper-smoke: 2 encoder
and 2 decoder layers, 32 frames) against the JAX reference, on the CPU
in f32, with float weights and with base3 and trit2 weights packed by
the reference's ``ternarize_params`` and carried across by
``params_from_reference``.  The frames are seeded N(0, 1) values.

Held to the reference: ``encode`` within 1e-5 of its scale; the prefill
and 8 decode steps' logits within 1e-4 of the logit scale with the same
argmax, and the self and cross caches within 1e-5 of theirs; the bucket
engine's and the dense ``Scheduler``'s tokens equal the reference
Scheduler's with the same ``extra_inputs``; the ``PagedScheduler``'s and
``--kv paged``'s refusal, with the reference's message; the launcher's
counts at ``--smoke`` (zero frames).  The reference runs its plain
``xla`` matmul backend.
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
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-large-v3"
LOGIT_TOL = 1e-4             # logits, relative to max|logit|
STATE_TOL = 1e-5             # caches and the encoder, relative to max
CAP = 32
STATES = ("k", "v", "xk", "xv")


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke(ARCH), dtype=torch.float32)
    jm = jregistry.build(jcfg)
    return jm, registry.build(tcfg), jax.jit(jm.init)(jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _setup(weights):
    jm, tm, jparams = _models()
    if weights != "float":
        jparams = jax.jit(lambda p: jternarize(
            p, JCIMConfig(mode="ternary", packing=weights)))(jparams)
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


def _frames(seed, b=1):
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


def test_shapes_of_the_smoke_model():
    """The params tree (encoder, decoder with its ``x_`` leaves, norms)
    and the decode state have the reference's shapes and dtypes; the
    packed leaves are the ones the reference packs."""
    jm, tm, jparams, tparams = _setup("base3")
    jleaves = jax.tree_util.tree_leaves_with_path(
        jparams, is_leaf=lambda x: hasattr(x, "mode"))
    tflat = dict(_flat(tparams))
    assert len(jleaves) == len(tflat)
    for path, leaf in jleaves:
        key = tuple(p.key for p in path)
        assert isinstance(tflat[key], ops.PackedTernary) == \
            hasattr(leaf, "mode"), key
        assert tuple(tflat[key].shape) == tuple(leaf.shape), key
    assert isinstance(tparams["dec_blocks"]["x_wk"], ops.PackedTernary)
    jstate = jm.init_cache(2, CAP)
    tstate = tm.init_cache(2, CAP, "cpu")
    assert set(jstate) == set(tstate)
    for name in STATES:
        assert tuple(tstate[name].shape) == jstate[name].shape, name
    assert type(tm).__name__ == "EncDecModel" and not tm.supports_paged_kv
    assert tm.packing_faults() == []
    assert tm.matmul_leaf(("dec_blocks", "x_wo"))
    assert not tm.matmul_leaf(("enc_norm",))


@pytest.mark.parametrize("weights", ["float", "base3"])
def test_encode_matches_reference(weights):
    jm, tm, jparams, tparams = _setup(weights)
    jcim, tcim = _cims(weights)
    frames = _frames(1, b=2)
    want = jax.jit(jm.encode, static_argnames=("cim",))(
        jparams, jnp.asarray(frames), cim=jcim)
    got = tm.encode(tparams, torch.from_numpy(frames), tcim)
    assert got.shape == (2, 32, 64)
    assert _rel(want, got.numpy()) <= STATE_TOL


@pytest.mark.parametrize("weights", ["float", "base3", "trit2"])
def test_prefill_and_decode_logits_match_reference(weights):
    jm, tm, jparams, tparams = _setup(weights)
    jprefill, jdecode = _jitted(weights)
    jcim, tcim = _cims(weights)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, size=(2, 12)).astype(np.int32)
    frames = _frames(2, b=2)
    jl, jstate = jprefill(jparams, {"tokens": jnp.asarray(prompt),
                                    "frames": jnp.asarray(frames)}, CAP,
                          cim=jcim)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(prompt), CAP,
                            cim=tcim, frames=torch.from_numpy(frames))

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


def test_logits_move_with_frames_and_inputs_are_checked():
    """whisper's logits depend on its frames (no gate hides them); a
    prefill without frames, or with a VLM's patches, is refused, and a
    decoder-only model refuses frames."""
    _, tm, _, tparams = _setup("float")
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    a, _ = tm.prefill(tparams, prompt, 8, frames=torch.from_numpy(
        _frames(3)))
    b, _ = tm.prefill(tparams, prompt, 8, frames=torch.from_numpy(
        _frames(4)))
    assert float((a - b).abs().max()) > 0.01 * float(a.abs().max())
    with pytest.raises(TypeError, match="frames"):
        tm.prefill(tparams, prompt, 8)
    with pytest.raises(TypeError):
        tm.prefill(tparams, prompt, 8, frames=torch.from_numpy(_frames(3)),
                   patches=torch.zeros(1, 16, 64))
    lm = registry.build(dataclasses.replace(
        configs.smoke("internlm2-1.8b"), dtype=torch.float32))
    lparams = lm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(TypeError):
        lm.prefill(lparams, prompt, 8, frames=torch.zeros(1, 32, 64))


def test_decode_with_device_positions_equals_host_positions():
    """decode at a (B,) device position (the Scheduler's pool) equals
    decode at a host position (the bucket engine's)."""
    _, tm, _, tparams = _setup("base3")
    _, tcim = _cims("base3")
    rng = np.random.default_rng(8)
    prompt = torch.from_numpy(rng.integers(0, 512, size=(2, 9)).astype(
        np.int32))
    _, host = tm.prefill(tparams, prompt, CAP, cim=tcim,
                         frames=torch.from_numpy(_frames(5, b=2)))
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
    """One seeded frames tensor that ``extra_inputs`` expands to the
    batch: the bucket engine and the dense Scheduler (2 slots, chunks of
    3) give the reference Scheduler's tokens, one transfer per bucket or
    chunk; the pool holds the cross keys and values as lanes."""
    jm, tm, jparams, tparams = _setup(weights)
    jcim, tcim = _cims(weights)
    frames = _frames(6)[0]
    want = _serve(JScheduler(
        jm, jparams, capacity=CAP, slots=2, chunk=3, cim=jcim,
        extra_inputs={"frames": lambda b: jnp.broadcast_to(
            jnp.asarray(frames), (b,) + frames.shape)}), JRequest)
    extra = {"frames": lambda b: torch.from_numpy(frames).expand(
        (b,) + frames.shape)}
    sched = Scheduler(tm, tparams, capacity=CAP, slots=2, chunk=3,
                      cim=tcim, device="cpu", extra_inputs=extra)
    assert _serve(sched, Request) == want
    assert sched.host_transfers == sched.chunks_run
    assert set(sched.pool) == set(STATES)
    assert sched.kv_bytes() == sum(
        t.numel() * t.element_size() for t in sched.pool.values())
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
    """--arch whisper-large-v3 --smoke: the reference launcher's JSON
    fields and its request, token and step counts (zero frames; the
    weights differ: each package draws its own); then --packed base3
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
                                       "base3"])
    assert packed["weight_bytes_served"] < out["weight_bytes_served"]
    assert packed["kept_float"] == []
    for key in keys:
        assert packed[key] == want[key], key

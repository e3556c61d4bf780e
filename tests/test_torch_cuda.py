"""The PyTorch port's CUDA kernels on the card, against their plain
versions on the same inputs.  Every test here is marked ``cuda`` and
skips with a reason on a machine without a CUDA device; this file
imports neither JAX nor the reference package, so on the card it runs
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: float domain within 1e-5 of max|y| for single matmuls and 1e-4 of
the logit scale for f32 smoke-model forwards (summation order only);
int8 domain bitwise for both; the bucket ServeEngine keeps one host
transfer per bucket.  The paged-attention kernel: ``m`` within
1e-5 * max(1, |m|), ``acc`` and ``l`` within 1e-4 of their per-row
maximum (the kernel sums page by page, the plain version in one pass),
each call through the load route ``load_route`` names, a second call
bitwise equal to the first (the cluster merges in rank order), and the
null page adds exactly nothing to a live slot.  The schedulers:
the fused read gives the gather's tokens, one host transfer per chunk.
The cim_mac kernels: bitwise equal to their plain version (the macro
model) at ragged shapes, every ADC width, planted saturating groups and
the all-saturating case, through both routes (``codes`` at 5 bits and
more, ``groups`` below) and both entries (trit planes and codes); the
int32 epilogue of both int8 ternary routes bitwise equal to the integer
product; and the smoke model's exact-mode logits bitwise equal between
the cuda and the plain torch backend, with each weight ternarized once;
in exact mode the dense Scheduler and the gather PagedScheduler give the
plain backend's tokens, and a batched decode inside ``rows_as_calls``
equals one call per slot, bitwise.
The threefry kernel: bits bitwise equal to the plain version on the CPU
for flat, strided and past-2^32 blocks; on the card, uniform, bernoulli
and randint bitwise equal to the CPU's and normal within 4 ulp (another
``log1p``); the device MAC bitwise equal to the CPU's with variation off;
disturb and scrub give the CPU's bytes; device-fidelity serving keeps one
transfer per chunk and serves the CPU run's weights.
MoE and the window: ``moe_block`` with base3 experts through the kernel
gives the plain version's output (f32 within 1e-4 of max|y|, bf16 within
2e-2), 3 x E launches a call on the route its rows take; mixtral-smoke's
rolling decode through the kernels gives the plain path's logits (1e-4
of their scale), caches and Scheduler tokens.
Int8 KV and the recurrent families: both ternary routes at zamba2's
Mamba2 shapes (N = 14576, a partial last column tile) and at xlstm's
wif (N = 8) as above; the Mamba2, mLSTM and sLSTM blocks on the card
against the CPU in f32 (1e-4 of the scale); the recurrent smoke models
through the kernels against the plain backend (1e-4) with equal engine
tokens; the int8 KV decode on the card against the CPU (codes within
one step, logits within 1e-4) with the dense and gather schedulers'
tokens equal.
Training (``-k train``): the data pipeline's card draws bitwise the CPU's
(``normal`` within 4 ulp); the embedding gradient bitwise repeatable on
the card and within 1e-6 of the CPU's; one AdamW step on the card
against the CPU (loss, grad norm, moments within 1e-4; updates within
1e-3 of lr but for 0.1% of the weights); the Trainer's replay after
crashes bitwise on the card; exact mode's cuda code route against the
torch route (1e-6; two steps 1e-5); ternary refused before any launch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, faults
from repro_torch.core import prng
from repro_torch.core.cim_linear import CIMConfig, ternarize_params
from repro_torch.core.ternary import from_balanced_ternary
from repro_torch.kernels import backends
from repro_torch.kernels import cim_mac as cm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.kernels import threefry
from repro_torch.models import registry
from repro_torch.serve import PagedScheduler, Request, Scheduler, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _operands(m, k, n, mode, seed):
    """Seeded x (M, K) f32, packed bytes and f32 column scales (K a
    multiple of 4)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    kw = k // 4 if mode == "trit2" else k
    data = rng.integers(0, 256 if mode == "trit2" else 243,
                        size=(kw, n)).astype(np.uint8)
    scale = (rng.uniform(0.5, 1.5, size=n) * 0.01).astype(np.float32)
    return x, data, scale


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1024), (300, 520, 130),
                                   (1, 64, 5), (3, 8192, 2050)])
def test_kernels_match_plain_versions_on_the_card(dev, mode, m, k, n):
    x, data, scale = _operands(m, k, n, mode, seed=m * k + n)
    xt, dt, st = (torch.from_numpy(a).to(dev) for a in (x, data, scale))
    w = ops.PackedTernary(dt, st, mode)
    before = dict(tm.LAUNCHES)
    want = ops.ternary_matmul_torch(xt, w)
    tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(tm.matmul_float(xt, dt, st, mode), want,
                               rtol=0, atol=tol)
    xb = xt.to(torch.bfloat16)
    torch.testing.assert_close(tm.matmul_float(xb, dt, st, mode),
                               ops.ternary_matmul_torch(xb, w),
                               rtol=0, atol=tol)
    xi, xs = ops.quantize_acts_int8(xt)
    assert torch.equal(tm.matmul_int8(xi, xs, dt, st, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    assert tm.LAUNCHES["ternary_matmul"] == before["ternary_matmul"] + 2
    assert (tm.LAUNCHES["ternary_matmul_int8"]
            == before["ternary_matmul_int8"] + 1)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", [(2048, 1024), (520, 130), (200, 136),
                                 (64, 5)])
@pytest.mark.parametrize("m", [9, 16, 17, 64, 127, 128, 129, 300, 1024])
def test_prefill_routes_match_plain_versions(dev, m, k, n, mode):
    """M > 8: bf16 and int8 x through the tensor-core route, f32 x
    through the CUDA-core route, at tile edges and ragged N and K."""
    x, data, scale = _operands(m, k, n, mode, seed=7 * m + k + n)
    xt, dt, st = (torch.from_numpy(a).to(dev) for a in (x, data, scale))
    w = ops.PackedTernary(dt, st, mode)
    before = dict(tm.ROUTES)
    xb = xt.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(tm.matmul_float(xb, dt, st, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(xt)
    assert torch.equal(tm.matmul_int8(xi, xs, dt, st, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    want = ops.ternary_matmul_torch(xt, w)
    torch.testing.assert_close(tm.matmul_float(xt, dt, st, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    assert tm.ROUTES["mma"] == before["mma"] + 2
    assert tm.ROUTES["cuda_core"] == before["cuda_core"] + 1
    assert tm.ROUTES["gemv"] == before["gemv"]


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", [(8192, 2048), (2048, 8192)])
@pytest.mark.parametrize("m", [128, 129, 300, 1024])
def test_prefill_route_full_width_shapes(dev, m, k, n, mode):
    """w2 (K = 8192) and w1 of the full-width model, through 128-row
    (M = 128) and 256-row tiles, split and unsplit: the tensor cores' f32
    sums stay within 1e-5 of max|y|, and int8 stays bitwise."""
    x, data, scale = _operands(m, k, n, mode, seed=m + k)
    xt, dt, st = (torch.from_numpy(a).to(dev) for a in (x, data, scale))
    w = ops.PackedTernary(dt, st, mode)
    xb = xt.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(tm.matmul_float(xb, dt, st, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(xt)
    assert torch.equal(tm.matmul_int8(xi, xs, dt, st, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", [(300, 2048, 1024), (1024, 8192, 2048),
                                   (129, 520, 130)])
@pytest.mark.parametrize("bm", [128, 256])
def test_mma_route_agrees_at_either_tile_height(dev, m, k, n, mode, bm):
    """launch_mma with a plan of either tile height (and its own split of
    K) gives the wrapper's answer: bitwise in int8, within 1e-5 of max|y|
    in the float domain; it counts no launch."""
    x, data, scale = _operands(m, k, n, mode, seed=m + n + bm)
    xt, dt, st = (torch.from_numpy(a).to(dev) for a in (x, data, scale))
    plan = tm.mma_tile_plan(m, k, n, tm._sm_count(xt.device), bm)
    xb = xt.to(torch.bfloat16)
    xi, xs = ops.quantize_acts_int8(xt)
    before = dict(tm.ROUTES)
    for xin, xsc, want in ((xb, None, tm.matmul_float(xb, dt, st, mode)),
                           (xi, xs, tm.matmul_int8(xi, xs, dt, st, mode))):
        out = torch.empty((m, n), device=dev)
        assert tm.launch_mma(xin, xsc, dt, st, mode, out, plan) == 0
        if xsc is None:
            torch.testing.assert_close(
                out, want, rtol=0, atol=1e-5 * want.abs().max().item())
        else:
            assert torch.equal(out, want)
    assert tm.ROUTES["mma"] == before["mma"] + 2


def test_ternary_launchers_refuse_a_route_they_do_not_serve(dev):
    """The gemv route's C launcher refuses M > 8 (the mma route's work)
    in either domain and f32 x (the CUDA-core route's) instead of
    running a kernel that does not serve it."""
    x, data, scale = _operands(16, 64, 128, "base3", seed=0)
    xt, dt, st = (torch.from_numpy(a).to(dev) for a in (x, data, scale))
    xi, xs = ops.quantize_acts_int8(xt)
    out = torch.empty((16, 128), device=dev)
    plan = (32, 1, 64)
    xb = xt.to(torch.bfloat16)
    assert tm.launch_gemv(xb, None, dt, st, "base3", out, plan) != 0
    assert tm.launch_gemv(xi, xs, dt, st, "base3", out, plan) != 0
    assert tm.launch_gemv(xt[:8], None, dt, st, "base3", out, plan) != 0
    assert tm.launch_gemv(xb[:9], None, dt, st, "base3", out, plan) != 0
    assert tm.launch_gemv(xb[:8], None, dt, st, "base3", out, plan) == 0


# every packed weight of internlm2-1.8b at full width (K, N): wq/wo,
# wk/wv, w1/w3, w2 and the unembedding (vocab padded to 92672)
MAIN_PATH_KN = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
                (2048, 92672)]


def _device_operands(dev, m, k, n, mode, seed):
    """Seeded x (M, K) f32, packed bytes and scales, made on the card
    (the unembedding's 190 MB would take long through numpy)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = k // 4 if mode == "trit2" else k
    data = torch.randint(0, 256 if mode == "trit2" else 243, (kw, n),
                         generator=gen, device=dev, dtype=torch.uint8)
    scale = (torch.rand(n, generator=gen, device=dev) + 0.5) * 0.01
    return torch.randn(m, k, generator=gen, device=dev), data, scale


def _gemv_matches(dev, x, data, scale, mode, place=lambda t: t):
    """bf16 and int8 x through the gemv route against the plain
    versions: within 1e-5 of max|y| in the float domain, bitwise in
    int8; each call one launch of the route.  ``place`` gives the
    kernel's copy of x and of the weight."""
    w = ops.PackedTernary(data, scale, mode)
    before = dict(tm.ROUTES)
    xb = x.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(
        tm.matmul_float(place(xb), place(data), scale, mode), want,
        rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(x)
    assert torch.equal(tm.matmul_int8(place(xi), xs, place(data), scale,
                                      mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    assert tm.ROUTES["gemv"] == before["gemv"] + 2
    assert tm.ROUTES["mma"] == before["mma"]
    assert tm.ROUTES["cuda_core"] == before["cuda_core"]


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_gemv_route_at_the_main_path_shapes(dev, m, k, n, mode):
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=m + k + n)
    _gemv_matches(dev, x, data, scale, mode)


# the other dense models' widest weights (K, N): glm4-9b's w1/w3 and w2
# (d_ff 13696 = 107 x 128) and qwen3-14b's w1/w3 and w2 (d_ff 17408)
OTHER_MODEL_KN = [(4096, 13696), (13696, 4096), (5120, 17408),
                  (17408, 5120)]


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", OTHER_MODEL_KN)
@pytest.mark.parametrize("m", [8, 1024])
def test_ternary_routes_at_the_other_models_shapes(dev, m, k, n, mode):
    """Decode (M = 8, the gemv route) and prefill (M = 1024, the mma
    route) at glm4-9b's and qwen3-14b's MLP shapes: float within 1e-5 of
    max|y| (K past MMA_FLOAT_CHAIN is split), int8 bitwise, each call
    through its route."""
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=m + k + n)
    if m <= 8:
        _gemv_matches(dev, x, data, scale, mode)
        return
    w = ops.PackedTernary(data, scale, mode)
    before = dict(tm.ROUTES)
    xb = x.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(tm.matmul_float(xb, data, scale, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(x)
    assert torch.equal(tm.matmul_int8(xi, xs, data, scale, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    assert tm.ROUTES["mma"] == before["mma"] + 2


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 5), (2, 200, 130), (4, 520, 2050), (5, 8192, 2050),
    (6, 2052, 136), (7, 4, 16), (8, 200, 2050), (8, 1028, 130)])
def test_gemv_route_ragged_edges(dev, m, k, n, mode):
    """M from 1 to 8, ragged N, K off the 64-row (base3) or 256-row
    (trit2) stage, and rows that are not 16-byte aligned (N % 16 != 0,
    or bf16 K % 8 != 0), which the kernel stages byte by byte."""
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=3 * k + n)
    _gemv_matches(dev, x, data, scale, mode)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", [
    (3, 200, 2064), (8, 520, 1040), (5, 2112, 144), (1, 8256, 2048),
    (8, 2048, 92688)])
def test_gemv_route_tma_edges(dev, m, k, n, mode):
    """16-byte aligned operands, so the TMA stages them: K off the stage,
    N off the column tile and M below 8 arrive as zeros from outside the
    tensor maps."""
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=k + n)
    assert tm._mma_vec(x.to(torch.bfloat16), data)
    _gemv_matches(dev, x, data, scale, mode)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
def test_gemv_route_unaligned_pointers(dev, mode):
    """Operands whose storage starts one element past a 16-byte
    boundary take the byte staging."""
    def off_by_one(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view
    x, data, scale = _device_operands(dev, 8, 2048, 1024, mode, seed=5)
    _gemv_matches(dev, x, data, scale, mode, place=off_by_one)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", [(8192, 2048), (2048, 1024), (520, 130)])
def test_gemv_route_float_is_deterministic(dev, k, n, mode):
    """The cluster adds its splits in rank order: two calls agree
    bitwise in the float domain."""
    x, data, scale = _device_operands(dev, 8, k, n, mode, seed=k)
    xb = x.to(torch.bfloat16)
    first = tm.matmul_float(xb, data, scale, mode)
    for _ in range(3):
        assert torch.equal(tm.matmul_float(xb, data, scale, mode), first)


def test_gemv_launcher_refuses_a_plan_it_does_not_take(dev, monkeypatch):
    """Block widths off {32, 64, 128}, clusters off {1, 2, 4, 8}, splits
    that are not whole stages or do not cover K: the C launcher refuses,
    and the wrapper raises instead of taking another route."""
    x, data, scale = _device_operands(dev, 8, 2048, 256, "base3", seed=7)
    xb = x.to(torch.bfloat16)
    out = torch.empty((8, 256), device=dev)
    for plan in ((48, 1, 2048), (32, 3, 704), (32, 16, 128), (32, 4, 96),
                 (32, 2, 512), (32, 1, 0)):
        assert tm.launch_gemv(xb, None, data, scale, "base3", out, plan) != 0
    assert tm.launch_gemv(xb, None, data, scale, "base3", out,
                          (32, 8, 256)) == 0
    monkeypatch.setattr(tm, "gemv_plan", lambda *a: (32, 2, 512))
    before = dict(tm.ROUTES)
    with pytest.raises(RuntimeError, match="gemv"):
        tm.matmul_float(xb, data, scale, "base3")
    assert tm.ROUTES == before


def _smoke(dev, packing):
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    return cfg, model, ternarize_params(
        params, CIMConfig(mode="ternary", packing=packing))


@pytest.mark.parametrize("domain", ["float", "int8"])
@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_smoke_model_cuda_backend_matches_plain_backend(dev, packing,
                                                        domain):
    cfg, model, params = _smoke(dev, packing)
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)),
                             device=dev)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(3, 2, 1)),
                           device=dev)
    logits = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing=packing, domain=domain,
                        backend=backend)
        lg, state = model.prefill(params, prompt, 16, cim=cim)
        steps = [lg]
        for tok in feed:
            lg, state = model.decode(params, tok, state, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
    got, want = logits["cuda"], logits["torch"]
    if domain == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("domain", ["float", "int8"])
@pytest.mark.parametrize("arch", ["glm4-9b", "phi3-mini-3.8b", "qwen3-14b"])
def test_other_smoke_models_cuda_backend_matches_plain_backend(dev, arch,
                                                               domain):
    """The three other dense models at smoke size (1 KV head, MHA,
    qk-RMSNorm), f32, base3 weights: a prefill and three decode steps
    through the kernels give the plain backend's logits (int8 bitwise,
    float to the summation order)."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32)
    model = registry.build(cfg)
    params = ternarize_params(
        model.init(torch.Generator(device=dev).manual_seed(0), device=dev),
        CIMConfig(mode="ternary", packing="base3"))
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)),
                             device=dev)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(3, 2, 1)),
                           device=dev)
    logits = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", domain=domain,
                        backend=backend)
        lg, state = model.prefill(params, prompt, 16, cim=cim)
        steps = [lg]
        for tok in feed:
            lg, state = model.decode(params, tok, state, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
    got, want = logits["cuda"], logits["torch"]
    if domain == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


def test_long_prompt_through_flash_on_the_card(dev):
    """A 2100-token prompt (past the 2048 of the direct attention) on the
    smoke model, f32, base3 weights: the prefill takes the flash
    recurrence on the card, and the cuda backend's logits over the
    prefill and two decode steps are the plain backend's (int8
    bitwise)."""
    cfg, model, params = _smoke(dev, "base3")
    rng = np.random.default_rng(8)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 2100)),
                             device=dev)
    logits = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", domain="int8",
                        backend=backend)
        lg, state = model.prefill(params, prompt, 2112, cim=cim)
        steps = [lg]
        for _ in range(2):
            lg, state = model.decode(params, lg[:, -1].argmax(
                -1, keepdim=True), state, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
    assert torch.equal(logits["cuda"], logits["torch"])
    assert state["pos"] == 2102


def test_serve_engine_on_the_card(dev):
    """Two prompt-length buckets in the int8 domain: the cuda backend
    gives the plain backend's tokens, through the kernel, with one host
    transfer per bucket."""
    cfg, model, params = _smoke(dev, "base3")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 7, 5, 7)]
    out = {}
    for backend in ("cuda", "torch"):
        eng = ServeEngine(model, params, capacity=16, max_batch=4,
                          cim=CIMConfig(mode="ternary", packing="base3",
                                        domain="int8", backend=backend),
                          device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=4 + i))
        tm.reset_launches()
        done = eng.run()
        assert eng.host_transfers == 2
        assert (tm.LAUNCHES["ternary_matmul_int8"] > 0) == (backend == "cuda")
        out[backend] = {r.uid: r.out_tokens for r in done}
    assert out["cuda"] == out["torch"]
    assert [len(out["cuda"][i]) for i in range(4)] == [4, 5, 6, 7]


def _paged_operands(dev, dtype, slots, kvh, rep, hd, ps, windows, pos,
                    seed):
    """q, a pool of pages in random order with garbage in the null page,
    tables covering each slot's live positions (the rest point at page
    0), and slot 2 (where there is one) sharing the last slot's first
    page."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + slots * windows
    q = rng.standard_normal((slots, kvh, rep, hd)) / np.sqrt(hd)
    k = rng.standard_normal((num_pages, ps, kvh, hd))
    v = rng.standard_normal((num_pages, ps, kvh, hd))
    k[0] = 3e4 * rng.choice([-1.0, 1.0], size=k[0].shape)
    v[0] = 3e4 * rng.choice([-1.0, 1.0], size=v[0].shape)
    ids = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((slots, windows), np.int32)
    for i, p in enumerate(pos):
        n = min(-(-p // ps), windows)
        table[i, :n] = ids[i * windows: i * windows + n]
    if slots > 2:
        table[2, 0] = table[-1, 0]
    t = lambda a, d: torch.as_tensor(a, dtype=d, device=dev)  # noqa: E731
    kv = pa.PagedAttentionKV(t(k, dtype), t(v, dtype),
                             t(table, torch.int32),
                             t(np.asarray(pos), torch.int32))
    return t(q, dtype), kv


def _close_stats(got, want):
    acc, m, l = got
    acc_r, m_r, l_r = want
    assert bool(((m - m_r).abs()
                 <= 1e-5 * m_r.abs().clamp(min=1.0)).all())
    assert bool(((l - l_r).abs() <= 1e-4 * l_r.abs()).all())
    scale = acc_r.abs().amax(dim=-1, keepdim=True)
    assert bool(((acc - acc_r).abs() <= 1e-4 * scale).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kvh,rep,hd,ps,windows,pos", [
    (8, 2, 128, 16, 32, [0, 1, 15, 16, 17, 511, 512, 700]),
    (2, 4, 64, 16, 8, [0, 5, 64, 128]),
    (3, 1, 40, 5, 7, [0, 1, 4, 5, 6, 34, 35]),
    (1, 8, 128, 1, 9, [0, 1, 8, 9]),
    # capacity 2048: 8 ranks of 16 windows
    (8, 2, 128, 16, 128, [0, 1, 17, 512, 1000, 1536, 2047, 2048]),
    # glm4-9b's grouping: 2 KV heads x 16 queries, two row groups
    (2, 16, 128, 16, 32, [0, 1, 15, 16, 17, 511, 512, 256]),
    # every slot inside rank 0's 4 windows: ranks 1-7 dead
    (8, 2, 128, 16, 32, [1, 5, 16, 17, 33, 64, 60, 2]),
    # rows of 40 bytes in bf16: the plain-loads route
    (2, 3, 20, 4, 6, [0, 3, 4, 5, 23, 24]),
    (1, 8, 256, 4, 2, [3]),                 # rep x hd = 2048 at hd 256
    # phi3-mini-3.8b's grouping: 32 KV heads x 1 query, hd 96
    (32, 1, 96, 16, 32, [0, 1, 15, 16, 17, 511, 512, 256]),
    # qwen3-14b's grouping: 8 KV heads x 5 queries
    (8, 5, 128, 16, 32, [0, 1, 15, 16, 17, 511, 512, 256]),
    # capacity 4096: 8 ranks of 32 windows
    (8, 2, 128, 16, 256, [0, 1, 17, 1000, 2048, 3000, 4095, 4096]),
])
def test_paged_attention_kernel_matches_plain_version(dev, dtype, kvh, rep,
                                                      hd, ps, windows, pos):
    q, kv = _paged_operands(dev, dtype, len(pos), kvh, rep, hd, ps, windows,
                            pos, seed=hd + ps)
    route = "tma" if hd * q.element_size() % 16 == 0 else "loads"
    assert pa.load_route(kv) == route
    before, routes = pa.LAUNCHES["paged_attention"], dict(pa.ROUTES)
    got = pa.paged_attention(q, kv)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] == before + 1
    assert pa.ROUTES[route] == routes[route] + 1
    _close_stats(got, pa.paged_attention_torch(q, kv))
    # the ranks' partials are merged in rank order: a second call agrees
    # bitwise
    for a, b in zip(got, pa.paged_attention(q, kv)):
        assert torch.equal(a, b)
    # the null page's garbage adds exactly nothing to a live slot
    clean = kv._replace(k_pages=kv.k_pages.clone(),
                        v_pages=kv.v_pages.clone())
    clean.k_pages[0] = 0
    clean.v_pages[0] = 0
    live = kv.pos > 0
    for a, b in zip(got, pa.paged_attention(q, clean)):
        assert torch.equal(a[live], b[live])


def test_paged_attention_takes_the_loads_route_off_16_byte_pages(dev):
    """Pools whose base is 2 bytes off a 16-byte boundary cannot feed the
    TMA: the same kernel copies their pages with plain loads, and agrees
    with the TMA route's result bitwise (the same arithmetic)."""
    q, kv = _paged_operands(dev, torch.bfloat16, 8, 8, 2, 128, 16, 32,
                            [0, 1, 15, 16, 17, 511, 512, 256], seed=4)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out
    off = kv._replace(k_pages=shifted(kv.k_pages),
                      v_pages=shifted(kv.v_pages))
    assert pa.load_route(kv) == "tma" and pa.load_route(off) == "loads"
    routes = dict(pa.ROUTES)
    want = pa.paged_attention(q, kv)
    got = pa.paged_attention(q, off)
    assert pa.ROUTES["tma"] == routes["tma"] + 1
    assert pa.ROUTES["loads"] == routes["loads"] + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_paged_plan_shared_bytes_match_the_kernel(dev):
    """The plan's shared bytes are the kernel's (``pa_smem_bytes``)."""
    lib = pa._lib()
    for shape in [(8, 8, 2, 128, 16, 32, 2), (8, 2, 16, 128, 16, 32, 2),
                  (8, 8, 2, 128, 16, 128, 4), (7, 3, 1, 40, 5, 7, 4),
                  (4, 1, 8, 128, 1, 9, 2), (2, 1, 64, 32, 64, 8, 4)]:
        plan = pa.paged_plan(*shape)
        rep, hd, ps, elem = shape[2], shape[3], shape[4], shape[6]
        assert lib.pa_smem_bytes(rep, hd, ps, plan.per_rank, plan.rows,
                                 plan.threads // 32, plan.stages,
                                 elem) == plan.smem


def test_paged_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, kv = _paged_operands(dev, torch.bfloat16, 2, 2, 2, 64, 4, 3, [1, 9],
                            seed=1)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kv._replace(pos=kv.pos.long()))
    with pytest.raises(TypeError, match="differ"):
        pa.paged_attention(q.float(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           kv)
    # a warp carries 8 grouped queries, a block 8 warps: rep <= 64
    many, kvm = _paged_operands(dev, torch.float32, 1, 1, 65, 16, 4, 2, [3],
                                seed=2)
    with pytest.raises(ValueError, match="grouped queries"):
        pa.paged_attention(many, kvm)
    wide, kvw = _paged_operands(dev, torch.float32, 1, 1, 1, 264, 4, 2, [3],
                                seed=2)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(wide, kvw)


def test_paged_schedulers_on_the_card(dev):
    """The smoke model, f32, base3 weights: the fused read (through the
    kernel, launched once per layer per decode step run) gives the
    gather's tokens, which are the dense scheduler's, one host transfer
    per chunk each."""
    cfg, model, params = _smoke(dev, "base3")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, size=8)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)])
               for n in (0, 3, 6, 9, 1)]
    cim = CIMConfig(mode="ternary", packing="base3")
    out = {}
    for name in ("dense", "gather", "fused"):
        if name == "dense":
            eng = Scheduler(model, params, capacity=32, slots=3, chunk=3,
                            cim=cim, device=dev)
        else:
            eng = PagedScheduler(model, params, capacity=32, slots=3,
                                 chunk=3, page_size=4, cim=cim,
                                 fused_attn=(name == "fused"),
                                 device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=3 + i))
        pa.reset_launches()
        done = eng.run()
        assert eng.host_transfers == eng.chunks_run
        launched = cfg.num_layers * eng.chunk * eng.chunks_run
        assert pa.LAUNCHES["paged_attention"] == (
            launched if name == "fused" else 0)
        if name == "fused":
            assert eng.attn_plan.backend == "paged_attn"
            assert eng.prefix_hit_rate > 0
        out[name] = {r.uid: r.out_tokens for r in done}
    assert out["fused"] == out["gather"] == out["dense"]
    assert [len(out["fused"][i]) for i in range(5)] == [3, 4, 5, 6, 7]


@pytest.mark.parametrize("qi,qw,m,k,n,bits", [
    (5, 5, 8, 2048, 1024, 5), (5, 5, 8, 8192, 2048, 5),
    (5, 5, 300, 520, 130, 5), (5, 5, 1, 37, 5, 5), (3, 5, 13, 1000, 131, 4),
    (1, 1, 9, 16, 3, 3), (5, 5, 70, 100, 67, 8), (5, 3, 2, 48, 259, 4)])
def test_cim_mac_kernel_matches_plain_version(dev, qi, qw, m, k, n, bits):
    rng = np.random.default_rng(m + k + n)
    x = torch.as_tensor(rng.integers(-1, 2, size=(qi, m, k)),
                        dtype=torch.int8, device=dev)
    w = torch.as_tensor(rng.integers(-1, 2, size=(qw, k, n)),
                        dtype=torch.int8, device=dev)
    before = cm.LAUNCHES["cim_mac"]
    got = cm.cim_mac(x, w, bits)
    torch.cuda.synchronize()
    assert cm.LAUNCHES["cim_mac"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, cm.cim_mac_torch(x, w, bits))


@pytest.mark.parametrize("bits", [4, 5])
def test_cim_mac_kernel_all_saturating(dev, bits):
    x = torch.ones((5, 8, 40), dtype=torch.int8, device=dev)
    w = -torch.ones((5, 40, 300), dtype=torch.int8, device=dev)
    got = cm.cim_mac(x, w, bits)
    assert torch.equal(got, cm.cim_mac_torch(x, w, bits))
    c = 2**bits - 1
    assert int(got[0, 0]) == (2 * (16 - c) + max(-8, 8 - c)) * 121 * 121


def test_cim_mac_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((5, 4, 32), dtype=torch.int8, device=dev)
    w = torch.zeros((5, 32, 8), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cm.cim_mac(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="operands on"):
        cm.cim_mac(x, w.cpu())


def test_smoke_model_exact_mode_cuda_matches_plain_backend(dev):
    """Macro-exact mode on float weights: the kernel is integer-exact and
    every other op is the same torch op, so the logits are bitwise equal;
    the engine resolves the cuda backend and launches the kernel once per
    dense() call."""
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 8)),
                             device=dev)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 2, 1)),
                           device=dev)
    logits = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="exact", backend=backend)
        cm.reset_launches()
        lg, state = model.prefill(params, prompt, 16, cim=cim)
        steps = [lg]
        for tok in feed:
            lg, state = model.decode(params, tok, state, cim=cim)
            steps.append(lg)
        per_forward = 7 * cfg.num_layers + 1
        assert cm.LAUNCHES["cim_mac"] == (
            3 * per_forward if backend == "cuda" else 0)
        logits[backend] = torch.stack(steps)
    assert torch.equal(logits["cuda"], logits["torch"])
    eng = ServeEngine(model, params, capacity=16, max_batch=2,
                      cim=CIMConfig(mode="exact"), device=dev)
    assert eng.cim.backend == "cuda"
    for i in range(2):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 512, size=5),
                           max_new=3))
    done = eng.run()
    assert eng.host_transfers == 1 and all(len(r.out_tokens) == 3
                                           for r in done)


def _planted_planes(qi, qw, m, k, n, seed, plants):
    """Seeded random trit planes with `plants` saturating (row, group,
    plane i, plane j, column) spots: x_i's 16 trits of the group all
    non-zero, w_j's of the column their negation (mac = -16)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, size=(qi, m, k)).astype(np.int8)
    w = rng.integers(-1, 2, size=(qw, k, n)).astype(np.int8)
    for _ in range(plants if k >= 16 else 0):
        mm, g = rng.integers(m), rng.integers(k // 16)
        i, j, nn = rng.integers(qi), rng.integers(qw), rng.integers(n)
        rows = slice(16 * g, 16 * g + 16)
        x[i, mm, rows] = rng.choice([-1, 1], size=16)
        w[j, rows, nn] = -x[i, mm, rows]
    return x, w


@pytest.mark.parametrize("m", [1, 9, 300, 1024])
@pytest.mark.parametrize("k,n", [(2048, 1024), (520, 130), (200, 136),
                                 (37, 5)])
def test_int32_epilogue_of_the_int8_routes_is_the_integer_product(dev, m, k,
                                                                  n):
    """cim_mac's product term: int8 codes in [-121, 121] times base3
    bytes through gemv (M <= 8) or mma, raw int32 sums, bitwise the
    integer product (taken in f64, exact below 2^53)."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randint(-121, 122, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    data = torch.randint(0, 243, (k, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    before = dict(tm.LAUNCHES)
    assert tm.launch_int32(x, data, "base3", out) == 0
    want = (x.double() @ (data.double() - 121)).to(torch.int32)
    assert torch.equal(out, want)
    assert tm.LAUNCHES == before                  # counts nothing


def test_int32_epilogue_at_the_full_width_prefill(dev):
    """w2's K = 8192 at M = 1024 (a split-K plan, reduced in order) and
    the extreme codes, whose sums reach 121^2 K."""
    x = torch.full((1024, 8192), -121, dtype=torch.int8, device=dev)
    data = torch.zeros((8192, 2048), dtype=torch.uint8, device=dev)
    out = torch.empty((1024, 2048), dtype=torch.int32, device=dev)
    assert tm.launch_int32(x, data, "base3", out) == 0
    assert bool((out == 121 * 121 * 8192).all())
    assert tm.launch_int32(x[:8].contiguous(), data, "base3", out[:8]) == 0
    assert bool((out[:8] == 121 * 121 * 8192).all())


@pytest.mark.parametrize("bits", [3, 4, 5, 6, 8])
@pytest.mark.parametrize("qi,qw,m,k,n", [
    (5, 5, 1, 2048, 1024), (5, 5, 8, 520, 130), (5, 5, 1024, 520, 136),
    (3, 5, 8, 1000, 131), (5, 3, 13, 48, 259), (5, 5, 8, 37, 5)])
def test_cim_mac_routes_match_plain_version_with_planted_saturation(
        dev, qi, qw, m, k, n, bits):
    x, w = _planted_planes(qi, qw, m, k, n, seed=m + k + bits, plants=64)
    x, w = (torch.as_tensor(a, device=dev) for a in (x, w))
    before = dict(cm.ROUTES)
    got = cm.cim_mac(x, w, bits)
    want = cm.cim_mac_torch(x, w, bits)
    assert torch.equal(got, want)
    path = cm.route(bits)
    assert path == ("codes" if bits >= 5 else "groups")
    assert cm.ROUTES[path] == before[path] + 1
    if bits == 5 and k >= 16:                     # the planted spots fire
        assert not torch.equal(got, cm.cim_mac_torch(x, w, 6))


@pytest.mark.parametrize("bits", [5, 6, 8])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (8, 8192, 520),
                                   (1024, 520, 136), (9, 37, 5)])
def test_cim_mac_code_entry_matches_plain_version(dev, m, k, n, bits):
    x, w = _planted_planes(5, 5, m, k, n, seed=3 * k + bits, plants=128)
    x, w = (torch.as_tensor(a, device=dev) for a in (x, w))
    xc = from_balanced_ternary(x).to(torch.int8)
    cw = cm.code_weight(w)
    before = dict(cm.ROUTES)
    got = cm.cim_mac_codes(xc, cw, bits)
    assert cm.ROUTES["codes"] == before["codes"] + 1
    assert torch.equal(got, cm.cim_mac_codes_torch(xc, cw, bits))
    assert torch.equal(got, cm.cim_mac_torch(x, w, bits))


@pytest.mark.parametrize("bits", [4, 5, 6])
@pytest.mark.parametrize("m,k,n", [(1, 40, 300), (8, 2040, 300),
                                   (1024, 200, 130)])
def test_cim_mac_all_saturating_through_both_entries(dev, m, k, n, bits):
    """x = +1 against w = -1 on every row: every full group of every
    plane pair saturates (at 5 bits the correction's worst case: every
    (row, group) flagged, every column listed)."""
    x = torch.ones((5, m, k), dtype=torch.int8, device=dev)
    w = -torch.ones((5, k, n), dtype=torch.int8, device=dev)
    want = cm.cim_mac_torch(x, w, bits)
    assert torch.equal(cm.cim_mac(x, w, bits), want)
    if bits >= 5:
        xc = from_balanced_ternary(x).to(torch.int8)
        assert torch.equal(cm.cim_mac_codes(xc, cm.code_weight(w), bits),
                           want)
    c, full, rest = 2**bits - 1, k // 16, k % 16
    want00 = full * max(-16, 16 - c) + (max(-rest, rest - c) if rest else 0)
    assert int(want[0, 0]) == want00 * 121 * 121


def test_cim_mac_code_entry_refuses_what_it_does_not_take(dev):
    xc = torch.zeros((4, 32), dtype=torch.int8, device=dev)
    cw = cm.code_weight(torch.zeros((5, 32, 8), dtype=torch.int8,
                                    device=dev))
    with pytest.raises(ValueError, match="adc_bits"):
        cm.cim_mac_codes(xc, cw, 4)
    with pytest.raises(ValueError, match="operands on"):
        cm.cim_mac_codes(xc, cm.CodeWeight(cw.data.cpu(), cw.groups), 5)
    with pytest.raises(TypeError, match="int8"):
        cm.cim_mac_codes(xc.int(), cw, 5)


def test_exact_mode_ternarizes_each_weight_once_on_the_card(dev):
    """The cuda backend's code route fills one cache entry per weight at
    the first forward and none after; a weight changed in place is made
    again; the logits stay bitwise those of the plain torch backend."""
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 8)), device=dev)
    per_forward = 7 * cfg.num_layers + 1
    backends.CODE_WEIGHTS.clear()
    fills = backends.CODE_WEIGHTS.fills
    cm.reset_launches()
    cuda = CIMConfig(mode="exact", backend="cuda")
    torch_cfg = CIMConfig(mode="exact", backend="torch")
    lg, state = model.prefill(params, prompt, 16, cim=cuda)
    assert backends.CODE_WEIGHTS.fills - fills == per_forward
    tok = lg[:, -1].argmax(-1, keepdim=True)
    lg2, _ = model.decode(params, tok, state, cim=cuda)
    assert backends.CODE_WEIGHTS.fills - fills == per_forward
    assert cm.ROUTES["codes"] == cm.LAUNCHES["cim_mac"] == 2 * per_forward
    want, wstate = model.prefill(params, prompt, 16, cim=torch_cfg)
    assert torch.equal(lg, want)
    assert torch.equal(lg2, model.decode(params, tok, wstate,
                                         cim=torch_cfg)[0])
    params["unembed"].mul_(-1)                    # in place: made again
    lg3, _ = model.prefill(params, prompt, 16, cim=cuda)
    assert backends.CODE_WEIGHTS.fills - fills == per_forward + 1
    assert torch.equal(lg3, model.prefill(params, prompt, 16,
                                          cim=torch_cfg)[0])
    backends.CODE_WEIGHTS.clear()


def _exact_smoke(dev, seed):
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32)
    model = registry.build(cfg)
    return cfg, model, model.init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)


@pytest.mark.parametrize("kind", ["dense", "gather"])
def test_exact_schedulers_on_the_card_match_the_plain_backend(dev, kind):
    """The dense Scheduler and the gather PagedScheduler in exact mode
    decode every slot in one call inside ``rows_as_calls``, each slot's
    activations quantized alone: the cuda backend (code route) gives the
    plain torch backend's tokens, per request, one transfer per chunk."""
    cfg, model, params = _exact_smoke(dev, 2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (6, 9, 5, 8, 7, 10)]
    tokens = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="exact", backend=backend)
        kw = dict(capacity=32, slots=3, chunk=3, cim=cim, device=dev)
        eng = (Scheduler(model, params, **kw) if kind == "dense" else
               PagedScheduler(model, params, page_size=4, fused_attn=False,
                              **kw))
        assert eng.decode_per_slot and eng.cim.backend == backend
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new=8))
        cm.reset_launches()
        done = eng.run()
        assert cm.ROUTES["codes"] == cm.LAUNCHES["cim_mac"]
        assert (cm.LAUNCHES["cim_mac"] > 0) == (backend == "cuda")
        assert eng.host_transfers == eng.chunks_run
        tokens[backend] = {r.uid: list(r.out_tokens) for r in done}
        assert all(len(t) == 8 for t in tokens[backend].values())
    assert tokens["cuda"] == tokens["torch"]


def test_rows_as_calls_decode_equals_one_slot_per_call_on_the_card(dev):
    """A batched exact decode of three slots at their own positions
    inside ``rows_as_calls`` against one call per slot: each slot's
    logits bitwise equal, and the layer's output too (the MAC is integer
    exact, the scale is per row); outside the context the rows share one
    scale, and the slot with the smaller activations moves."""
    from repro_torch.kernels.plan import rows_as_calls
    from repro_torch.models import layers
    cfg, model, params = _exact_smoke(dev, 3)
    cim = CIMConfig(mode="exact", backend="cuda").resolve("cuda")
    rng = np.random.default_rng(8)
    state = model.init_cache(3, 32, dev)
    state["pos"] = torch.zeros(3, dtype=torch.int32, device=dev)
    for n in range(4):                 # three slots at positions 4, 4, 4
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 1)),
                              device=dev)
        _, state = model.decode(params, tok, state, cim=cim)
    state["pos"] = state["pos"] + torch.tensor([0, 3, 7], device=dev,
                                               dtype=torch.int32)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 1)),
                          device=dev)
    singles = []
    for i in range(3):
        one = {"k": state["k"][:, i:i + 1].clone(),
               "v": state["v"][:, i:i + 1].clone(),
               "pos": state["pos"][i:i + 1].clone()}
        singles.append(model.decode(params, tok[i:i + 1], one,
                                    cim=cim)[0])
    with rows_as_calls():
        batched, _ = model.decode(params, tok, state, cim=cim)
    assert torch.equal(batched, torch.cat(singles))
    x = torch.randn(3, 1, cfg.d_model, device=dev) * torch.tensor(
        [1.0, 30.0, 0.02], device=dev)[:, None, None]
    w = params["blocks"]["w1"][0]
    one_by_one = torch.cat([layers.dense(x[i:i + 1], w, cim)
                            for i in range(3)])
    cm.reset_launches()
    with rows_as_calls():
        assert torch.equal(layers.dense(x, w, cim), one_by_one)
    assert cm.ROUTES["codes"] == 1
    assert not torch.equal(layers.dense(x, w, cim)[2], one_by_one[2])


# ------------------------------------------------------------- faults

@pytest.mark.parametrize("seed,blk", [
    (0, prng.flat_range(0, 1000)),
    (7, prng.flat_range(2**31 - 300, 777)),
    (2**31 - 1, prng.flat_range(2**32 - 5, 4099)),
    (12345, prng.Block(3 * 2**32 + 11, 7, 50_000, 333)),
    (3, prng.Block(0, 70_000, 5, 3))])          # rows past gridDim.y
def test_threefry_kernel_matches_plain_version(dev, seed, blk):
    k = prng.key(seed)
    before = threefry.LAUNCHES["threefry"]
    got = threefry.random_bits(k, blk, dev)
    assert threefry.LAUNCHES["threefry"] == before + 1
    assert torch.equal(got.cpu(), prng.bits_torch(k, blk, "cpu"))
    assert torch.equal(got, prng.bits_torch(k, blk, dev))


def test_draws_on_the_card_match_the_cpu(dev):
    k, shape = prng.key(11), (5, 3, 64, 96)
    for b in (None, prng.Block(64 * 96, 5, 3 * 64 * 96, 64 * 96)):
        pairs = [(prng.uniform(k, shape, device=dev, block=b),
                  prng.uniform(k, shape, device="cpu", block=b)),
                 (prng.bernoulli(k, 0.01, shape, dev, b),
                  prng.bernoulli(k, 0.01, shape, "cpu", b))]
        for lo, hi in ((-1, 2), (0, 2**15 - 1)):
            pairs.append((prng.randint(k, shape, lo, hi, dev, b),
                          prng.randint(k, shape, lo, hi, "cpu", b)))
        for got, want in pairs:
            assert torch.equal(got.cpu(), want)
        z = prng.normal(k, shape, dev, b).cpu().numpy()
        zc = prng.normal(k, shape, "cpu", b).numpy()
        ulps = np.abs(z.view(np.int32).astype(np.int64)
                      - zc.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4


@pytest.mark.parametrize("packing", ["base3", "trit2"])
def test_device_mac_on_the_card_matches_the_cpu(dev, packing):
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((8, 520)).astype(np.float32))
    w = ops.pack_weights(torch.from_numpy(
        rng.standard_normal((520, 300)).astype(np.float32)), packing)
    planes = faults.weight_trit_planes(w)
    for variation, sigma in ((False, 0.0), (False, 0.5), (True, 0.5)):
        fm = faults.FaultModel(seed=2, restore_yield=(0.97, 0.995, 0.96),
                               stuck_rate=0.01, variation=variation,
                               adc_noise_sigma=sigma)
        for per_row in (False, True):
            yc, loc, hic = faults.device_ternary_mac(
                x, planes, w.scale, fm, with_stats=True, per_row=per_row)
            yd, lod, hid = faults.device_ternary_mac(
                x.to(dev), planes.to(dev), w.scale.to(dev), fm,
                with_stats=True, per_row=per_row)
            yd = yd.cpu()
            if not variation:
                assert torch.equal(yd, yc)
                assert (int(lod), int(hid)) == (int(loc), int(hic))
            else:
                assert (yd != yc).float().mean() <= 0.01
                assert abs(int(lod) - int(loc)) <= 1


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, ops.PackedTernary):
        return ops.PackedTernary(tree.data.cpu(), tree.scale.cpu(),
                                 tree.mode)
    return tree.cpu()


def _same_packed(a, b):
    la, lb = faults.scrub.packed_leaves(a), faults.scrub.packed_leaves(b)
    return len(la) == len(lb) > 0 and all(
        torch.equal(x.data.cpu(), y.data.cpu())
        for (_, x), (_, y) in zip(la, lb))


def test_disturb_scrub_and_serving_on_the_card_match_the_cpu(dev):
    _, model, params = _smoke(dev, "base3")
    cpu_params = _to_cpu(params)
    key, ys = prng.key(9), (0.97, 0.995, 0.96)
    a = faults.disturb_packed_params(params, 0.01, key)
    b = faults.disturb_packed_params(cpu_params, 0.01, key)
    assert _same_packed(a, b)
    assert _same_packed(faults.scrub_packed_params(params, ys, key),
                        faults.scrub_packed_params(cpu_params, ys, key))
    assert tuple(int(v) for v in faults.adc_probe(a)) == tuple(
        int(v) for v in faults.adc_probe(b))
    prev = faults.set_fault_model(faults.FaultModel(
        seed=0, restore_yield=ys, drift_rate=0.002, variation=False))
    try:
        served = {}
        for where, p in (("card", params), ("cpu", cpu_params)):
            s = Scheduler(model, p, capacity=32, slots=2, chunk=2,
                          cim=CIMConfig(mode="ternary", packing="base3",
                                        fidelity="device"), scrub_every=2,
                          device=dev if where == "card" else "cpu")
            for i in range(3):
                s.submit(Request(uid=i, prompt=np.arange(5 + i) % 64,
                                 max_new=4))
            threefry.reset_launches()
            done = s.run()
            assert s.host_transfers == s.chunks_run and s.scrubs_run >= 1
            assert all(len(r.out_tokens) == 4 for r in done)
            assert s.cim.backend == "device"
            assert (threefry.LAUNCHES["threefry"] > 0) == (where == "card")
            served[where] = s.params
        assert _same_packed(served["card"], served["cpu"])
    finally:
        faults.set_fault_model(prev)


# ------------------------------------------------ MoE and the window

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [8, 300])
def test_moe_block_cuda_matches_plain_version(dev, tokens, dtype):
    """moe_block at a small width (d 256, f 512, 4 experts, top 2) with
    base3 experts: the expert products through the ternary kernel give
    the plain version's output (routing is the same f32 torch op on
    both), 3 x 4 launches a call, bf16 on gemv at M <= 8 and on mma
    above, f32 on cuda_core.  Bars: f32 within 1e-4 of max|y|; bf16,
    whose expert products round to bf16, within 2e-2."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(configs.smoke("mixtral-8x7b"), d_model=256,
                              d_ff=512, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    w = {k: spec._replace(shape=spec.shape[1:]).initialize(gen, dev, dtype)
         for k, spec in moe.moe_defs(cfg, 1).items()}
    w = ternarize_params(w, CIMConfig(mode="ternary", packing="base3"))
    assert isinstance(w["w1"], ops.PackedTernary)
    x = torch.randn((2, tokens // 2, cfg.d_model), generator=gen,
                    device=dev).to(dtype)
    out = {}
    for backend in ("cuda", "torch"):
        tm.reset_launches()
        out[backend], _ = moe.moe_block(
            x, w, cfg, CIMConfig(mode="ternary", backend=backend))
        launched = tm.LAUNCHES["ternary_matmul"]
        assert launched == (3 * cfg.num_experts if backend == "cuda" else 0)
    m = max(1, int(tokens * 2 * cfg.moe_capacity_factor / 4))
    want_route = ("cuda_core" if dtype == torch.float32
                  else "gemv" if m <= 8 else "mma")
    tm.reset_launches()
    moe.moe_block(x, w, cfg, CIMConfig(mode="ternary", backend="cuda"))
    assert tm.ROUTES[want_route] == 3 * cfg.num_experts
    got, want = out["cuda"].float(), out["torch"].float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * want.abs().max().item())


def test_rolling_decode_on_the_card_matches_the_plain_path(dev):
    """mixtral-smoke (window 16), f32, base3: a 20-token prefill into
    the rolling cache and 10 decode steps, and the dense Scheduler over
    it, through the kernels and through the plain backend: logits within
    1e-4 of their scale, the same caches to round-off, the same tokens,
    one transfer per chunk."""
    cfg = dataclasses.replace(configs.smoke("mixtral-8x7b"),
                              dtype=torch.float32)
    model = registry.build(cfg)
    params = ternarize_params(
        model.init(torch.Generator(device=dev).manual_seed(0), device=dev),
        CIMConfig(mode="ternary", packing="base3"))
    rng = np.random.default_rng(6)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 20)),
                             device=dev)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(10, 2, 1)),
                           device=dev)
    prompts = [rng.integers(0, cfg.vocab_size, 12 + 4 * i) for i in range(3)]
    logits, caches, tokens = {}, {}, {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", backend=backend)
        lg, state = model.prefill(params, prompt, 32, cim=cim)
        assert state["k"].shape[2] == cfg.sliding_window
        steps = [lg]
        for tok in feed:
            lg, state = model.decode(params, tok, state, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
        caches[backend] = state["k"]
        s = Scheduler(model, params, capacity=32, slots=2, chunk=3, cim=cim,
                      device=dev)
        for i, p in enumerate(prompts):
            s.submit(Request(uid=i, prompt=p, max_new=8))
        tm.reset_launches()
        done = s.run()
        assert s.host_transfers == s.chunks_run
        assert (tm.LAUNCHES["ternary_matmul"] > 0) == (backend == "cuda")
        tokens[backend] = {r.uid: r.out_tokens for r in done}
    got, want = logits["cuda"], logits["torch"]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())
    torch.testing.assert_close(caches["cuda"], caches["torch"], rtol=0,
                               atol=1e-4 * caches["torch"].abs().max().item())
    assert tokens["cuda"] == tokens["torch"]


# ------------------------------------------- slice 8: int8 KV, recurrent

# the recurrent families' new kernel shapes (K, N): zamba2-7b's Mamba2
# in_proj (N = 14576, 113.875 column tiles of 128) and out_proj, and
# xlstm-125m's wif (N = 8, packed on every call)
RECURRENT_KN = [(3584, 14576), (7168, 3584), (1536, 8)]


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", RECURRENT_KN)
@pytest.mark.parametrize("m", [1, 8, 1024])
def test_ternary_routes_at_the_recurrent_shapes(dev, m, k, n, mode):
    """gemv (M <= 8) and mma (M = 1024) at a partial last column tile
    and at N = 8: float within 1e-5 of max|y|, int8 bitwise, each call
    through its route."""
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=m + k + n)
    if m <= 8:
        _gemv_matches(dev, x, data, scale, mode)
        return
    w = ops.PackedTernary(data, scale, mode)
    before = dict(tm.ROUTES)
    xb = x.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(tm.matmul_float(xb, data, scale, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(x)
    assert torch.equal(tm.matmul_int8(xi, xs, data, scale, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    assert tm.ROUTES["mma"] == before["mma"] + 2


def _block_weights(defs, seed):
    """One layer's f32 weights of a spec dict, on the CPU."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in defs.items():
        shape = spec.shape[1:]
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        out[name] = torch.from_numpy((rng.standard_normal(shape)
                                      / np.sqrt(fan)).astype(np.float32))
    return out


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
@pytest.mark.parametrize("s", [12, 300, 512])
def test_recurrent_blocks_on_the_card_match_the_cpu(dev, block, s):
    """The SSD (chunked, padded past 256), mLSTM (parallel, chunked at
    512) and sLSTM blocks in f32 at smoke widths, a prompt and one
    recurrent step, on the card and on the CPU: outputs and states
    within 1e-4 of their scale (summation order; TF32 off)."""
    from repro_torch.models import ssm
    assert not torch.backends.cuda.matmul.allow_tf32
    arch = "zamba2-7b" if block == "mamba2" else "xlstm-125m"
    cfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32)
    fn, defs = {"mamba2": (ssm.mamba2_block, ssm.mamba2_defs),
                "mlstm": (ssm.mlstm_block, ssm.mlstm_defs),
                "slstm": (ssm.slstm_block, ssm.slstm_defs)}[block]
    w = _block_weights(defs(cfg, 1), seed=s)
    rng = np.random.default_rng(s + 1)
    x = torch.from_numpy(rng.standard_normal((2, s, cfg.d_model)).astype(
        np.float32))
    x1 = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(
        np.float32))
    outs = {}
    for where in ("cpu", dev):
        wd = {k: v.to(where) for k, v in w.items()}
        y, st = fn(x.to(where), wd, cfg)
        y1, st1 = fn(x1.to(where), wd, cfg, st)
        outs[str(where)] = [y, y1] + [t for t in st1
                                      if isinstance(t, torch.Tensor)]
    for got, want in zip(outs[str(dev)], outs["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_recurrent_smoke_models_cuda_backend_matches_plain_backend(dev, arch):
    """zamba2-smoke (7 layers: a tail of 1) and xlstm-smoke, f32, base3:
    prefill and 4 decode steps through the kernels and through the plain
    backend, logits within 1e-4 of their scale; then the bucket engine
    and the dense Scheduler, the same tokens, one transfer per bucket or
    chunk."""
    over = dict(num_layers=7) if arch == "zamba2-7b" else {}
    cfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32,
                              **over)
    model = registry.build(cfg)
    params = ternarize_params(
        model.init(torch.Generator(device=dev).manual_seed(0), device=dev),
        CIMConfig(mode="ternary", packing="base3"))
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 12)),
                             device=dev)
    prompts = [rng.integers(0, cfg.vocab_size, 10 + 3 * i) for i in range(3)]
    logits, tokens = {}, {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", backend=backend)
        lg, state = model.prefill(params, prompt, 32, cim=cim)
        steps = [lg]
        for _ in range(4):
            lg, state = model.decode(params, steps[0][:, -1].argmax(
                -1, keepdim=True), state, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
        for eng in (ServeEngine(model, params, capacity=32, max_batch=3,
                                cim=cim, device=dev),
                    Scheduler(model, params, capacity=32, slots=2, chunk=3,
                              cim=cim, device=dev)):
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new=6))
            tm.reset_launches()
            done = eng.run()
            kind = type(eng).__name__
            assert eng.host_transfers == (eng.chunks_run if kind ==
                                          "Scheduler" else 3)
            assert (tm.LAUNCHES["ternary_matmul"] > 0) == (backend == "cuda")
            tokens[(backend, kind)] = {r.uid: r.out_tokens for r in done}
    got, want = logits["cuda"], logits["torch"]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())
    for kind in ("ServeEngine", "Scheduler"):
        assert tokens[("cuda", kind)] == tokens[("torch", kind)]


def test_int8_kv_decode_on_the_card_matches_the_cpu(dev):
    """internlm2-smoke with an int8 KV cache, f32 float weights: the
    prefill's codes and scales and 6 decode steps' logits and caches on
    the card and on the CPU (codes within one step, logits within 1e-4
    of their scale); the card's dense Scheduler and gather
    PagedScheduler give the same tokens."""
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                              dtype=torch.float32, kv_cache_dtype="int8")
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)))
    runs = {}
    for where in ("cpu", dev):
        p = {k: (v.to(where) if isinstance(v, torch.Tensor)
                 else {kk: vv.to(where) for kk, vv in v.items()})
             for k, v in params.items()}
        lg, st = model.prefill(p, prompt.to(where), 24)
        steps = [lg]
        for i in range(6):
            tok = torch.full((2, 1), 7 * i + 1, device=where)
            lg, st = model.decode(p, tok, st)
            steps.append(lg)
        runs[str(where)] = (torch.stack(steps).cpu(),
                            {k: v.cpu() for k, v in st.items()
                             if isinstance(v, torch.Tensor)})
    (lc, sc), (lg, sg) = runs["cpu"], runs[str(dev)]
    torch.testing.assert_close(lg, lc, rtol=0,
                               atol=1e-4 * lc.abs().max().item())
    for name in ("k", "v"):
        assert (sg[name].int() - sc[name].int()).abs().max() <= 1
        torch.testing.assert_close(sg[name + "_scale"], sc[name + "_scale"],
                                   rtol=1e-5, atol=0)
    p = {k: (v.to(dev) if isinstance(v, torch.Tensor)
             else {kk: vv.to(dev) for kk, vv in v.items()})
         for k, v in params.items()}
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, 6 + 2 * i)
               for i in range(4)]
    tokens = []
    for eng in (Scheduler(model, p, capacity=32, slots=2, chunk=3,
                          device=dev),
                PagedScheduler(model, p, capacity=32, slots=2, chunk=3,
                               page_size=4, device=dev)):
        for i, pr in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=pr, max_new=5))
        done = eng.run()
        assert eng.host_transfers == eng.chunks_run
        tokens.append({r.uid: r.out_tokens for r in done})
    assert tokens[0] == tokens[1]
    assert eng.attn_plan is None


# the cross-attending families' kernel shapes (K, N, packing):
# whisper-large-v3's w1 and w2 (d 1280, d_ff 5120) and its unembedding
# (vocab padded to 51968), base3 and trit2; llama-3.2-vision-90b's w1/w3
# and w2 in trit2 (K = 28672 splits the float mma chain)
CROSS_KN = [(1280, 5120, "base3"), (5120, 1280, "base3"),
            (1280, 51968, "base3"), (1280, 5120, "trit2"),
            (5120, 1280, "trit2"), (1280, 51968, "trit2"),
            (8192, 28672, "trit2"), (28672, 8192, "trit2")]


@pytest.mark.parametrize("k,n,mode", CROSS_KN)
@pytest.mark.parametrize("m", [8, 1024])
def test_ternary_routes_at_the_cross_models_shapes(dev, m, k, n, mode):
    """gemv (M = 8, decode) and mma (M = 1024, prefill) at whisper's and
    llama-vision's shapes: float within 1e-5 of max|y|, int8 bitwise,
    each call through its route."""
    x, data, scale = _device_operands(dev, m, k, n, mode, seed=m + k + n)
    if m <= 8:
        _gemv_matches(dev, x, data, scale, mode)
        return
    w = ops.PackedTernary(data, scale, mode)
    before = dict(tm.ROUTES)
    xb = x.to(torch.bfloat16)
    want = ops.ternary_matmul_torch(xb, w)
    torch.testing.assert_close(tm.matmul_float(xb, data, scale, mode), want,
                               rtol=0, atol=1e-5 * want.abs().max().item())
    xi, xs = ops.quantize_acts_int8(x)
    assert torch.equal(tm.matmul_int8(xi, xs, data, scale, mode),
                       ops.ternary_matmul_int8_torch(xi, xs, w))
    assert tm.ROUTES["mma"] == before["mma"] + 2


def _gated_smoke(arch, where):
    """An f32 smoke model of `arch` and its float params on `where`, a
    VLM's gates set to seeded nonzero values (at init's zeros the cross
    blocks add nothing)."""
    cfg = dataclasses.replace(configs.smoke(arch), dtype=torch.float32)
    model = registry.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    if cfg.cross_attn_every:
        gen = torch.Generator().manual_seed(1)
        params["cross_blocks"]["gate"] = 0.5 + torch.rand(
            model.n_cross, generator=gen)
    return model, _on(params, where)


def _on(tree, where):
    if isinstance(tree, dict):
        return {k: _on(v, where) for k, v in tree.items()}
    if isinstance(tree, ops.PackedTernary):
        return ops.PackedTernary(tree.data.to(where), tree.scale.to(where),
                                 tree.mode)
    return tree.to(where)


def test_cross_attention_on_the_card_matches_the_cpu(dev):
    """``attention.cross_attention`` (no rope, no mask) and
    ``self_attention(causal=False)`` in f32 at llama-vision-smoke's
    grouping (4 heads over 2 KV heads), 9 queries over 300 keys, on the
    card and on the CPU: within 1e-5 of their scale (TF32 off)."""
    from repro_torch.models import attention as attn
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.smoke("llama-3.2-vision-90b"),
                              dtype=torch.float32)
    model, params = _gated_smoke("llama-3.2-vision-90b", "cpu")
    w = {k: v[0] for k, v in params["cross_blocks"].items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 9, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 300, 64)).astype(
        np.float32))
    for fn in (lambda x, kv, w: attn.cross_attention(x, kv, w, cfg),
               lambda x, kv, w: attn.self_attention(kv, w, cfg,
                                                    causal=False)):
        want = fn(x, kv, w)
        got = fn(x.to(dev), kv.to(dev), _on(w, dev)).cpu()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_cross_smoke_models_on_the_card(dev, arch):
    """whisper-smoke and llama-vision-smoke (nonzero gates), f32: float
    prefill and 4 decode steps on the card equal the CPU's within 1e-4
    of the logit scale, the cross caches too; then base3 through the
    kernels and through the plain backend on the card, logits within
    1e-4, and the bucket engine's and the dense Scheduler's tokens equal
    with the extra input expanded to the batch, one transfer per bucket
    or chunk."""
    model, cpu_params = _gated_smoke(arch, "cpu")
    cfg = model.cfg
    key = "frames" if cfg.family == "audio" else "patches"
    rng = np.random.default_rng(5)
    extra = torch.from_numpy(rng.standard_normal(
        (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 10)))
    runs = {}
    for where in ("cpu", dev):
        p = _on(cpu_params, where)
        lg, st = model.prefill(p, prompt.to(where), 24,
                               **{key: extra.expand(2, -1, -1).to(where)})
        steps = [lg]
        for i in range(4):
            lg, st = model.decode(p, torch.full((2, 1), 5 * i + 1,
                                                device=where), st)
            steps.append(lg)
        runs[str(where)] = (torch.stack(steps).cpu(),
                            {k: st[k].cpu() for k in ("k", "xk", "xv")})
    (lc, sc), (lg, sg) = runs["cpu"], runs[str(dev)]
    torch.testing.assert_close(lg, lc, rtol=0,
                               atol=1e-4 * lc.abs().max().item())
    for name, want in sc.items():
        torch.testing.assert_close(sg[name], want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    params = ternarize_params(_on(cpu_params, dev),
                              CIMConfig(mode="ternary", packing="base3"),
                              predicate=model.pack_predicate)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(3)]
    feed = {key: lambda b: extra[0].expand(b, -1, -1)}
    logits, tokens = {}, {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="ternary", packing="base3", backend=backend)
        lg, st = model.prefill(params, prompt.to(dev), 24, cim=cim,
                               **{key: extra.expand(2, -1, -1).to(dev)})
        steps = [lg]
        for _ in range(4):
            lg, st = model.decode(params, steps[0][:, -1].argmax(
                -1, keepdim=True), st, cim=cim)
            steps.append(lg)
        logits[backend] = torch.stack(steps)
        for eng in (ServeEngine(model, params, capacity=24, max_batch=3,
                                cim=cim, device=dev, extra_inputs=feed),
                    Scheduler(model, params, capacity=24, slots=2, chunk=3,
                              cim=cim, device=dev, extra_inputs=feed)):
            for i, pr in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=pr, max_new=5))
            tm.reset_launches()
            done = eng.run()
            kind = type(eng).__name__
            assert eng.host_transfers == (eng.chunks_run if kind ==
                                          "Scheduler" else 1)
            assert (tm.LAUNCHES["ternary_matmul"] > 0) == (backend == "cuda")
            tokens[(backend, kind)] = {r.uid: r.out_tokens for r in done}
    torch.testing.assert_close(logits["cuda"], logits["torch"], rtol=0,
                               atol=1e-4 * logits["torch"].abs().max().item())
    for kind in ("ServeEngine", "Scheduler"):
        assert tokens[("cuda", kind)] == tokens[("torch", kind)]


# ------------------------------------------------------------- training

def _train_model(dtype=torch.float32, layers=None):
    cfg = dataclasses.replace(configs.smoke("internlm2-1.8b"), dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return registry.build(cfg)


def test_train_data_draws_on_the_card_equal_the_cpu(dev):
    """lm_batch through the threefry kernel: tokens and labels bitwise
    the CPU's (6 launches a row); class_batch's labels bitwise and its x
    within 4 ulp (normal's log1p)."""
    from repro_torch.data import (ClassTaskConfig, DataConfig, class_batch,
                                  lm_batch)
    cfg = DataConfig(vocab_size=92544, seq_len=256, global_batch=8, seed=5)
    threefry.reset_launches()
    got = lm_batch(cfg, 17, device=dev)
    assert threefry.LAUNCHES["threefry"] == 6 * 8
    want = lm_batch(cfg, 17, device="cpu")
    for k in ("tokens", "labels"):
        assert torch.equal(got[k].cpu(), want[k])
    ccfg = ClassTaskConfig(num_classes=10, dim=64, seed=2)
    a, b = class_batch(ccfg, 3, device=dev), class_batch(ccfg, 3,
                                                          device="cpu")
    assert torch.equal(a["y"].cpu(), b["y"])
    top = b["x"].abs().max().item()
    assert (a["x"].cpu() - b["x"]).abs().max().item() <= 4 * float(
        np.spacing(np.float32(top)))


def test_train_bf16_clip_on_the_card_equals_the_cpu(dev):
    """clip_by_global_norm of bf16 grads whose norm is past max_norm:
    each grad times the f32 scale, rounded once to bf16, bitwise the
    CPU's (a bf16 product on the card would round the scale first)."""
    from repro_torch import optim
    gen = torch.Generator().manual_seed(7)
    grads = {k: torch.randn(shape, generator=gen).to(torch.bfloat16)
             for k, shape in (("a", (256, 96)), ("b", (1000,)))}
    out = {}
    for where in (dev, "cpu"):
        g = {k: v.to(where, copy=True) for k, v in grads.items()}
        clipped, norm = optim.clip_by_global_norm(g, 1.0)
        out[str(where)] = ({k: v.cpu() for k, v in clipped.items()},
                           norm.cpu())
    (cg, cn), (hg, hn) = out[str(dev)], out["cpu"]
    assert float(hn) > 1.0
    torch.testing.assert_close(cn, hn, rtol=1e-6, atol=0)
    scale = torch.clamp(1.0 / hn, max=1.0)
    for k in grads:
        assert torch.equal(cg[k].view(torch.int16), hg[k].view(torch.int16))
        assert torch.equal(hg[k], (grads[k].float() * scale).to(
            torch.bfloat16))


def test_train_embedding_grad_is_deterministic_on_the_card(dev):
    """layers.embed's gradient over many repeats of a few tokens: two
    backward passes bitwise equal, and equal to the CPU's f32 sum within
    1e-6 of its max."""
    from repro_torch.models.layers import embed
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((300, 64), generator=gen)
    tokens = torch.randint(0, 7, (8, 512), generator=gen)
    tokens[0, :5] = 299
    up = torch.randn((8, 512, 64), generator=gen)
    grads = []
    for where in (dev, dev, "cpu"):
        t = table.to(where).requires_grad_()
        (g,) = torch.autograd.grad((embed(t, tokens.to(where))
                                    * up.to(where)).sum(), t)
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=0,
                               atol=1e-6 * grads[2].abs().max().item())


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One AdamW step of f32 smoke internlm2-1.8b (remat 'full') on the
    card and on the CPU from the same params and batch: loss, grad norm
    and both moments within 1e-4 (relative; each moment of its leaf's
    max); the param updates within 2 lr, and within 1e-3 of lr for all
    but 0.1% of the weights (the first step moves each by lr * g / (|g| +
    eps), which turns on any difference where g is of eps's size)."""
    from repro_torch import optim, tree
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import TrainState, make_train_step
    model = registry.build(dataclasses.replace(
        configs.smoke("internlm2-1.8b"), dtype=torch.float32, remat="full"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = lm_batch(DataConfig(vocab_size=512, seq_len=64, global_batch=4,
                                seed=0), 0, device="cpu")
    lr = 1e-3
    out = {}
    for where in (dev, "cpu"):
        p = tree.map_leaves(lambda x: x.to(where, copy=True), params)
        opt = optim.adamw(lr)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=where))
        new, m = make_train_step(model, opt)(
            state, {k: v.to(where) for k, v in batch.items()})
        out[str(where)] = (
            {k: float(v) for k, v in m.items()},
            [a.cpu() - b for a, b in zip(tree.leaves(new.params),
                                         tree.leaves(params))],
            [x.cpu() for x in tree.leaves(new.opt_state)])
    (mg, dg, sg), (mc, dc, sc) = out[str(dev)], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k])
    for a, b in zip(sg, sc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(dg, dc)])
    assert diff.max() <= 2 * lr
    assert float((diff > 1e-3 * lr).double().mean()) <= 1e-3


def test_train_replay_is_bitwise_on_the_card(dev, tmp_path):
    """The Trainer on the card (bf16 smoke internlm2-1.8b, 8 x 64 tokens
    of a 512-token chain, so the embedding gradient sums many repeats)
    through two crashes before an update and one in the middle of a
    save: final params and optimizer state bitwise equal to an
    uninterrupted run's."""
    from repro_torch import optim, tree
    from repro_torch.data import DataConfig
    from repro_torch.train import FailurePlan, Trainer, TrainerConfig
    model = _train_model(torch.bfloat16)
    data = DataConfig(vocab_size=512, seq_len=64, global_batch=8, seed=0)
    states = []
    for name, plan in (("a", None), ("b", FailurePlan(
            crash_at=(5, 11), crash_in_save=(12,)))):
        tc = TrainerConfig(total_steps=16, ckpt_dir=str(tmp_path / name),
                           ckpt_interval=4, seed=0)
        tr = Trainer(model, optim.adamw(1e-3), data, tc, failure_plan=plan,
                     device=dev)
        states.append(tr.run())
    assert tr.restarts == 3
    a, b = states
    assert all(torch.equal(x, y) for x, y in zip(
        tree.leaves((a.params, a.opt_state)),
        tree.leaves((b.params, b.opt_state))))


def test_train_exact_mode_cuda_route_matches_the_torch_route(dev):
    """Exact mode, f32 smoke internlm2-1.8b (remat 'full'): loss and every
    gradient through the cuda code route equal the plain torch route's
    (within 1e-6 of each tensor's max), 2 x 7 + 1 cim_mac launches for
    the forward and 2 x 7 for the re-forward; then two consecutive
    training steps per route (the second refills the cached codes and
    makes each weight's scale in its own graph): params within 1e-5 of
    each tensor's max."""
    from repro_torch import optim, tree
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import TrainState, make_train_step, value_and_grad
    model = registry.build(dataclasses.replace(
        configs.smoke("internlm2-1.8b"), dtype=torch.float32, remat="full"))
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    data = DataConfig(vocab_size=512, seq_len=32, global_batch=2, seed=1)
    batch = lm_batch(data, 0, device=dev)
    got = {}
    for backend in ("cuda", "torch"):
        cim = CIMConfig(mode="exact", backend=backend).resolve("cuda")
        cm.reset_launches()
        loss, grads = value_and_grad(model, params, batch, cim)
        got[backend] = (loss, tree.leaves(grads), cm.LAUNCHES["cim_mac"])
    (lc, gc_, nc), (lt, gt, nt) = got["cuda"], got["torch"]
    assert nc == 2 * (7 * 2) + 1 and nt == 0
    torch.testing.assert_close(lc, lt, rtol=1e-6, atol=0)
    for a, b in zip(gc_, gt):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * b.abs().max().item())
    finals = {}
    for backend in ("cuda", "torch"):
        p = tree.map_leaves(lambda x: x.clone(), params)
        opt = optim.adamw(1e-3)
        state = TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev))
        step = make_train_step(model, opt,
                               cim=CIMConfig(mode="exact", backend=backend))
        for i in range(2):
            state, m = step(state, lm_batch(data, i, device=dev))
            assert torch.isfinite(m["loss"])
        finals[backend] = tree.leaves(state.params)
    for a, b in zip(finals["cuda"], finals["torch"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def test_train_ternary_is_refused_on_the_card(dev):
    """A ternary config and packed params are refused before any step:
    the ternary kernels have no backward."""
    from repro_torch import optim
    from repro_torch.data import DataConfig, lm_batch
    from repro_torch.train import init_state, make_train_step
    model = _train_model()
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, optim.adamw(1e-3),
                        cim=CIMConfig(mode="ternary"))
    state = init_state(model, optim.adamw(1e-3),
                       torch.Generator(device=dev).manual_seed(0), dev)
    packed = state._replace(params=ternarize_params(
        state.params, CIMConfig(mode="ternary")))
    tm.reset_launches()
    with pytest.raises(ValueError, match="packed leaves"):
        make_train_step(model, optim.adamw(1e-3))(
            packed, lm_batch(DataConfig(vocab_size=512, seq_len=8,
                                        global_batch=1), 0, device=dev))
    assert tm.LAUNCHES["ternary_matmul"] == 0

"""The PyTorch port's CUDA kernels on the card, against their plain
versions on the same inputs.  Every test here is marked ``cuda`` and
skips with a reason on a machine without a CUDA device; this file
imports neither JAX nor the reference package, so on the card it runs
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: float domain within 1e-5 of max|y| for single matmuls and 1e-4 of
the logit scale for f32 smoke-model forwards (summation order only);
int8 domain bitwise for both; the bucket ServeEngine keeps one host
transfer per bucket.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.cim_linear import CIMConfig, ternarize_params
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import registry
from repro_torch.serve import Request, ServeEngine

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

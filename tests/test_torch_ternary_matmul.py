"""The two ternary matmuls of the PyTorch port against the JAX
reference's Pallas kernels (run in interpret mode on the CPU), on ragged
shapes and both packings; plan resolution; and the wrappers' operand
checks.  The CUDA kernels against their plain versions on the card are
in tests/test_torch_cuda.py, which imports no JAX and so runs there.

Bars: float domain within 1e-5 of max|y| (f32 summation order only);
int8 domain bitwise (exact integer accumulation, then the epilogue
``acc * x_scale * scale`` in that order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ternary_matmul import ternary_matmul, ternary_matmul_int8
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.kernels import (execute, ops, plan_matmul, ref,
                                 resolve_backend, shape_of)
from repro_torch.kernels import ternary_matmul as tm

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(3, 200, 130), (8, 256, 384), (1, 64, 5)]


def _operands(m, k, n, mode, seed):
    """Seeded x (M, K') f32, packed bytes and f32 column scales; K' is K
    rounded up to 4 for trit2, with x zero beyond K."""
    rng = np.random.default_rng(seed)
    kp = k + (-k % 4) if mode == "trit2" else k
    x = np.zeros((m, kp), np.float32)
    x[:, :k] = rng.standard_normal((m, k))
    if mode == "base3":
        data = rng.integers(0, 243, size=(k, n)).astype(np.uint8)
    else:
        data = rng.integers(0, 256, size=(kp // 4, n)).astype(np.uint8)
    scale = (rng.uniform(0.5, 1.5, size=n) * 0.01).astype(np.float32)
    return x, data, scale


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_float_matches_pallas_interpret(mode, m, k, n):
    x, data, scale = _operands(m, k, n, mode, seed=m + k + n)
    want = np.asarray(ternary_matmul(jnp.asarray(x), jnp.asarray(data),
                                     jnp.asarray(scale), mode=mode,
                                     interpret=True))
    got = tm.matmul_float(torch.from_numpy(x), torch.from_numpy(data),
                          torch.from_numpy(scale), mode)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    oracle = ref.ternary_matmul_ref(torch.from_numpy(x),
                                    torch.from_numpy(data),
                                    torch.from_numpy(scale), mode)
    np.testing.assert_allclose(oracle.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_bitwise_vs_pallas_interpret(mode, m, k, n):
    x, data, scale = _operands(m, k, n, mode, seed=2 * (m + k + n))
    xi, xs = ops.quantize_acts_int8(torch.from_numpy(x))
    want = np.asarray(ternary_matmul_int8(
        jnp.asarray(xi.numpy()), jnp.asarray(xs.numpy()), jnp.asarray(data),
        jnp.asarray(scale), mode=mode, interpret=True))
    got = tm.matmul_int8(xi, xs, torch.from_numpy(data),
                         torch.from_numpy(scale), mode)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ref.ternary_matmul_int8_ref(xi, xs, torch.from_numpy(data),
                                         torch.from_numpy(scale), mode)
    np.testing.assert_array_equal(oracle.numpy(), want)
    jor = jref.ternary_matmul_int8_ref(
        jnp.asarray(xi.numpy()), jnp.asarray(xs.numpy()), jnp.asarray(data),
        jnp.asarray(scale), mode)
    np.testing.assert_array_equal(np.asarray(jor), want)


@pytest.mark.parametrize("domain", ["float", "int8"])
@pytest.mark.parametrize("mode", ["base3", "trit2"])
def test_execute_backends_agree_on_stacked_leading_axes(domain, mode):
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((66, 40)).astype(np.float32))
    pw = ops.pack_weights(w, mode)
    x = torch.from_numpy(rng.standard_normal((2, 3, 66)).astype(np.float32))
    outs = {}
    for backend in ("torch", "ref"):
        plan = plan_matmul(shape_of(x, pw), platform="cpu", backend=backend,
                           domain=domain, packing=mode)
        assert plan.backend == backend
        outs[backend] = execute(plan, x, pw)
    assert outs["torch"].shape == (2, 3, 40)
    if domain == "int8":
        torch.testing.assert_close(outs["torch"], outs["ref"], rtol=0, atol=0)
    else:
        torch.testing.assert_close(outs["torch"], outs["ref"], rtol=1e-5,
                                   atol=1e-5)


def test_plan_resolution_follows_the_operand_device():
    x = torch.zeros(4, 64)
    pw = ops.pack_weights(torch.ones(64, 64), "base3")
    plan = plan_matmul(shape_of(x, pw), platform="cpu")
    assert plan.backend == "torch" and plan.platform == "cpu"
    assert resolve_backend(platform="cuda").name == "cuda"
    with pytest.raises(ValueError, match="platform 'cpu'"):
        plan_matmul(shape_of(x, pw), platform="cpu", backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        plan_matmul(shape_of(x, pw), platform="cpu", backend="pallas")
    with pytest.raises(ValueError, match="platform"):
        CIMConfig(mode="ternary", backend="cuda").resolve("cpu")
    cuda_plan = plan_matmul(shape_of(x, pw), platform="cuda")
    with pytest.raises(ValueError, match="resolved for 'cuda'"):
        execute(cuda_plan, x, pw)
    with pytest.raises(ValueError, match="does not match plan"):
        execute(plan, torch.zeros(5, 64), pw)


def test_wrappers_check_their_operands():
    x = torch.zeros(2, 8)
    data = torch.zeros(8, 4, dtype=torch.uint8)
    scale = torch.ones(4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tm.matmul_float(torch.zeros(2, 7), torch.zeros(2, 4, dtype=torch.uint8),
                        scale, "trit2")
    with pytest.raises(TypeError, match="dtype"):
        tm.matmul_float(x.to(torch.float16), data, scale, "base3")
    with pytest.raises(TypeError, match="dtype"):
        tm.matmul_int8(x, torch.ones(2), data, scale, "base3")
    with pytest.raises(ValueError, match="scale"):
        tm.matmul_float(x, data, torch.ones(5), "base3")
    with pytest.raises(ValueError, match="packing mode"):
        tm.matmul_float(x, data, scale, "int4")

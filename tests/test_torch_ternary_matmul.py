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

from _torch_threads import one_thread  # noqa: F401
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


@pytest.mark.parametrize("m,dtype,want", [
    (1, torch.bfloat16, "gemv"), (8, torch.int8, "gemv"),
    (8, torch.float32, "cuda_core"), (1, torch.float32, "cuda_core"),
    (8, torch.bfloat16, "gemv"), (1, torch.int8, "gemv"),
    (9, torch.bfloat16, "mma"),
    (9, torch.int8, "mma"), (9, torch.float32, "cuda_core"),
    (1024, torch.bfloat16, "mma"), (1024, torch.int8, "mma"),
    (1024, torch.float32, "cuda_core")])
def test_route_follows_rows_and_dtype(m, dtype, want):
    assert tm.route(m, dtype) == want


def test_route_refuses_a_dtype_without_a_kernel():
    with pytest.raises(TypeError, match="no kernel route"):
        tm.route(16, torch.float16)


MMA_SHAPES = [(9, 64, 5), (17, 200, 136), (64, 520, 130), (65, 2048, 1024),
              (144, 2048, 2048), (384, 8192, 2048), (1024, 2048, 1024),
              (1024, 2048, 8192), (1024, 8192, 2048)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k,n", MMA_SHAPES)
def test_mma_plan_splits_k_in_whole_stages_to_fill_the_sms(m, k, n, sms):
    bm, splits, per = tm.mma_plan(m, k, n, sms)
    assert bm == (128 if m <= 128 else 256)
    assert per > 0 and per % tm.MMA_K_CHUNK == 0
    # every split starts inside K and together they cover it
    assert (splits - 1) * per < k <= splits * per
    tiles = -(-n // tm.MMA_BLOCK_N) * -(-m // bm)
    chunks = -(-k // tm.MMA_K_CHUNK)
    # at most about one block per SM, and no fewer than half the splits
    # that would fill them
    assert tiles * splits <= max(tiles, sms)
    assert 2 * splits >= min(chunks, max(1, sms // tiles))


def test_mma_plan_at_the_full_width_prefill():
    """M = 1024 on 132 SMs, 256-row tiles: w1 (256 tiles) runs unsplit;
    w2 and wq (64 tiles) split K in two, wk (32 tiles) in four."""
    assert tm.mma_plan(1024, 2048, 8192, 132) == (256, 1, 2048)
    assert tm.mma_plan(1024, 8192, 2048, 132) == (256, 2, 4096)
    assert tm.mma_plan(1024, 2048, 2048, 132) == (256, 2, 1024)
    assert tm.mma_plan(1024, 2048, 1024, 132) == (256, 4, 512)
    assert tm.mma_plan(256, 2048, 8192, 132) == (256, 2, 1024)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1024), (1, 8192, 2048),
                                   (3, 520, 130), (300, 520, 130),
                                   (1024, 2048, 8192)])
def test_split_k_covers_k_in_whole_chunks(mode, m, k, n):
    splits, per = tm.split_k(m, k, n, mode, 132)
    unit = tm.K_CHUNK * (4 if mode == "trit2" else 1)
    assert per > 0 and per % unit == 0
    assert (splits - 1) * per < k <= splits * per


def test_cpu_wrappers_count_no_route():
    tm.reset_launches()
    for m in (16, 8):
        x, data, scale = _operands(m, 64, 8, "base3", seed=1)
        xt, dt, st = (torch.from_numpy(a) for a in (x, data, scale))
        tm.matmul_float(xt.to(torch.bfloat16), dt, st, "base3")
        tm.matmul_float(xt, dt, st, "base3")
        tm.matmul_int8(*ops.quantize_acts_int8(xt), dt, st, "base3")
    assert tm.ROUTES == {"gemv": 0, "cuda_core": 0, "mma": 0}
    assert tm.LAUNCHES == {"ternary_matmul": 0, "ternary_matmul_int8": 0}


@pytest.mark.parametrize("m", [9, 16, 17, 32, 63, 64, 65, 100, 127, 128])
def test_mma_plan_takes_128_row_tiles_up_to_128_rows(m):
    """Rows past M in a 128-row tile are masked; there is no smaller
    tile."""
    for k, n in ((2048, 2048), (8192, 2048), (64, 5)):
        assert tm.mma_plan(m, k, n, 132)[0] == 128


@pytest.mark.parametrize("bm", [128, 256])
@pytest.mark.parametrize("m,k,n", MMA_SHAPES)
def test_mma_tile_plan_covers_k_at_every_tile_height(m, k, n, bm):
    got_bm, splits, per = tm.mma_tile_plan(m, k, n, 132, bm)
    assert got_bm == bm and per % tm.MMA_K_CHUNK == 0
    assert (splits - 1) * per < k <= splits * per
    tiles = -(-n // tm.MMA_BLOCK_N) * -(-m // bm)
    assert tiles * splits <= max(tiles, 132)


# every packed weight of internlm2-1.8b at full width (K, N): wq/wo,
# wk/wv, w1/w3, w2 and the unembedding (vocab padded to 92672)
MAIN_PATH_KN = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
                (2048, 92672)]
GEMV_SHAPES = MAIN_PATH_KN + [(64, 5), (520, 130), (200, 2050),
                              (8192, 2050), (4, 16), (2048, 7)]


def _check_gemv_plan(m, k, n, mode, sms):
    bn, cluster, per = tm.gemv_plan(m, k, n, mode, sms)
    unit = tm.GEMV_STAGE_ROWS * (4 if mode == "trit2" else 1)
    assert bn in tm.GEMV_BLOCK_NS and bn % 16 == 0
    assert cluster in (1, 2, 4, 8)
    # whole stages (64 packed rows: 16 k16 steps of base3 bf16, 4 packed
    # rows per trit2 k16 step), every split non-empty, together all of K
    assert per > 0 and per % unit == 0
    assert (cluster - 1) * per < k <= cluster * per
    return bn, cluster, per


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8])
def test_gemv_plan_covers_k_in_whole_stages(m, k, n, mode):
    _check_gemv_plan(m, k, n, mode, 132)


@pytest.mark.parametrize("mode", ["base3", "trit2"])
@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_gemv_plan_puts_a_block_on_every_sm(k, n, mode):
    """At every main-path shape the grid holds at least one block per SM
    of an H100 (132) with the widest tile that does so."""
    bn, cluster, _ = _check_gemv_plan(8, k, n, mode, 132)
    assert -(-n // bn) * cluster >= 132
    wider = [b for b in tm.GEMV_BLOCK_NS if b > bn]
    unit = tm.GEMV_STAGE_ROWS * (4 if mode == "trit2" else 1)
    stages = -(-k // unit)
    for b in wider:     # no wider tile could have filled the SMs
        assert all(-(-n // b) * c < 132 for c in (1, 2, 4, 8)
                   if (c - 1) * -(-stages // c) < stages)


def test_gemv_plan_at_the_full_width_decode():
    """M = 8 on 132 SMs: wq and w2 take 64 columns in clusters of 8, wk
    32 columns in clusters of 8, w1 128 columns in clusters of 4, and
    the unembedding 128 columns unsplit; trit2 keeps the tiles."""
    for mode in ("base3", "trit2"):
        assert tm.gemv_plan(8, 2048, 2048, mode, 132) == (64, 8, 256)
        assert tm.gemv_plan(8, 2048, 1024, mode, 132) == (32, 8, 256)
        assert tm.gemv_plan(8, 2048, 8192, mode, 132) == (128, 4, 512)
        assert tm.gemv_plan(8, 8192, 2048, mode, 132) == (64, 8, 1024)
        assert tm.gemv_plan(8, 2048, 92672, mode, 132) == (128, 1, 2048)


@pytest.mark.parametrize("m", [0, 9, 16])
def test_gemv_plan_refuses_rows_off_the_route(m):
    with pytest.raises(ValueError, match="gemv route"):
        tm.gemv_plan(m, 2048, 2048, "base3", 132)

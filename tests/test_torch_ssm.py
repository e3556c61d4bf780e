"""The port's recurrent blocks (``repro_torch.models.ssm``) against the
JAX reference's, on the CPU in f32 at smoke widths: Mamba2's causal
convolution (with and without a carried state), ``mamba2_block`` on a
prompt of 12 positions (one chunk), 300 (zero-padded to two chunks of
256) and 512 (two full chunks) and one recurrent step, the mLSTM in its
parallel (12, 300), chunked (512) and recurrent forms, and the sLSTM
loop over a prompt and one step.

The same numpy-seeded inputs and weights go through both.  Bar: every
output and carried state within 1e-5 of its largest magnitude (f32
summation order only) up to one chunk of 256 positions; past it, and in
the step after such a prompt, within 5e-5.  Past a chunk, Mamba2's
decays exp(cum_t - cum_tau) and mLSTM's stabilizer m difference two f32
cumulative sums of a few hundred log-decays: measured against an f64
evaluation of the same algorithm, the reference's Mamba2 output is
3.8e-6 (300 positions) and 1.2e-5 (512) of its scale off, the port's
7.8e-6 and 8.2e-6, so the two differ by up to 1.7e-5.  The direct SSD
test also holds the port to a one-position-at-a-time f64 recurrence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import attention, ssm

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5                   # relative to the largest magnitude
LONG_TOL = 5e-5              # the same, for prompts past one chunk


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype=jnp.float32),
            dataclasses.replace(configs.smoke(arch), dtype=torch.float32))


def _weights(defs, seed):
    """numpy f32 weights for every leaf of a spec dict (one layer):
    normal draws scaled by 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in defs.items():
        shape = spec.shape[1:]
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        out[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32)
    return out


def _pair(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _tol(s):
    return TOL if s <= ssm.CHUNK else LONG_TOL


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


# ------------------------------------------------------------ Mamba2

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5 if not with_state else 1, 24)).astype(
        np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                jnp.asarray(st) if with_state else None)
    ty, tst = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               torch.from_numpy(st) if with_state else None)
    _close(ty, jy, "y")
    _close(tst, jst, "state")
    # a prompt shorter than the carried width is zero-padded in front
    jy, jst = jssm._causal_conv(jnp.asarray(x[:, :2]), jnp.asarray(w),
                                jnp.asarray(b))
    ty, tst = ssm._causal_conv(torch.from_numpy(x[:, :2]),
                               torch.from_numpy(w), torch.from_numpy(b))
    _close(ty, jy, "short y")
    _close(tst, jst, "short state")


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("zamba2-7b")
    w = _weights(ssm.mamba2_defs(tcfg, 1), seed=2)
    rng = np.random.default_rng(3)
    heads = ssm.mamba2_dims(tcfg)[1]
    w["a_log"] = (0.5 * rng.standard_normal(heads)).astype(np.float32)
    w["dt_bias"] = (0.5 * rng.standard_normal(heads)).astype(np.float32)
    w["conv_b"] = (0.1 * rng.standard_normal(
        w["conv_b"].shape)).astype(np.float32)
    return jcfg, tcfg, _pair(w)


@pytest.mark.parametrize("s", [12, 300, 512])
def test_mamba2_prompt_and_step(mamba, s):
    """The chunked prompt path (one chunk, a padded tail, two full
    chunks), its carried state, then one recurrent step from it."""
    jcfg, tcfg, (jw, tw) = mamba
    tol = _tol(s)
    x = _x(4 + s, 2, s, tcfg.d_model)
    jy, jst = jssm.mamba2_block(jnp.asarray(x), jw, jcfg)
    ty, tst = ssm.mamba2_block(torch.from_numpy(x), tw, tcfg)
    _close(ty, jy, "y", tol)
    _close(tst.h, jst.h, "h", tol)
    _close(tst.conv, jst.conv, "conv")
    assert tst.index == int(jst.index) == s
    x1 = _x(5, 2, 1, tcfg.d_model)
    jy, jst = jssm.mamba2_block(jnp.asarray(x1), jw, jcfg, jst)
    ty, tst = ssm.mamba2_block(torch.from_numpy(x1), tw, tcfg, tst)
    _close(ty, jy, "step y", tol)
    _close(tst.h, jst.h, "step h", tol)
    _close(tst.conv, jst.conv, "step conv")


def test_mamba2_ssd_chunked_directly(mamba):
    """``_ssd_chunked`` on its own at two chunks, against the reference
    and against a one-position-at-a-time recurrence."""
    rng = np.random.default_rng(6)
    b, s, h, hd, st = 1, 512, 2, 8, 4
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.1
    a_log = rng.standard_normal(h).astype(np.float32) * 0.3
    B = rng.standard_normal((b, s, st)).astype(np.float32)
    C = rng.standard_normal((b, s, st)).astype(np.float32)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (xh, dt, a_log, B, C)))
    ty, th = ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a_log, B, C)))
    _close(ty, jy, "y", LONG_TOL)
    _close(th, jh, "h", LONG_TOL)
    a = np.exp(dt * -np.exp(a_log))
    hcur = np.zeros((b, h, hd, st), np.float64)
    ys = []
    for t in range(s):
        hcur = (a[:, t, :, None, None] * hcur + np.einsum(
            "bh,bs,bhd->bhds", dt[:, t], B[:, t], xh[:, t]))
        ys.append(np.einsum("bs,bhds->bhd", C[:, t], hcur))
    _close(ty, np.stack(ys, 1).astype(np.float32), "y vs recurrence",
           LONG_TOL)


# ------------------------------------------------------------ xLSTM

@pytest.fixture(scope="module")
def xlstm():
    jcfg, tcfg = _cfgs("xlstm-125m")
    return (jcfg, tcfg, _pair(_weights(ssm.mlstm_defs(tcfg, 1), seed=7)),
            _pair(_weights(ssm.slstm_defs(tcfg, 1), seed=8)))


@pytest.mark.parametrize("s", [12, 300, 512])
def test_mlstm_prompt_and_step(xlstm, s):
    """Parallel (12, 300) and chunked (512) prompt forms, their final
    state, then the recurrent form from it."""
    jcfg, tcfg, (jw, tw), _ = xlstm
    tol = _tol(s)
    x = _x(10 + s, 2, s, tcfg.d_model)
    jy, jst = jssm.mlstm_block(jnp.asarray(x), jw, jcfg)
    ty, tst = ssm.mlstm_block(torch.from_numpy(x), tw, tcfg)
    _close(ty, jy, "y", tol)
    for name in ("C", "n", "m"):
        _close(getattr(tst, name), getattr(jst, name), name, tol)
    x1 = _x(11, 2, 1, tcfg.d_model)
    jy, jst = jssm.mlstm_block(jnp.asarray(x1), jw, jcfg, jst)
    ty, tst = ssm.mlstm_block(torch.from_numpy(x1), tw, tcfg, tst)
    _close(ty, jy, "step y", tol)
    for name in ("C", "n", "m"):
        _close(getattr(tst, name), getattr(jst, name), "step " + name, tol)


def test_mlstm_final_state_matches_recurrence(xlstm):
    """``_mlstm_final_state`` against the recurrent form run one
    position at a time from the zero state."""
    jcfg, tcfg, (jw, tw), _ = xlstm
    x = _x(12, 1, 9, tcfg.d_model)
    _, want = ssm.mlstm_block(torch.from_numpy(x), tw, tcfg)
    st = ssm.init_xlstm_state(1, tcfg, "mlstm", device="cpu")
    for t in range(9):
        _, st = ssm.mlstm_block(torch.from_numpy(x[:, t:t + 1]), tw, tcfg,
                                st)
    # the recurrence's running max starts at -1e30, the closed form's at
    # the true max: the states agree once both are taken to one scale
    for name in ("C", "n"):
        got = getattr(st, name) * torch.exp(st.m).reshape(
            st.m.shape + (1,) * (getattr(st, name).dim() - 2))
        ref = getattr(want, name) * torch.exp(want.m).reshape(
            want.m.shape + (1,) * (getattr(want, name).dim() - 2))
        _close(got, ref.numpy(), name)


@pytest.mark.parametrize("s", [1, 12])
def test_slstm_prompt_and_step(xlstm, s):
    jcfg, tcfg, _, (jw, tw) = xlstm
    x = _x(20 + s, 2, s, tcfg.d_model)
    jy, jst = jssm.slstm_block(jnp.asarray(x), jw, jcfg)
    ty, tst = ssm.slstm_block(torch.from_numpy(x), tw, tcfg)
    _close(ty, jy, "y")
    for name in ("C", "n", "m", "h"):
        _close(getattr(tst, name), getattr(jst, name), name)
    x1 = _x(21, 2, 1, tcfg.d_model)
    jy, jst = jssm.slstm_block(jnp.asarray(x1), jw, jcfg, jst)
    ty, tst = ssm.slstm_block(torch.from_numpy(x1), tw, tcfg, tst)
    _close(ty, jy, "step y")
    for name in ("C", "n", "m", "h"):
        _close(getattr(tst, name), getattr(jst, name), "step " + name)
    assert tst.index == int(jst.index) == s + 1


def test_state_initializers_match_the_reference():
    jcfg, tcfg = _cfgs("zamba2-7b")
    jm = jssm.init_mamba2_state(3, jcfg)
    tm = ssm.init_mamba2_state(3, tcfg, device="cpu")
    assert tm.h.shape == jm.h.shape and tm.conv.shape == jm.conv.shape
    jcfg, tcfg = _cfgs("xlstm-125m")
    for kind in ("mlstm", "slstm"):
        js = jssm.init_xlstm_state(2, jcfg, kind)
        ts = ssm.init_xlstm_state(2, tcfg, kind, device="cpu")
        for name in ("C", "n", "m", "h"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)))


STATE_CONSTRUCTORS = {
    "attention.init_cache": lambda cfg: attention.init_cache(
        1, 8, cfg.num_kv_heads, cfg.hd, kv_cache_dtype="int8"),
    "ssm.init_mamba2_state": lambda cfg: ssm.init_mamba2_state(1, cfg),
    "ssm.init_xlstm_state": lambda cfg: ssm.init_xlstm_state(1, cfg,
                                                             "mlstm"),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: "
                    "the default device resolves")
@pytest.mark.parametrize("name", sorted(STATE_CONSTRUCTORS))
def test_state_constructors_ask_for_the_card_by_default(name):
    """With no ``device`` the state constructors allocate on the card,
    and raise on a host without one."""
    arch = "xlstm-125m" if "xlstm" in name else "zamba2-7b"
    with pytest.raises(RuntimeError, match="cuda"):
        STATE_CONSTRUCTORS[name](_cfgs(arch)[1])

"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM, sLSTM).

Plain functions on tensors, with the reference's f32 accumulation.  Every
projection goes through ``layers.dense``, so through the CIM modes and
the ``ternary_matmul`` kernels; the einsums stay plain torch.

Mamba2 runs the chunked SSD algorithm for a prompt (a quadratic part
inside chunks of ``CHUNK`` positions, a scan over chunk states between
them; a prompt past ``CHUNK`` is zero-padded to a multiple of it) and a
one-step recurrence in decode, carrying ``h (B, heads, hd, state)`` and
the causal convolution's last 3 inputs.  mLSTM runs the stabilized
parallel form for a prompt (the chunked form when the prompt is a
multiple of ``CHUNK`` past it) and the recurrent matrix-memory form in
decode.  sLSTM is a sequential loop over time.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import resolve_device
from .config import ModelConfig, ParamSpec
from .layers import dense, rms_norm, silu

CHUNK = 256


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _root(hd: int, dtype) -> float:
    """sqrt(hd) rounded to `dtype`, computed on the host."""
    return float(torch.tensor(float(hd), dtype=dtype).sqrt())


# ===================================================================
# Mamba2
# ===================================================================

class Mamba2State(NamedTuple):
    h: torch.Tensor        # (B, heads, hd, state) f32
    conv: torch.Tensor     # (B, conv_width - 1, conv_dim)
    index: Any


def mamba2_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    heads = d_inner // 64
    hd = 64
    state = cfg.ssm_state or 64
    groups = 1                      # B/C shared across heads
    conv_dim = d_inner + 2 * groups * state
    return d_inner, heads, hd, state, groups, conv_dim


def mamba2_defs(cfg: ModelConfig, layers: int) -> dict:
    d = cfg.d_model
    d_inner, heads, hd, state, groups, conv_dim = mamba2_dims(cfg)
    L = (layers,)
    in_dim = 2 * d_inner + 2 * groups * state + heads   # z, x, B, C, dt
    return {"in_proj": ParamSpec(L + (d, in_dim),
                                 axes=("layers", "embed", "inner")),
            "conv_w": ParamSpec(L + (4, conv_dim),
                                axes=("layers", "none", "inner")),
            "conv_b": ParamSpec(L + (conv_dim,), "zeros",
                                axes=("layers", "inner")),
            "a_log": ParamSpec(L + (heads,), "zeros",
                               axes=("layers", "none")),
            "dt_bias": ParamSpec(L + (heads,), "zeros",
                                 axes=("layers", "none")),
            "d_skip": ParamSpec(L + (heads,), "ones",
                                axes=("layers", "none")),
            "norm": ParamSpec(L + (d_inner,), "ones",
                              axes=("layers", "inner")),
            "out_proj": ParamSpec(L + (d_inner, d),
                                  axes=("layers", "inner", "embed"))}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution of width 4: x (B, S, C), w (4, C).
    Returns (silu(y), the last 3 inputs), the inputs before x being
    zeros or ``state`` (B, 3, C)."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        y = None
        for i in range(width):
            shift = width - 1 - i      # pads[i][t] = x[t - shift]
            xi = F.pad(x, (0, 0, shift, 0))[:, :s]
            y = xi * w[i] if y is None else y + xi * w[i]
        y = y + b
        new_state = (x[:, -(width - 1):] if s >= width - 1
                     else F.pad(x, (0, 0, width - 1 - s, 0)))
    else:
        buf = torch.cat([state, x], dim=1)
        y = None
        for i in range(width):
            term = buf[:, i:i + s] * w[i]
            y = term if y is None else y + term
        y = y + b
        new_state = buf[:, -(width - 1):]
    return silu(y), new_state


def _ssd_chunked(xh, dt, a_log, B, C):
    """Chunked SSD scan.  xh (B, S, H, hd), dt (B, S, H) (after the
    softplus), B/C (B, S, state).  Returns y (B, S, H, hd) f32 and the
    final state (B, H, hd, state)."""
    b, s, h, hd = xh.shape
    st = B.shape[-1]
    c = min(CHUNK, s)
    nch = s // c
    if nch * c != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    loga = -torch.exp(a_log.float())                    # (H,) negative
    dl = dt.float() * loga                              # per-token log decay
    cum = torch.cumsum(dl.reshape(b, nch, c, h), dim=2)
    xc = xh.reshape(b, nch, c, h, hd).float()
    Bc = B.reshape(b, nch, c, st).float()
    Cc = C.reshape(b, nch, c, st).float()
    dtc = dt.reshape(b, nch, c, h).float()

    # intra-chunk: score[t, tau] = exp(cum_t - cum_tau) (C_t . B_tau)
    # dt_tau for tau <= t
    gap = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,n,c,c,h)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=xh.device))
    # masked before the exp: off the triangle gap > 0 may pass 88, where
    # exp overflows and where(tri, exp(gap), 0)'s gradient is 0 * inf
    decay = torch.exp(torch.where(tri[None, None, :, :, None], gap,
                                  -math.inf))
    cb = torch.einsum("bncs,bnts->bnct", Cc, Bc)
    w_intra = decay * cb[..., None] * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bntuh,bnuhd->bnthd", w_intra, xc)

    # chunk states: sum over tau of exp(cum_end - cum_tau) dt B x^T
    end_gap = cum[:, :, -1:, :] - cum
    contrib = torch.einsum("bnch,bncs,bnchd->bnhds",
                           torch.exp(end_gap) * dtc, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (b,n,h)
    hcur = torch.zeros((b, h, hd, st), dtype=torch.float32,
                       device=xh.device)
    hprevs = []
    for n in range(nch):
        hprevs.append(hcur)
        hcur = chunk_decay[:, n, :, None, None] * hcur + contrib[:, n]
    hprev = torch.stack(hprevs, dim=1)                 # (b,n,h,hd,st)

    # inter-chunk: y_t += C_t . (exp(cum_t) * h at the chunk's start)
    y_inter = torch.einsum("bncs,bnch,bnhds->bnchd", Cc, torch.exp(cum),
                           hprev)
    return (y_intra + y_inter).reshape(b, s, h, hd), hcur


def mamba2_block(x, w, cfg: ModelConfig, state: Optional[Mamba2State] = None,
                 cim_cfg=None):
    """x (B, S, D) -> (y, new state).  Without a state, or for S > 1, the
    chunked path (a prompt starts from an empty state); else the
    recurrent one-token step."""
    b, s, d = x.shape
    d_inner, heads, hd, st, groups, conv_dim = mamba2_dims(cfg)
    zxbcdt = dense(x, w["in_proj"], cim_cfg)
    z, xin, Bc, Cc, dt = torch.split(
        zxbcdt, [d_inner, d_inner, st, st, heads], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, w["conv_w"], w["conv_b"],
                                      None if state is None else state.conv)
    xin, Bc, Cc = torch.split(conv_out, [d_inner, st, st], dim=-1)
    dt = _softplus(dt.float() + w["dt_bias"])                   # (B,S,H)
    xh = xin.reshape(b, s, heads, hd)
    if state is None or s > 1:
        pad = -s % CHUNK if s > CHUNK else 0
        xp, dtp, Bp, Cp = xh, dt, Bc, Cc
        if pad:
            xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dtp = F.pad(dt, (0, 0, 0, pad))
            Bp = F.pad(Bc, (0, 0, 0, pad))
            Cp = F.pad(Cc, (0, 0, 0, pad))
        y, hlast = _ssd_chunked(xp, dtp, w["a_log"], Bp, Cp)
        y = y[:, :s]
        new_state = Mamba2State(hlast, new_conv, s)
    else:
        loga = -torch.exp(w["a_log"].float())
        a = torch.exp(dt[:, 0] * loga)                          # (B,H)
        dBx = torch.einsum("bh,bs,bhd->bhds", dt[:, 0], Bc[:, 0].float(),
                           xh[:, 0].float())
        hnew = a[..., None, None] * state.h + dBx
        y = torch.einsum("bs,bhds->bhd", Cc[:, 0].float(), hnew)[:, None]
        new_state = Mamba2State(hnew, new_conv, state.index + 1)
    y = y.to(x.dtype).reshape(b, s, d_inner)
    y = y + xh.reshape(b, s, d_inner) * torch.repeat_interleave(
        w["d_skip"], hd).to(x.dtype)
    y = rms_norm(y * silu(z), w["norm"], cfg.norm_eps)
    return dense(y, w["out_proj"], cim_cfg), new_state


def init_mamba2_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                      device="cuda") -> Mamba2State:
    device = resolve_device(device)
    d_inner, heads, hd, st, groups, conv_dim = mamba2_dims(cfg)
    return Mamba2State(
        torch.zeros((batch, heads, hd, st), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, 3, conv_dim), dtype=dtype, device=device), 0)


# ===================================================================
# xLSTM
# ===================================================================

class XLSTMState(NamedTuple):
    # mLSTM: matrix memory; sLSTM: scalar tuples, both in one shape
    C: torch.Tensor        # (B, H, hd, hd) mLSTM / (B, H, hd, 1) sLSTM c
    n: torch.Tensor        # (B, H, hd)
    m: torch.Tensor        # (B, H)
    h: torch.Tensor        # (B, H, hd) (sLSTM's recurrent h)
    index: Any


def xlstm_dims(cfg: ModelConfig):
    heads = cfg.num_heads
    d_up = 2 * cfg.d_model
    return d_up, heads, d_up // heads


def mlstm_defs(cfg: ModelConfig, layers: int) -> dict:
    d = cfg.d_model
    d_up, heads, hd = xlstm_dims(cfg)
    L = (layers,)
    return {"up": ParamSpec(L + (d, 2 * d_up),
                            axes=("layers", "embed", "inner")),
            "wq": ParamSpec(L + (d_up, d_up),
                            axes=("layers", "inner", "heads")),
            "wk": ParamSpec(L + (d_up, d_up),
                            axes=("layers", "inner", "heads")),
            "wv": ParamSpec(L + (d_up, d_up),
                            axes=("layers", "inner", "heads")),
            "wif": ParamSpec(L + (d_up, 2 * heads),
                             axes=("layers", "inner", "none")),
            "norm": ParamSpec(L + (d_up,), "ones",
                              axes=("layers", "inner")),
            "down": ParamSpec(L + (d_up, d),
                              axes=("layers", "inner", "embed"))}


def slstm_defs(cfg: ModelConfig, layers: int) -> dict:
    d = cfg.d_model
    heads = cfg.num_heads
    hd = d // heads
    L = (layers,)
    return {"wx": ParamSpec(L + (d, 4 * d),
                            axes=("layers", "embed", "inner")),
            "wr": ParamSpec(L + (heads, hd, 4 * hd),
                            axes=("layers", "none", "none", "none")),
            "norm": ParamSpec(L + (d,), "ones", axes=("layers", "embed")),
            "up1": ParamSpec(L + (d, 4 * d // 3),
                             axes=("layers", "embed", "mlp")),
            "up2": ParamSpec(L + (4 * d // 3, d),
                             axes=("layers", "mlp", "embed"))}


def _mlstm_chunked(q, k, v, logi, logf, chunk: int = CHUNK):
    """Chunked mLSTM: the parallel form inside chunks, the (C, n, m)
    state carried across them with max-stabilization.  q/k/v (B, S, H,
    hd), k scaled by 1/sqrt(hd); logi/logf (B, S, H).  Returns y (B, S,
    H, hd) f32 and the final (C, n, m)."""
    b, s, h, hd = q.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    nch = s // c
    qc = q.reshape(b, nch, c, h, hd).float()
    kc = k.reshape(b, nch, c, h, hd).float()
    vc = v.reshape(b, nch, c, h, hd).float()
    lic = logi.reshape(b, nch, c, h)
    lfc = logf.reshape(b, nch, c, h)
    dev = q.device
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=dev))[None, :, :, None]
    C = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, h), -1e30, dtype=torch.float32, device=dev)
    ys = []
    for j in range(nch):
        qb, kb, vb, li, lf = qc[:, j], kc[:, j], vc[:, j], lic[:, j], lfc[:, j]
        Fc = torch.cumsum(lf, dim=1)                    # (B,c,H)
        sc = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
        sc = torch.where(tri, sc, -math.inf)
        m_inter = Fc + m[:, None, :]
        m_intra = sc.amax(dim=2)
        m_tot = torch.maximum(m_inter, m_intra)
        d_intra = torch.exp(sc - m_tot[:, :, None, :])
        d_inter = torch.exp(m_inter - m_tot)
        qk = torch.einsum("bthd,buhd->btuh", qb, kb)
        num = (torch.einsum("btuh,buhd->bthd", qk * d_intra, vb)
               + d_inter[..., None] * torch.einsum("bhde,bthe->bthd", C, qb))
        den = (torch.einsum("btuh,buhd,bthd->bth", d_intra, kb, qb)
               + d_inter * torch.einsum("bhe,bthe->bth", n, qb))
        ys.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_tot))[..., None])
        Fend = Fc[:, -1, :]
        m_new = torch.maximum(Fend + m,
                              (Fend[:, None, :] - Fc + li).amax(dim=1))
        wgt = torch.exp(Fend[:, None, :] - Fc + li - m_new[:, None, :])
        dec = torch.exp(Fend + m - m_new)
        C = (dec[..., None, None] * C
             + torch.einsum("buh,buhd,buhe->bhde", wgt, vb, kb))
        n = dec[..., None] * n + torch.einsum("buh,buhd->bhd", wgt, kb)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)
    return y, (C, n, m)


def _mlstm_final_state(k, v, logi, logf, b, heads, hd):
    """The recurrent state of having consumed the whole prefix."""
    s = k.shape[1]
    Fc = torch.cumsum(logf, dim=1)
    sc = (Fc[:, -1:, :] - Fc) + logi                    # (B,S,H)
    m = sc.amax(dim=1)                                  # (B,H)
    wgt = torch.exp(sc - m[:, None, :])
    C = torch.einsum("buh,buhd,buhe->bhde", wgt, v.float(), k.float())
    n = torch.einsum("buh,buhd->bhd", wgt, k.float())
    return XLSTMState(C, n, m, torch.zeros((b, heads, hd),
                                           dtype=torch.float32,
                                           device=k.device), s)


def mlstm_block(x, w, cfg: ModelConfig, state: Optional[XLSTMState] = None,
                cim_cfg=None):
    """mLSTM: the parallel form without a state (chunked when the prompt
    is a multiple of ``CHUNK`` past it), the recurrent form with one."""
    b, s, d = x.shape
    d_up, heads, hd = xlstm_dims(cfg)
    u, gate = torch.chunk(dense(x, w["up"], cim_cfg), 2, dim=-1)
    q = dense(u, w["wq"], cim_cfg).reshape(b, s, heads, hd)
    k = dense(u, w["wk"], cim_cfg).reshape(b, s, heads, hd) / _root(
        hd, x.dtype)
    v = dense(u, w["wv"], cim_cfg).reshape(b, s, heads, hd)
    i_f = dense(u, w["wif"], cim_cfg).float().reshape(b, s, heads, 2)
    logi, logf_raw = i_f[..., 0], i_f[..., 1]
    logf = F.logsigmoid(logf_raw)                       # (B,S,H)

    if state is None:
        if s > CHUNK and s % CHUNK == 0:
            y, (C, n, m) = _mlstm_chunked(q, k, v, logi, logf)
            new_state = XLSTMState(C, n, m, torch.zeros(
                (b, heads, hd), dtype=torch.float32, device=x.device), s)
        else:
            Fc = torch.cumsum(logf, dim=1)
            sc = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]
            tri = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                        device=x.device))[None, :, :, None]
            sc = torch.where(tri, sc, -math.inf)
            mstab = sc.amax(dim=2, keepdim=True)        # (B,S,1,H)
            dmat = torch.exp(sc - mstab)
            qk = torch.einsum("bthd,buhd->btuh", q.float(), k.float())
            att = qk * dmat
            norm = torch.maximum(att.sum(dim=2).abs(),
                                 torch.exp(-mstab[:, :, 0, :]))
            y = torch.einsum("btuh,buhd->bthd", att, v.float())
            y = y / norm[..., None]
            new_state = _mlstm_final_state(k, v, logi, logf, b, heads, hd)
    else:
        m_prev, C_prev, n_prev = state.m, state.C, state.n
        m_new = torch.maximum(logf[:, 0] + m_prev, logi[:, 0])
        fdec = torch.exp(logf[:, 0] + m_prev - m_new)
        iamp = torch.exp(logi[:, 0] - m_new)
        k0, v0, q0 = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
        C_new = (fdec[..., None, None] * C_prev
                 + iamp[..., None, None] * torch.einsum("bhd,bhe->bhde",
                                                        v0, k0))
        n_new = fdec[..., None] * n_prev + iamp[..., None] * k0
        num = torch.einsum("bhde,bhe->bhd", C_new, q0)
        den = torch.maximum(torch.einsum("bhe,bhe->bh", n_new, q0).abs(),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, None]
        new_state = XLSTMState(C_new, n_new, m_new, state.h,
                               state.index + 1)
    y = y.to(x.dtype).reshape(b, s, d_up)
    y = rms_norm(y, w["norm"], cfg.norm_eps) * silu(gate)
    return dense(y, w["down"], cim_cfg), new_state


def slstm_block(x, w, cfg: ModelConfig, state: Optional[XLSTMState] = None,
                cim_cfg=None):
    """sLSTM: a sequential loop over time with exponential gating per
    head; the recurrent weight ``wr`` is read as a float tensor."""
    b, s, d = x.shape
    heads = cfg.num_heads
    hd = d // heads
    gates_x = dense(x, w["wx"], cim_cfg).float().reshape(b, s, 4, heads, hd)
    wr = w["wr"].float()                                # (H, hd, 4hd)
    dev = x.device
    if state is None:
        c = torch.zeros((b, heads, hd), dtype=torch.float32, device=dev)
        n = torch.ones((b, heads, hd), dtype=torch.float32, device=dev)
        m = torch.zeros((b, heads), dtype=torch.float32, device=dev)
        h = torch.zeros((b, heads, hd), dtype=torch.float32, device=dev)
    else:
        c, n, m, h = state.C[..., 0], state.n, state.m, state.h
    n_floor = torch.full((), 1e-6, dtype=torch.float32, device=dev)
    ys = []
    for t in range(s):
        gx = gates_x[:, t]                              # (B,4,H,hd)
        rec = torch.einsum("bhd,hde->bhe", h, wr).reshape(b, heads, 4, hd)
        zi = gx[:, 0] + rec[:, :, 0]
        ii = gx[:, 1] + rec[:, :, 1]
        fi = gx[:, 2] + rec[:, :, 2]
        oi = gx[:, 3] + rec[:, :, 3]
        logf = F.logsigmoid(fi).mean(dim=-1)            # a gate per head
        logi = ii.mean(dim=-1)
        m_new = torch.maximum(logf + m, logi)
        fdec = torch.exp(logf + m - m_new)[..., None]
        iamp = torch.exp(logi - m_new)[..., None]
        c = fdec * c + iamp * torch.tanh(zi)
        n = fdec * n + iamp
        m = m_new
        # torch.maximum, as jnp.maximum, splits the gradient at a tie
        h = torch.sigmoid(oi) * (c / torch.maximum(n, n_floor))
        ys.append(h)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, w["norm"], cfg.norm_eps)
    y = dense(F.gelu(dense(y, w["up1"], cim_cfg), approximate="tanh"),
              w["up2"], cim_cfg)
    index = state.index + s if state is not None else s
    return y, XLSTMState(c[..., None], n, m, h, index)


def init_xlstm_state(batch: int, cfg: ModelConfig, kind: str,
                     device="cuda") -> XLSTMState:
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    if kind == "mlstm":
        d_up, heads, hd = xlstm_dims(cfg)
        return XLSTMState(torch.zeros((batch, heads, hd, hd), **f32),
                          torch.zeros((batch, heads, hd), **f32),
                          torch.full((batch, heads), -1e30, **f32),
                          torch.zeros((batch, heads, hd), **f32), 0)
    heads = cfg.num_heads
    hd = cfg.d_model // heads
    return XLSTMState(torch.zeros((batch, heads, hd, 1), **f32),
                      torch.ones((batch, heads, hd), **f32),
                      torch.zeros((batch, heads), **f32),
                      torch.zeros((batch, heads, hd), **f32), 0)

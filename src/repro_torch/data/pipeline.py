"""The deterministic synthetic data pipeline, as the reference's
``repro.data.pipeline``: bit for bit the same tokens.

``lm_batch(cfg, step)`` is a function of the config and the step only:
row ``r`` draws from ``fold_in(fold_in(key(seed), step), r)``, split into
four keys (restarts, restart tokens, noise, noise tokens), through
``core.prng``, which reproduces ``jax.random``'s threefry bits and
launches the ``threefry`` kernel on the card.  A host draws only its
slice of the rows, and a replay after a crash draws the same batch.

The tokens follow the affine chain ``t' = (31 t + 17) mod v`` with
random restarts and replacement noise.  The reference runs the chain as
a scan over the positions; here it is closed-form and vectorised over
rows: ``j`` positions after the last restart at token ``r``, the token
is ``(P[j] r + Q[j]) mod v`` with ``P[j] = 31^j`` and ``Q[j] = 17 (31^j
- 1) / 30`` mod v, tabulated on the host.  Integer arithmetic, so exact.

``v = chain_vocab or min(vocab, 4096)``; ``prng.randint`` draws spans
below 2^15, so a larger ``chain_vocab`` raises.  ``batch_for`` adds no
modality inputs: the reference draws the audio and vlm families'
frames or patches with ``jax.random.normal`` in bf16, which
``prng.normal`` (f32) does not reproduce; those families wait with
their training forward (ROADMAP queue 1 item 9) and raise here.

The classification task (the paper's CIFAR-10 stand-in): class means
``snr * mu / |mu|`` from ``normal(key(seed + 101))``, and per step
labels from ``randint`` and Gaussian noise from ``normal`` of the split
of ``fold_in(key(seed), step)``.  ``normal`` is within a few ulp of
``jax.random.normal``, the labels bitwise.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..core import prng

# chain coefficients: any a coprime with V works; fixed across the run
_A, _B = 31, 17


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    restart_p: float = 0.02        # chain resets (irreducible entropy)
    noise_p: float = 0.02          # token replacement noise
    chain_vocab: int = 0           # 0 -> min(vocab, 4096)

    @property
    def v(self) -> int:
        return self.chain_vocab or min(self.vocab_size, 4096)


def entropy_floor(cfg: DataConfig) -> float:
    """Lower bound on achievable mean NLL (nats/token) for the chain task."""
    v = cfg.v
    p_det = (1 - cfg.restart_p) * (1 - cfg.noise_p)
    p_rand = 1 - p_det
    # deterministic next token w.p. p_det, uniform otherwise
    h = -(p_det + p_rand / v) * math.log(p_det + p_rand / v)
    h -= p_rand * (v - 1) / v * math.log(p_rand / v)
    return h


def _chain_tables(v: int, n: int, device) -> tuple:
    """(P, Q) of length n: j steps of the chain from token r land on
    (P[j] r + Q[j]) mod v."""
    p, q = [1], [0]
    for _ in range(n - 1):
        p.append(_A * p[-1] % v)
        q.append((_A * q[-1] + _B) % v)
    return (torch.tensor(p, dtype=torch.int64, device=device),
            torch.tensor(q, dtype=torch.int64, device=device))


def _rows(keys: list, cfg: DataConfig, device) -> torch.Tensor:
    """(len(keys), seq_len + 1) int32 token rows, one per row key."""
    v = cfg.v
    n = cfg.seq_len + 1
    draws = []
    for k in keys:
        k0, k1, k2, k3 = prng.split(k, 4)
        draws.append((prng.bernoulli(k0, cfg.restart_p, (n,), device),
                      prng.randint(k1, (n,), 0, v, device),
                      prng.bernoulli(k2, cfg.noise_p, (n,), device),
                      prng.randint(k3, (n,), 0, v, device)))
    restart, restart_tok, noise, noise_tok = (torch.stack(d)
                                              for d in zip(*draws))
    pos = torch.arange(n, device=device)
    # position 0 starts the chain at its restart token
    starts = torch.where(restart | (pos == 0), pos, 0)
    last = torch.cummax(starts, dim=1).values
    p, q = _chain_tables(v, n, device)
    j = pos - last
    r = torch.gather(restart_tok, 1, last).to(torch.int64)
    chain = (p[j] * r + q[j]) % v
    return torch.where(noise, noise_tok.to(torch.int64), chain).to(
        torch.int32)


def lm_batch(cfg: DataConfig, step: int, host_index: int = 0,
             num_hosts: int = 1, device="cuda") -> dict:
    """{tokens, labels}: this host's (B_local, S) int32 slice of the
    global step's data, on ``device``."""
    if not 0 < cfg.v < 1 << 15:
        raise ValueError(f"chain vocab {cfg.v} outside [1, 2^15): "
                         f"prng.randint draws spans below 2^15")
    device = resolve_device(device)
    b_local = cfg.global_batch // num_hosts
    base = prng.fold_in(prng.key(cfg.seed), int(step))
    keys = [prng.fold_in(base, host_index * b_local + r)
            for r in range(b_local)]
    toks = _rows(keys, cfg, device)                       # (B, S+1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_for(model_cfg, cfg: DataConfig, step: int, host_index: int = 0,
              num_hosts: int = 1, device="cuda") -> dict:
    """The model family's batch: the LM batch for dense and MoE; the
    audio and vlm families raise (see the module docstring)."""
    if model_cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"batch_for {model_cfg.name} (family {model_cfg.family!r}): "
            f"the reference draws its frames/patches with a bf16 "
            f"jax.random.normal, not ported (ROADMAP queue 1 item 9)")
    return lm_batch(cfg, step, host_index, num_hosts, device)


# ----------------------------------------------------------------------
# classification task (the paper's accuracy substrate, CIFAR-10 stand-in)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassTaskConfig:
    num_classes: int = 10
    dim: int = 128
    snr: float = 2.0               # class-mean norm / noise std
    seed: int = 0


def class_means(cfg: ClassTaskConfig, device="cuda") -> torch.Tensor:
    """(num_classes, dim) f32 means of norm ``snr``."""
    mu = prng.normal(prng.key(cfg.seed + 101), (cfg.num_classes, cfg.dim),
                     device)
    norm = prng._sqrt_rn(torch.sum(mu * mu, dim=1, keepdim=True))
    return cfg.snr * mu / norm


def class_batch(cfg: ClassTaskConfig, step: int, batch: int = 256,
                device="cuda") -> dict:
    """{x (batch, dim) f32, y (batch,) int32} of the step."""
    device = resolve_device(device)
    key = prng.fold_in(prng.key(cfg.seed), int(step))
    ky, kx = prng.split(key)
    y = prng.randint(ky, (batch,), 0, cfg.num_classes, device)
    x = class_means(cfg, device)[y.long()] + prng.normal(
        kx, (batch, cfg.dim), device)
    return {"x": x.to(torch.float32), "y": y.to(torch.int32)}

"""What the training-stack parity files (``test_torch_train.py`` and
``test_torch_train_ft.py``) share: the thread pin, the tolerance helper
and the reference's side of their fixtures (smoke models and params made
by ``repro``, carried across as numpy)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from repro import configs as jconfigs
from repro.kernels import cim_mac as jcim_mac
from repro.kernels import ref as jref
from repro.models import registry as jregistry
from repro_torch import configs
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def within_ulps(got, want, n: int) -> bool:
    """|got - want| <= n ulp of the tensor's largest magnitude (f32)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = np.float32(np.abs(want).max()) if want.size else np.float32(0)
    return bool(np.all(np.abs(got - want) <= n * np.spacing(top)))


def ref_model(arch: str, dtype: str = "f32"):
    cfg = dataclasses.replace(jconfigs.smoke(arch), dtype=DTYPES[dtype][0])
    return jregistry.build(cfg)


def port_model(arch: str, dtype: str = "f32"):
    cfg = dataclasses.replace(configs.smoke(arch), dtype=DTYPES[dtype][1])
    return registry.build(cfg)


def lm_tokens(vocab: int, batch: int, seq: int, seed: int) -> dict:
    """A seeded numpy batch: tokens and their shifted labels, the first
    three labels of row 0 masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


@contextlib.contextmanager
def oracle_cim_mac():
    """The reference's exact plans through its cim_mac oracle (the Pallas
    kernel in interpret mode compiles for a minute per graph here)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcim_mac, "cim_mac",
               lambda x, w, adc_bits, **_: jref.cim_mac_ref(x, w, adc_bits))
    try:
        yield
    finally:
        mp.undo()


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

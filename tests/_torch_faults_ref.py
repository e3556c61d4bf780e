"""What the device-fidelity parity files (``test_torch_faults.py`` and
``test_torch_faults_serving.py``) share: the restore yields, the campaign
reset, and the smoke internlm2 tree packed by the reference and carried
across (made once per worker)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import faults as jfaults
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import ternarize_params as jternarize
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro_torch import configs, faults
from repro_torch.convert import params_from_reference
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")

YIELDS = (0.97, 0.995, 0.96)


@pytest.fixture(autouse=True)
def restore_campaigns():
    """Each test starts and leaves both packages without a campaign."""
    jprev = jfaults.set_fault_model(jfaults.FaultModel())
    prev = faults.set_fault_model(faults.FaultModel())
    yield
    jfaults.set_fault_model(jprev)
    faults.set_fault_model(prev)


@functools.lru_cache(maxsize=None)
def smoke_setup():
    """(jcfg, jm, tm, jparams, tparams): smoke internlm2-1.8b in f32,
    base3-packed by the reference, converted in the port's key order."""
    jcfg = dataclasses.replace(jconfigs.smoke("internlm2-1.8b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.smoke("internlm2-1.8b"),
                               dtype=torch.float32)
    jm, tm = jregistry.build(jcfg), registry.build(tcfg)
    jparams = jternarize(jax.jit(jm.init)(jax.random.key(0)),
                         JCIMConfig(mode="ternary", packing="base3"))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jm, tm, jparams, model_order(tparams, tm.param_specs)


def model_order(tree, specs):
    """The converted tree (sorted keys, as jax.tree.map leaves it) in the
    port's own key order (``model.init``'s): leaf numbering must not
    depend on it."""
    if isinstance(tree, dict):
        return {k: model_order(tree[k], specs[k]) for k in specs}
    return tree


def packed_bytes_equal(jtree, ttree):
    jl = [x for x in jax.tree_util.tree_leaves(
        jtree, is_leaf=lambda x: isinstance(x, jops.PackedTernary))
        if isinstance(x, jops.PackedTernary)]
    tl = [leaf for _, leaf in faults.scrub.packed_leaves(ttree)]
    return len(jl) == len(tl) > 0 and all(
        np.array_equal(np.asarray(a.data), b.data.numpy())
        for a, b in zip(jl, tl))

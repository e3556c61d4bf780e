"""The port's sharding layer (``repro_torch.dist``) against the
reference's ``repro.dist``, all pure (no process group):

  * ``spec_for`` for every device count up to 512, one and two pods;
  * every parameter and decode-state leaf's logical axes, for the ten
    architectures at full width, equal the reference's ``ParamDef.axes``;
  * ``logical_to_spec`` equals the reference's ``PartitionSpec`` entries
    for every leaf x every ``enumerate_variants`` cell x the two
    production meshes and ``spec_for(4)``;
  * ``slot_spmd_axes`` / ``page_spmd_axes``, and the packed ``data`` /
    ``scale`` specs the reference's ``launch/input_specs.py`` builds.

Bar: equal.
"""
import dataclasses

import jax
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from conftest import FakeMesh
from repro import configs as ref_configs
from repro.dist import mesh as ref_mesh
from repro.dist import sharding as ref_shd
from repro.dist import variants as ref_var
from repro.models import registry as ref_registry
from repro.models.config import is_def
from repro_torch import configs
from repro_torch.dist import mesh as mesh_lib
from repro_torch.dist import sharding as shd
from repro_torch.dist import variants as var
from repro_torch.dist.runtime import packed_axes
from repro_torch.models import registry

ARCHS = tuple(ref_configs.ARCHS)
MESHES = (mesh_lib.SINGLE_POD, mesh_lib.MULTI_POD, mesh_lib.spec_for(4))
BATCH, CAP = 32, 256


def _ref_leaves(defs) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            defs, is_leaf=is_def)[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


def _port_leaves(specs, path=()) -> dict:
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_port_leaves(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _trees(arch, kv_cache_dtype=""):
    rcfg = dataclasses.replace(ref_configs.get(arch),
                               kv_cache_dtype=kv_cache_dtype)
    pcfg = dataclasses.replace(configs.get(arch),
                               kv_cache_dtype=kv_cache_dtype)
    rm, pm = ref_registry.build(rcfg), registry.build(pcfg)
    ref = {("params",) + k: v for k, v in
           _ref_leaves(rm.param_defs).items()}
    ref.update({("cache",) + k: v for k, v in
                _ref_leaves(rm.cache_defs(BATCH, CAP)).items()
                if k != ("pos",)})          # the port's pos is a host int
    port = {("params",) + k: v for k, v in
            _port_leaves(pm.param_specs).items()}
    port.update({("cache",) + k: v for k, v in
                 _port_leaves(pm.cache_specs(BATCH, CAP)).items()})
    return rcfg, pcfg, ref, port


def _entries(p) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_spec_for_matches_reference(multi_pod):
    for n in range(1, 513):
        got = mesh_lib.spec_for(n, multi_pod=multi_pod)
        want = ref_mesh.spec_for(n, multi_pod=multi_pod)
        assert (tuple(got.shape), tuple(got.axes)) == \
            (tuple(want.shape), tuple(want.axes)), n
        assert got.dp_axes == want.dp_axes
        assert got.axis_sizes == want.axis_sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_axes_match_reference(arch):
    for kvd in ("", "int8"):
        try:
            _, _, ref, port = _trees(arch, kvd)
        except ValueError:          # the VLM refuses an int8 cache
            assert kvd == "int8"
            continue
        assert set(ref) == set(port)
        for key, d in ref.items():
            p = port[key]
            assert tuple(p.shape) == tuple(d.shape), key
            assert tuple(p.axes) == tuple(d.axes), key
            assert len(p.axes) == len(p.shape), key


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_spec_lattice_matches_reference(arch):
    rcfg, pcfg, ref, port = _trees(arch)
    ref_cells = list(ref_var.enumerate_variants(rcfg))
    cells = list(var.enumerate_variants(pcfg))
    assert [c.tag for c in cells] == [c.tag for c in ref_cells]
    n = 0
    for cell, rcell in zip(cells, ref_cells):
        assert cell.rules.axis_map == rcell.rules.axis_map
        assert cell.rules.quantum == rcell.rules.quantum
        for m in MESHES:
            fake = FakeMesh(tuple(m.shape), tuple(m.axes))
            for key, d in ref.items():
                want = ref_shd.logical_to_spec(d.axes, d.shape,
                                               rcell.rules, fake)
                got = shd.logical_to_spec(port[key].axes, port[key].shape,
                                          cell.rules, m)
                assert got == _entries(want), (cell.tag, m.shape, key)
                n += 1
    assert n == len(ref) * len(ref_cells) * len(MESHES)


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_pool_spmd_axes_match_reference(mode):
    cfg, rcfg = configs.get("internlm2-1.8b"), ref_configs.get(
        "internlm2-1.8b")
    for cell, rcell in zip(var.enumerate_variants(cfg),
                           ref_var.enumerate_variants(rcfg)):
        if cell.mode != mode:
            continue
        for m in MESHES:
            fake = FakeMesh(tuple(m.shape), tuple(m.axes))
            for count in (0, 1, 2, 3, 8, 32, 48, 512, 544):
                for fn, rfn in ((shd.slot_spmd_axes, ref_shd.slot_spmd_axes),
                                (shd.page_spmd_axes,
                                 ref_shd.page_spmd_axes)):
                    assert fn(cell.rules, m, count) == \
                        rfn(rcell.rules, fake, count), (cell.tag, count)


def _ref_packed_eligible(d) -> bool:
    """The reference's ``abstract_model_params`` predicate."""
    return (d.init == "normal" and len(d.shape) >= 2
            and min(d.shape[-2:]) >= 256 and "vocab" != d.axes[0]
            and d.dtype is None)


@pytest.mark.parametrize("packing", ["base3", "trit2"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-14b",
                                  "mixtral-8x7b", "zamba2-7b"])
def test_packed_specs_match_reference(arch, packing):
    """data takes the leaf's axes over its packed shape (trit2: K/4
    rows), scale takes axes[:-2] + (axes[-1],) over (..., N)."""
    rcfg, pcfg, ref, port = _trees(arch)
    checked = 0
    for mode in ("train", "serve"):
        rules = shd.rules_for(pcfg, mode)
        rrules = ref_shd.rules_for(rcfg, mode)
        for m in MESHES:
            fake = FakeMesh(tuple(m.shape), tuple(m.axes))
            for key, d in ref.items():
                if key[0] != "params" or not _ref_packed_eligible(d):
                    continue
                k, n = d.shape[-2], d.shape[-1]
                lead = tuple(d.shape[:-2])
                rows = k // 4 if packing == "trit2" else k
                dshape, sshape = lead + (rows, n), lead + (n,)
                daxes, saxes = packed_axes(port[key].axes)
                assert saxes == d.axes[:-2] + (d.axes[-1],)
                assert shd.logical_to_spec(daxes, dshape, rules, m) == \
                    _entries(ref_shd.logical_to_spec(d.axes, dshape,
                                                     rrules, fake))
                assert shd.logical_to_spec(saxes, sshape, rules, m) == \
                    _entries(ref_shd.logical_to_spec(saxes, sshape,
                                                     rrules, fake))
                checked += 1
    assert checked


def test_rules_tables_match_reference():
    assert shd.train_rules().axis_map == ref_shd.train_rules().axis_map
    assert shd.serve_rules().axis_map == ref_shd.serve_rules().axis_map
    assert shd.train_rules(fsdp=False).axis_map == \
        ref_shd.train_rules(fsdp=False).axis_map
    assert var.OVERRIDES.keys() == ref_var.OVERRIDES.keys()
    for name in var.OVERRIDES:
        assert var.OVERRIDES[name][0] == ref_var.OVERRIDES[name][0]
    assert var.REPLICATING_VARIANTS == ref_var.REPLICATING_VARIANTS
    assert [tuple(m) for m in var.MESHES] == \
        [(tuple(m.shape), tuple(m.axes)) for m in ref_var.MESHES]


def test_unknown_axis_and_rank_mismatch_raise_like_reference():
    with pytest.raises(shd.UnknownLogicalAxisError):
        shd.logical_to_spec(("sequence",), (8,), shd.train_rules(),
                            mesh_lib.SINGLE_POD)
    with pytest.raises(ValueError):
        shd.logical_to_spec(("embed",), (8, 8), shd.train_rules(),
                            mesh_lib.SINGLE_POD)
    with pytest.raises(KeyError):
        var.apply_override(shd.train_rules(), "bogus")


class _NamedMesh:
    """What ``placements`` reads of a DeviceMesh: its dim names."""
    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    two = _NamedMesh(("data", "model"))
    assert shd.placements(("data", "model"), two) == (Shard(0), Shard(1))
    assert shd.placements((None, "model"), two) == (Replicate(), Shard(1))
    assert shd.placements((), two) == (Replicate(), Replicate())
    pod = _NamedMesh(("pod", "data", "model"))
    # a dim folded over two mesh axes is Shard(d) on both, outer first
    assert shd.placements((("pod", "data"), None, "model"), pod) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError):
        shd.placements((("data", "pod"),), pod)


def test_constrain_act_is_a_no_op_without_a_context_or_on_local():
    x = torch.randn(2, 3, 4)
    shd.set_activation_context(None, None)
    assert shd.constrain_act(x) is x
    shd.set_activation_context(shd.train_rules(), _NamedMesh(("data",)))
    try:
        assert shd.constrain_act(x) is x        # a rank-local tensor
    finally:
        shd.set_activation_context(None, None)


def test_activation_context_is_scoped_to_its_body():
    """The meshed step and engine install the context only for their
    call: it is back to what it was after the body, also on a raise."""
    rules, mesh = shd.train_rules(), _NamedMesh(("data",))
    assert shd.get_activation_context() is None
    with shd.activation_context(rules, mesh):
        assert shd.get_activation_context() == (rules, mesh)
        with shd.activation_context(None, None):
            assert shd.get_activation_context() is None
        assert shd.get_activation_context() == (rules, mesh)
    assert shd.get_activation_context() is None
    with pytest.raises(KeyError):
        with shd.activation_context(rules, mesh):
            raise KeyError("x")
    assert shd.get_activation_context() is None


def test_spec_tree_matches_reference():
    rcfg, pcfg, _, _ = _trees("internlm2-1.8b")
    from repro.dist.sharding import spec_tree as ref_spec_tree
    for m in MESHES:
        fake = FakeMesh(tuple(m.shape), tuple(m.axes))
        for mode in ("train", "serve"):
            got = shd.spec_tree(registry.build(pcfg).param_specs,
                                shd.rules_for(pcfg, mode), m)
            want = ref_spec_tree(ref_registry.build(rcfg).param_defs,
                                 ref_shd.rules_for(rcfg, mode), fake)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]:
                node = got
                for p in path:
                    node = node[p.key]
                assert node == _entries(leaf), path

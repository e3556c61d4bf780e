"""Subprocess side of the dry-run parity tests
(``tests/test_torch_dryrun.py``, ``tests/test_torch_roofline.py``).

    python _torch_dryrun_worker.py ref-specs OUT          (jax, 256 devices)
    python _torch_dryrun_worker.py ref-flops OUT MESHES   (jax, 4 devices)
    python _torch_dryrun_worker.py port-specs OUT         (a fake group)
    python _torch_dryrun_worker.py port-cells OUT CELLS   (fake groups)

``ref-*`` import the reference, each in a process of its own whose
``XLA_FLAGS`` the caller sets before jax starts; ``port-*`` import only
the port (a fake process group lives for one process).  ``CELLS`` is a
JSON list of [key, arch, shape, run_cell keywords].  Each writes a JSON
file ``OUT``.
"""
from __future__ import annotations

import json
import os
import re
import sys

ARCH = "internlm2-1.8b"
FLOP_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "").replace("bool_", "bool")


def _entry(shape, dtype, spec) -> list:
    return [list(shape), _dtype_name(dtype),
            [list(e) if isinstance(e, tuple) else e for e in spec]]


# ------------------------------------------------------------ reference

def _ref_flatten(tree) -> dict:
    import jax
    from repro.kernels.ops import PackedTernary
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PackedTernary))[0]
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(
            p, "idx", getattr(p, "name", p)))) for p in path)
        parts = ([("data", leaf.data), ("scale", leaf.scale)]
                 if isinstance(leaf, PackedTernary) else [("", leaf)])
        for suffix, x in parts:
            spec = tuple(x.sharding.spec)
            while spec and spec[-1] is None:
                spec = spec[:-1]
            out[key + (":" + suffix if suffix else "")] = _entry(
                x.shape, x.dtype, spec)
    return out


def _ref_mesh(shape, axes):
    """A jax mesh whose axes the sharding constraints may name (Auto: the
    reference's code predates jax's Explicit default)."""
    import jax
    auto = getattr(jax.sharding, "AxisType", None)
    if auto is None:
        return jax.make_mesh(shape, axes)
    return jax.make_mesh(shape, axes, axis_types=(auto.Auto,) * len(axes))


def ref_specs(out_path: str) -> None:
    import jax
    from repro import configs
    from repro.configs.shapes import SHAPES
    from repro.dist import sharding as shd
    from repro.launch import input_specs as spec
    from repro.models import registry
    mesh = _ref_mesh((16, 16), ("data", "model"))
    out = {}
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        model = registry.build(cfg)
        for name, cell in SHAPES.items():
            mode = "train" if cell.kind == "train" else "serve"
            rules = shd.rules_for(cfg, mode)
            got = {}
            if cell.kind == "train":
                got["batch"] = spec.train_batch_specs(cfg, cell, rules, mesh)
            elif cell.kind == "prefill":
                got["batch"] = spec.prefill_batch_specs(cfg, cell, rules,
                                                        mesh)
            else:
                got["token"] = spec.decode_token_spec(cell, rules, mesh)
                got["loop"] = spec.decode_loop_specs(cell, rules, mesh)
                got["cache"] = spec.abstract_cache(model, cell, rules, mesh)
                got["slots"] = spec.slot_pool_specs(model, cell, rules,
                                                    mesh, 8)
                got["pages"] = spec.paged_pool_specs(model, cell, rules,
                                                     mesh, 8, 512, 65)
            if name == "train_4k" or name == "decode_32k":
                got["params"] = spec.abstract_model_params(model, rules,
                                                           mesh)
            if name == "decode_32k":
                for p in ("base3", "trit2"):
                    got[p] = spec.abstract_model_params(model, rules, mesh,
                                                        p)
            out[f"{arch}|{name}"] = _ref_flatten(got)
    with open(out_path, "w") as f:
        json.dump(out, f)


def _dot_flops(text: str) -> float:
    """The dot FLOPs of a compiled module, while bodies times their trip
    counts (``repro.roofline.hlo_cost``'s rules, dots alone)."""
    from repro.roofline import hlo_cost as hc
    comps = hc.parse_module(text)
    entry = re.search(r"^ENTRY\s+%?([\w.\-]+)", text, re.M).group(1)
    memo: dict = {}

    def comp(name) -> float:
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        c = comps.get(name)
        total = 0.0
        for op in (c.ops if c else []):
            if op.opcode == "dot":
                total += hc._dot_flops(op, c.shapes)
            elif op.opcode == "while":
                m = re.search(r"known_trip_count[^0-9]*(\d+)", op.line)
                cond = hc._called(op, "condition")
                trip = int(m.group(1)) if m else hc._trip_count(comps[cond])
                total += max(trip, 1) * comp(hc._called(op, "body"))
            elif op.opcode == "fusion":
                total += comp(hc._called(op, "calls"))
            elif op.opcode == "call":
                total += comp(hc._called(op, "to_apply"))
            elif op.opcode == "conditional":
                total += max([comp(b) for b in re.findall(
                    r"%([\w.\-]+)", op.attrs) if b in comps] or [0.0])
        memo[name] = total
        return total
    return comp(entry)


def ref_flops(out_path: str, meshes: str) -> None:
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.configs.shapes import SHAPES
    from repro.dist import sharding as shd
    from repro.launch import input_specs as spec
    from repro.models import registry
    out = {}
    for mesh_tag in meshes.split(","):
        shape = tuple(int(s) for s in mesh_tag.split("x"))
        mesh = _ref_mesh(shape, ("data", "model"))
        for name in FLOP_SHAPES:
            cell = SHAPES[name]
            cfg = configs.smoke(ARCH)
            mode = "train" if cell.kind == "train" else "serve"
            rules = shd.rules_for(cfg, mode)
            shd.set_activation_context(rules, mesh)
            if cell.kind == "train":
                from repro.optim import adamw, warmup_cosine
                from repro.train.step import (make_abstract_state,
                                              make_train_step)
                cfg = dataclasses.replace(cfg, remat="full")
                model = registry.build(cfg)
                opt = adamw(warmup_cosine(3e-4, 1000, 100_000))
                state, _ = make_abstract_state(model, opt, rules, mesh)
                batch = spec.train_batch_specs(cfg, cell, rules, mesh)
                fn = make_train_step(model, opt, microbatches=8,
                                     rules=rules, mesh=mesh)
                lowered = jax.jit(fn, donate_argnums=(0,)).lower(state,
                                                                 batch)
            elif cell.kind == "prefill":
                model = registry.build(cfg)
                params = spec.abstract_model_params(model, rules, mesh)
                batch = spec.prefill_batch_specs(cfg, cell, rules, mesh)

                def prefill(p, b, model=model, cell=cell):
                    logits, st = model.prefill(p, b, cell.seq_len)
                    return jnp.argmax(logits[:, -1], -1), st
                lowered = jax.jit(prefill).lower(params, batch)
            else:
                model = registry.build(cfg)
                params = spec.abstract_model_params(model, rules, mesh)
                cache = spec.abstract_cache(model, cell, rules, mesh)
                tok = spec.decode_token_spec(cell, rules, mesh)

                def decode(p, t, s, model=model):
                    logits, st = model.decode(p, t, s)
                    return jnp.argmax(logits[:, -1], -1), st
                lowered = jax.jit(decode, donate_argnums=(2,)).lower(
                    params, tok, cache)
            text = lowered.compile().as_text()
            out[f"{mesh_tag}|{name}"] = _dot_flops(text)
    with open(out_path, "w") as f:
        json.dump(out, f)


# ----------------------------------------------------------------- port

def _port_flatten(tree) -> dict:
    from repro_torch.kernels.ops import PackedTernary
    from repro_torch.launch.input_specs import spec_of
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif hasattr(node, "_fields"):
            for k in node._fields:
                walk(getattr(node, k), path + (k,))
        elif isinstance(node, (tuple, list)) and not isinstance(
                node, PackedTernary):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, PackedTernary):
            for suffix, x in (("data", node.data), ("scale", node.scale)):
                out["/".join(path) + ":" + suffix] = _entry(
                    x.shape, x.dtype, spec_of(x))
        elif node is not None:
            out["/".join(path)] = _entry(node.shape, node.dtype,
                                         spec_of(node))
    walk(tree, ())
    return out


def port_specs(out_path: str) -> None:
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.dist import mesh as mesh_lib
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import input_specs as spec
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import registry
    mesh = make_production_mesh()
    out = {}
    try:
        with spec.fake_mode():
            for arch in configs.ARCHS:
                cfg = configs.get(arch)
                model = registry.build(cfg)
                for name, cell in SHAPES.items():
                    mode = "train" if cell.kind == "train" else "serve"
                    rules = shd.rules_for(cfg, mode)
                    got = {}
                    if cell.kind == "train":
                        got["batch"] = spec.train_batch_specs(
                            cfg, cell, rules, mesh)
                    elif cell.kind == "prefill":
                        got["batch"] = spec.prefill_batch_specs(
                            cfg, cell, rules, mesh)
                    else:
                        got["token"] = spec.decode_token_spec(cell, rules,
                                                              mesh)
                        got["loop"] = spec.decode_loop_specs(cell, rules,
                                                             mesh)
                        got["cache"] = spec.abstract_cache(model, cell,
                                                           rules, mesh)
                        got["slots"] = spec.slot_pool_specs(
                            model, cell, rules, mesh, 8)
                        got["pages"] = spec.paged_pool_specs(
                            model, cell, rules, mesh, 8, 512, 65)
                    if name == "train_4k" or name == "decode_32k":
                        got["params"] = spec.abstract_model_params(
                            model, rules, mesh)
                    if name == "decode_32k":
                        for p in ("base3", "trit2"):
                            got[p] = spec.abstract_model_params(
                                model, rules, mesh, p)
                    out[f"{arch}|{name}"] = _port_flatten(got)
    finally:
        mesh_lib.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def port_cells(out_path: str, cells_json: str) -> None:
    """Run each (arch, shape, kwargs) of ``cells_json`` through
    ``run_cell``; write {key: report or the exception's repr}.  A shape
    is a ``SHAPES`` name or a ``[name, seq_len, global_batch, kind]``
    cell of its own."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    out = {}
    for key, arch, shape, kwargs in json.loads(cells_json):
        if isinstance(shape, list):
            shape = ShapeCell(*shape)
        kw = dict(kwargs)
        if "mesh_shape" in kw:
            kw["mesh_shape"] = tuple(kw["mesh_shape"])
        try:
            rep = dryrun.run_cell(arch, shape, **kw)
        except Exception as e:             # reported, the test asserts
            rep = {"error": f"{type(e).__name__}: {e}"}
        out[key] = rep
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    role, out_path, *rest = sys.argv[1:]
    {"ref-specs": ref_specs, "ref-flops": ref_flops,
     "port-specs": port_specs, "port-cells": port_cells}[role](out_path,
                                                                *rest)

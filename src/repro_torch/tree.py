"""Nested containers walked in the reference's leaf order.

``jax.tree`` flattens a dict in sorted-key order, a NamedTuple in field
order, a list or tuple in index order, and a None as no leaf at all.
The order is part of the training results: ``optim.global_norm`` sums
the leaves in it and ``checkpoint.save`` numbers its files by it, so a
port that walked dicts in insertion order would match neither the
reference's norm nor its checkpoints.  Every other object (a tensor, a
numpy array, a ``PackedTernary``) is a leaf.

A path is a tuple of entries as the reference's checkpoint manifest
writes them: a dict key as ``str(key)``, a NamedTuple field as
``".name"``, a list index as ``str(i)``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list | None:
    """(entry, child) pairs of a container in the reference's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's order; None holds no leaf."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for entry, child in kids:
            walk(child, path + (entry,))
    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_leaves(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over the structure of
    ``tree`` (the others must share it), called in the reference's
    order; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, *parts)
                            for parts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def map_specs(fn, specs):
    """``fn`` over every non-dict of a nested dict: the walk for a
    ``ParamSpec`` tree, whose leaves are NamedTuples that
    :func:`map_leaves` would open."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def unflatten_like(structure, values) -> Any:
    """``structure`` with its leaves replaced, in the reference's order,
    by ``values``; raises unless the counts agree."""
    values = list(values)
    want = len(leaves(structure))
    if len(values) != want:
        raise ValueError(f"{len(values)} values for a structure of {want} "
                         f"leaves")
    it: Iterator = iter(values)
    return map_leaves(lambda _: next(it), structure)

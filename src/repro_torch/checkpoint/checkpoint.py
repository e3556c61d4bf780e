"""Atomic, resumable checkpoints in the reference's on-disk format
(``repro.checkpoint``), so a checkpoint written by either package
restores in the other.

Layout:  <dir>/step_<N>/
            manifest.json     - step, leaf count, per leaf its path,
                                file, shape and dtype, ``extra``,
                                ``complete`` (written LAST, fsync'd)
            arr_<i>.npy       - one file per leaf, numbered in the
                                reference's leaf order
                                (``repro_torch.tree``); bf16 stored as
                                uint16 with the true dtype in the
                                manifest

Atomicity: everything is written into ``step_<N>.tmp`` and the directory
is ``os.rename``d only after the manifest is fsync'd: a reader never
sees a partial checkpoint, and a writer killed mid-save leaves only a
``.tmp`` that the next save removes.  The fault-tolerant ``Trainer``
leans on this (``_fail_after_files`` simulates a crash mid-save).

``restore(device=)`` puts every leaf on that device (the reference's
``shardings=`` re-shards onto a mesh; the port runs on one card).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device, tree as tree_lib

_MANIFEST = "manifest.json"


def _to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.dtype(dtype), copy=False))


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None,
         _fail_after_files: Optional[int] = None) -> str:
    """Write an atomic checkpoint; returns the final directory.

    ``_fail_after_files`` is a test hook: raise mid-write after that many
    leaf files to simulate a crash during save."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    entries = []
    for i, (path, leaf) in enumerate(tree_lib.flatten_with_path(tree)):
        if _fail_after_files is not None and i >= _fail_after_files:
            raise RuntimeError("simulated crash during checkpoint save")
        arr, dtype = _to_numpy(leaf)
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
        entries.append({"path": "/".join(path), "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "num_leaves": len(entries), "leaves": entries,
                "extra": extra or {}, "complete": True}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir: str) -> list[int]:
    """Steps with a COMPLETE manifest (ignores .tmp wreckage)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        mpath = os.path.join(ckpt_dir, name, _MANIFEST)
        if not os.path.exists(mpath):
            continue
        try:
            with open(mpath) as f:
                m = json.load(f)
            if m.get("complete"):
                out.append(int(m["step"]))
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, target: Any = None,
            device="cuda") -> tuple[Any, dict]:
    """Load (tree, extra), every leaf a tensor on ``device``.  With
    ``target`` (any tree of the saved structure; its leaves are not read)
    the leaves go back into that structure in the reference's order;
    without, a nested dict is rebuilt from the manifest's paths."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    arrays = [_from_numpy(np.load(os.path.join(d, e["file"]),
                                  allow_pickle=False), e["dtype"]).to(device)
              for e in manifest["leaves"]]
    if target is not None:
        return (tree_lib.unflatten_like(target, arrays),
                manifest.get("extra", {}))
    tree: dict = {}
    for e, a in zip(manifest["leaves"], arrays):
        node = tree
        parts = e["path"].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree, manifest.get("extra", {})


def gc_old_steps(ckpt_dir: str, keep: int = 3) -> list[int]:
    """Delete all but the newest `keep` complete checkpoints (+ any .tmp)."""
    removed = []
    if not os.path.isdir(ckpt_dir):
        return removed
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
        removed.append(s)
    return removed


class CheckpointManager:
    """Periodic save + keep-last-N + restore-or-none, in one object."""

    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None,
                   force: bool = False) -> Optional[str]:
        if not force and (self.interval <= 0 or step % self.interval):
            return None
        path = save(self.dir, step, tree, extra)
        gc_old_steps(self.dir, self.keep)
        return path

    def restore_or_none(self, target: Any = None, device="cuda"):
        if latest_step(self.dir) is None:
            return None
        return restore(self.dir, target=target, device=device)

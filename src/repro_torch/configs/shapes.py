"""The assigned input-shape set (4 cells per architecture, 40 total), as
the reference's ``repro.configs.shapes``.

Shape semantics:
  train_4k     seq=4,096   global_batch=256  -> the train step
  prefill_32k  seq=32,768  global_batch=32   -> ``model.prefill``
  decode_32k   seq=32,768  global_batch=128  -> ``model.decode``
                (one new token against a KV cache/state of seq_len)
  long_500k    seq=524,288 global_batch=1    -> ``model.decode``; needs
                sub-quadratic attention (SSM state / rolling SWA window)

``runnable(cfg, cell)`` encodes the skip rules:
  * ``long_500k`` only for SSM / hybrid / sliding-window archs: a full-
    attention KV cache at 524,288 tokens is quadratic-cost and the cell
    is skipped;
  * decode shapes would be skipped for encoder-only archs (none is
    assigned: whisper is enc-dec and decodes against self+cross caches).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def runnable(cfg, cell: ShapeCell) -> tuple[bool, str]:
    """(ok, reason) — reason explains a skip."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k-token KV cache is "
                       "quadratic-cost; skipped per assignment")
    return True, ""

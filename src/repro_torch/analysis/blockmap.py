"""Pass ``blockmap``: the tile plans of ``ternary_matmul``'s routes.

Runs ``gemv_plan`` (decode, M <= 8), ``mma_plan`` (M > 8, bf16 or int8
x; the float domain with ``chain=MMA_FLOAT_CHAIN``) and ``split_k`` (the
cuda_core route, f32 x) over a shape sweep and several SM counts, and
proves each plan keeps the kernel's contract.  The checks are
``ternary_matmul.plan_violations``, the one function the wrappers (a
given plan), the autotune table (AT002) and this pass share:

  * BM001 tile sizes the kernel has an instance of: block_n in
    ``GEMV_BLOCK_NS``, a cluster of 1, 2, 4 or 8 blocks, block_m 128 or
    256, the route's rows (gemv 1-8, mma above 8);
  * BM002 K coverage: the splits cover K exactly, in whole stages (64
    packed rows, 256 K rows of trit2, on the gemv and cuda_core routes;
    64 K rows on the mma route), none empty;
  * BM003 the float chain: no float mma split longer than
    ``MMA_FLOAT_CHAIN`` K rows;
  * BM004 shared memory: what ``csrc/ternary_matmul.cu`` reckons for the
    tile (``MmaShape::kSmem``, ``GemvShape::kSmem``) within its limit
    (227 KiB opt-in; 48 KiB for the gemv kernel, which opts in to none).

``pin_blocks`` forces one plan over every tensor-core cell of the sweep
(the CLI's ``--pin-blocks A,B,C``, a violation injection).
"""
from __future__ import annotations

from typing import Optional

from .base import Finding

PASS = "blockmap"

RULES = {"tile": "BM001", "coverage": "BM002", "chain": "BM003",
         "smem": "BM004"}

# (M, K, N): decode rows 1-8, ragged K and N, exact tile multiples,
# prefill rows, the main path's widths, deep K past the float chain
SHAPE_SWEEP = (
    (1, 13, 50), (1, 64, 128), (4, 4096, 1), (7, 96, 333), (8, 256, 1000),
    (8, 2048, 2048), (8, 8192, 2048), (8, 2048, 92672), (9, 200, 136),
    (16, 1024, 128), (100, 4096, 16), (128, 512, 256), (129, 520, 130),
    (333, 77, 129), (1024, 2048, 8192), (1024, 13696, 4096),
    (1024, 28672, 8192), (4096, 4096, 1024),
)
SM_COUNTS = (132, 114, 16)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _cell(route, mode, domain, shape, sms, tiles):
    m, k, n = shape
    return (f"{route} mode={mode} domain={domain} shape=({m},{k},{n}) "
            f"sms={sms} plan={tuple(tiles)}")


def check_plan(route: str, m: int, k: int, n: int, mode: str, domain: str,
               tiles: tuple, sms: int = 0) -> list:
    """Findings of one plan (K as the wrapper sees it: trit2 rounded up
    to a multiple of 4)."""
    from ..kernels.ternary_matmul import TRIT2_PER_BYTE, plan_violations
    kdim = _round_up(k, TRIT2_PER_BYTE) if mode == "trit2" else k
    cell = _cell(route, mode, domain, (m, k, n), sms, tiles)
    return [Finding(PASS, RULES[kind], cell, msg)
            for kind, msg in plan_violations(route, m, kdim, n, mode, domain,
                                             tuple(tiles))]


def route_plans(m: int, k: int, n: int, mode: str, sms: int) -> list:
    """(route, domain, plan) of every route that serves M rows, as the
    wrappers' rules plan them."""
    from ..kernels import ternary_matmul as tm
    kdim = _round_up(k, tm.TRIT2_PER_BYTE) if mode == "trit2" else k
    out = [("cuda_core", "float", tm.split_k(m, kdim, n, mode, sms))]
    if m <= tm.GEMV_MAX_M:
        plan = tm.gemv_plan(m, kdim, n, mode, sms)
        out += [("gemv", "float", plan), ("gemv", "int8", plan)]
    else:
        out += [("mma", "float", tm.mma_plan(m, kdim, n, sms,
                                             tm.MMA_FLOAT_CHAIN)),
                ("mma", "int8", tm.mma_plan(m, kdim, n, sms))]
    return out


def run(pin_blocks: Optional[tuple] = None) -> list:
    """The whole pass over the sweep, both packings and SM counts.
    ``pin_blocks`` replaces every gemv and mma plan by one pinned plan."""
    findings = []
    for m, k, n in SHAPE_SWEEP:
        for mode in ("base3", "trit2"):
            for sms in SM_COUNTS:
                for route, domain, plan in route_plans(m, k, n, mode, sms):
                    if pin_blocks is not None and route != "cuda_core":
                        plan = tuple(pin_blocks)
                    findings += check_plan(route, m, k, n, mode, domain,
                                           plan, sms)
    return findings

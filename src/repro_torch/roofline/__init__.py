"""The roofline of a traced step on the H100's constants: the per-op
roll-up (``op_cost``) and the three-term report (``analysis``)."""
from .analysis import (H100, HW, KINDS, RooflineReport,  # noqa: F401
                       analyze_step, collective_bytes, model_flops,
                       wire_bytes)
from .op_cost import OpCost  # noqa: F401

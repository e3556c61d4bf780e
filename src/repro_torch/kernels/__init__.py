"""Kernel layer: packed weights, the CUDA kernels and the plan registry."""
from . import ops, ref  # noqa: F401
from .plan import (BackendSpec, ExecutionPlan, backend_names,  # noqa: F401
                   execute, get_backend, plan_matmul, platform_of,
                   register_backend, resolve_backend, shape_of)

"""Distributed execution: mesh specs, logical-axis sharding rules, the
rules variants, and the DTensor placement of trees on a DeviceMesh."""
from . import mesh, runtime, sharding, variants               # noqa: F401
from .mesh import (MULTI_POD, SINGLE_POD, MeshSpec,           # noqa: F401
                   destroy_process_group, init_fake_process_group,
                   init_process_group, make_mesh,
                   spec_for)
from .sharding import (Rules, UnknownLogicalAxisError,        # noqa: F401
                       activation_context, constrain, constrain_act,
                       logical_to_spec, placements, rules_for,
                       serve_rules, set_activation_context, spec_tree,
                       train_rules)
from .variants import (MESHES, OVERRIDES, REPLICATING_VARIANTS,  # noqa: F401
                       VariantCell, apply_override, enumerate_variants)

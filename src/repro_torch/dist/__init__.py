"""Distribution helpers: mesh-aware sharding constraints and spec guards;
the port of `repro/dist/`.

`ctx.constrain` is the model-code entry point (logical axis names ->
mesh-validated DTensor redistribution); `sharding.guard` is the pure
validation rule it relies on, and `sharding.placements` turns a spec into
DTensor placements.
"""
from .ctx import activation_sharding, constrain, current_mesh
from .sharding import (
    batch_specs,
    cache_specs,
    data_axes,
    guard,
    opt_state_specs,
    param_specs,
)

__all__ = [
    "activation_sharding", "constrain", "current_mesh", "guard",
    "data_axes", "param_specs", "opt_state_specs", "batch_specs",
    "cache_specs",
]

"""Distribution layer: logical-axis sharding rules, spec derivation and
the collectives of the mesh paths."""

from repro_torch.dist.sharding import (
    DATA_AXIS_RULES,
    MODEL_AXIS_RULES,
    TP_AXIS,
    MeshShape,
    auto_spec,
    batch_specs,
    data_axes,
    divisible_axes,
    is_partition_spec,
    logical_axis_dims,
    mesh_view,
    paged_spec,
    param_rules,
    partition_params,
    state_specs,
    to_placements,
)

__all__ = [
    "DATA_AXIS_RULES", "MODEL_AXIS_RULES", "TP_AXIS", "MeshShape",
    "auto_spec", "batch_specs", "data_axes", "divisible_axes",
    "is_partition_spec", "logical_axis_dims", "mesh_view", "paged_spec",
    "param_rules", "partition_params", "state_specs", "to_placements",
]

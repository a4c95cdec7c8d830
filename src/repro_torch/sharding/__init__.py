"""Sharding of the port: logical-axis rules, the current mesh, partition
specs and each rank's local slices. The reference's ``sharding/compat.py``
is a ``shard_map`` version shim of JAX and has no torch counterpart."""

from .context import (axis_size, current_mesh, data_axes, mesh_context,
                      model_axis, set_current_mesh)
from .rules import (PartitionSpec, batch_spec, local_shape, local_slices,
                    logical_to_spec, make_rules, sharding_tree, spec_tree)

__all__ = ["current_mesh", "set_current_mesh", "mesh_context", "data_axes",
           "model_axis", "axis_size", "PartitionSpec", "logical_to_spec",
           "make_rules", "spec_tree", "sharding_tree", "batch_spec",
           "local_slices", "local_shape"]

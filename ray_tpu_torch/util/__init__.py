"""Cluster utilities (reference: python/ray/util).

The port holds `metrics` and `scheduling_strategies`, which the runtime
core imports, the span half of `profiling`, which Serve records into,
and placement groups' user API, which `parallel/mesh_group.py` gangs
ranks with.  `ActorPool`, `collective`, the device half of `profiling`
and `state` are still to port (ROADMAP.md, Queue A).
"""

from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group,
                                                tpu_slice_bundles)

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "placement_group_table", "tpu_slice_bundles",
]

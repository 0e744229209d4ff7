"""Placement groups: gang-reserved resource bundles across the cluster.

The port's copy of `ray_tpu/util/placement_group.py` (reference:
python/ray/util/placement_group.py:41 `PlacementGroup`,
`placement_group` at :145, `remove_placement_group`), over the node
half ported with the runtime core: the node service's 2PC
reserve/commit (`_private/node_pg.py`, reference
src/ray/gcs/gcs_server/gcs_placement_group_scheduler.h:283).

A bundle names GPUs as `{"GPU": n}`.  The JAX package's
`tpu_slice_bundles` reserves a TPU slice's head resource for the
autoscaler; its GPU counterpart waits for the autoscaler (A2f) and
raises until then.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ray_tpu_torch.object_ref import ObjectRef

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a (possibly still-materializing) placement group."""

    def __init__(self, id: bytes, bundle_specs: List[Dict[str, float]],
                 ready_oid: bytes) -> None:
        self.id = id
        self.bundle_specs = list(bundle_specs)
        self._ready_oid = ready_oid

    def _check_bundle_index(self, index: int) -> None:
        if not 0 <= index < len(self.bundle_specs):
            raise ValueError(
                f"placement_group_bundle_index {index} out of range for "
                f"a {len(self.bundle_specs)}-bundle placement group")

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self) -> ObjectRef:
        """ObjectRef that resolves (to True) once every bundle is
        reserved — await with ray_tpu_torch.get(pg.ready())."""
        return ObjectRef._from_wire(self._ready_oid)

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(self.ready(), timeout=timeout_seconds)
            return True
        except ray_tpu_torch.exceptions.GetTimeoutError:
            return False

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs,
                                 self._ready_oid))

    def __repr__(self) -> str:
        return (f"PlacementGroup({self.id.hex()[:12]}, "
                f"{len(self.bundle_specs)} bundles)")


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: Optional[str] = None) -> PlacementGroup:
    """Reserve a gang of resource bundles (2PC across nodes).

    Returns immediately; use pg.ready()/pg.wait() to await placement.
    """
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, "
                         f"got {strategy!r}")
    if not bundles or not all(isinstance(b, dict) and b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    for b in bundles:
        if any(v <= 0 for v in b.values()):
            raise ValueError(f"bundle resource amounts must be > 0: {b}")
    import ray_tpu_torch
    client = ray_tpu_torch._ensure_connected()
    pg_id = os.urandom(16)
    ready_oid = os.urandom(16)
    client.create_pg(pg_id, [dict(b) for b in bundles], strategy, name,
                     ready_oid)
    return PlacementGroup(pg_id, bundles, ready_oid)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all of a placement group's bundles back to their nodes."""
    import ray_tpu_torch
    ray_tpu_torch._ensure_connected().remove_pg(pg.id)


def placement_group_table(pg: PlacementGroup) -> dict:
    """State of one placement group: {'state', 'nodes'}."""
    import ray_tpu_torch
    return ray_tpu_torch._ensure_connected().pg_state(pg.id)


def tpu_slice_bundles(accelerator_type: str, num_hosts: int,
                      chips_per_host: int = 4) -> List[Dict[str, float]]:
    """The JAX package's bundles for one whole TPU slice, whose head
    marker resource the slice autoscaler provisions from.  A GPU
    counterpart needs the autoscaler (ROADMAP A2f)."""
    raise NotImplementedError(
        "tpu_slice_bundles: slice-head bundles need the autoscaler, "
        "which the port does not have yet (ROADMAP A2f)")

"""Logical-axis sharding rules, as DTensor placements.

Counterpart of `ray_tpu/parallel/sharding.py`: every parameter and
activation carries logical axis names, and a rule table maps them to mesh
axes (`DEFAULT_RULES`, the JAX package's table).  Where JAX turns a rule
into a `PartitionSpec` (one entry per tensor dimension), the port turns
it into DTensor placements (one per mesh dimension): `Shard(d)` on the
mesh dimensions that split tensor dimension d, `Replicate()` on the rest.
Mesh axes the mesh lacks are dropped and no mesh axis is used twice, as
in JAX, so one table serves every mesh shape.

A tensor dimension split over several mesh axes (batch over dp and fsdp)
is split in mesh order, outer axis first, which is what JAX's
`P(("dp", "fsdp"))` means; a rule that lists them in another order has
no DTensor placement and raises.
"""

from __future__ import annotations

import contextvars
import math
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

# rule: logical axis -> mesh axis | tuple of mesh axes | None (replicated)
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Batch is split over every data-ish axis; fsdp additionally shards the
# weights' embed dim (ZeRO-3); tp shards heads/mlp/vocab (Megatron).
DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": None,
}

_MESHES: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "rtt_mesh_stack", default=())


def _mesh_axes(logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules], names: Sequence[str]
               ) -> List[Tuple[str, ...]]:
    """Per tensor dimension, the mesh axes that split it (JAX's
    `spec_for` before it is packed into a PartitionSpec)."""
    rules = rules if rules is not None else DEFAULT_RULES
    used = set()
    out = []
    for ax in logical_axes:
        m = rules.get(ax) if ax is not None else None
        parts = () if m is None else ((m,) if isinstance(m, str)
                                      else tuple(m))
        parts = tuple(p for p in parts if p in names and p not in used)
        used.update(parts)
        out.append(parts)
    return out


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None, mesh=None) -> tuple:
    """DTensor placements (one per mesh dimension) for a tensor with
    these logical axes on `mesh` (default: the ambient `use_mesh`)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh is None:
        raise ValueError("spec_for needs a mesh (argument or use_mesh)")
    names = list(mesh.mesh_dim_names or ())
    placements = [Replicate()] * len(names)
    for dim, parts in enumerate(_mesh_axes(logical_axes, rules, names)):
        order = [names.index(p) for p in parts]
        if order != sorted(order):
            raise ValueError(
                f"logical axis {logical_axes[dim]!r} maps to mesh axes "
                f"{parts} out of mesh order {tuple(names)}: DTensor splits "
                "a dimension over several mesh axes outer axis first")
        for i in order:
            placements[i] = Shard(dim)
    return tuple(placements)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_specs(logical_tree: Any, rules: Optional[Rules] = None,
               mesh=None) -> Any:
    """Map a tree (dicts) of logical-axis tuples to placements."""
    if _is_axes(logical_tree):
        return spec_for(logical_tree, rules, mesh)
    return {k: tree_specs(v, rules, mesh) for k, v in logical_tree.items()}


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing DTensor: none can
    exist before its module is imported, or while another thread is
    still importing it and the class is not defined yet)."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                  None)
    return cls is not None and isinstance(x, cls)


def mesh_trivial(mesh) -> bool:
    """No mesh, or a mesh of one device: nothing to shard."""
    return mesh is None or math.prod(mesh.shape) == 1


def constrain(x, logical_axes: Sequence[Optional[str]],
              rules: Optional[Rules] = None, mesh=None):
    """Redistribute a DTensor to the placements of its logical axes; the
    identity for a plain tensor or on a trivial mesh (as in JAX)."""
    mesh = mesh if mesh is not None else _current_mesh()
    if mesh_trivial(mesh) or not is_dtensor(x):
        return x
    return x.redistribute(mesh, spec_for(logical_axes, rules, mesh))


class use_mesh:
    """Context manager setting the ambient mesh for `constrain` and
    `spec_for` (per thread and task: a context variable)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self._token = None

    def __enter__(self):
        self._token = _MESHES.set(_MESHES.get() + (self.mesh,))
        return self.mesh

    def __exit__(self, *exc):
        _MESHES.reset(self._token)


def _current_mesh():
    stack = _MESHES.get()
    return stack[-1] if stack else None

"""Device meshes over torch.distributed ranks.

Counterpart of `ray_tpu/parallel/mesh.py`: the same logical axes
(`MeshSpec`, `AXIS_ORDER`) and the same `resolve` arithmetic, built into a
`torch.distributed.device_mesh.DeviceMesh` whose dimension names are the
mesh axes of size > 1, in `AXIS_ORDER` (tp innermost), or a single `dp`
dimension of size 1 for a one-device mesh:

    dp    — pure data parallel (replicated params)
    fsdp  — data parallel with sharded params/opt-state (ZeRO-3 analog)
    tp    — tensor parallel (Megatron-style, intra-layer)
    sp    — sequence/context parallel (ring attention, ops/ring_attention.py)
    ep    — expert parallel (MoE experts split, models/transformer.py)
    pp    — pipeline stages (GPipe, parallel/pipeline.py)

One rank drives one device.  `make_mesh` starts a world-size-1 process
group when none exists (NCCL on CUDA, gloo on the CPU), so a one-device
mesh needs no launcher; a multi-rank mesh needs the caller's
`torch.distributed.init_process_group` first (address, world size and
rank given explicitly).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 on at most one axis means 'fill with the
    remaining devices' (like a reshape wildcard)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed > n_devices:
            raise ValueError(
                f"mesh spec {sizes} needs {fixed} devices, have "
                f"{n_devices}")
        return sizes


def _device_type(devices: Optional[Sequence]) -> str:
    """The ranks' device type: that of `devices`, else CUDA (which must
    be present: the CPU is used only when the caller names it)."""
    if devices is None:
        from ray_tpu_torch._private.device import resolve_device
        return resolve_device(None).type
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh's devices are of one type (got {kinds})")
    return kinds.pop()


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None,
              axis_sizes: Optional[Dict[str, int]] = None):
    """A `DeviceMesh` over the ranks of the default process group.

    `devices` lists one device per rank (rank r drives `devices[r]`);
    by default every rank drives the current CUDA device.  The mesh takes
    every rank: unlike a JAX mesh it cannot leave devices out, because a
    rank outside it would have no part in the step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = _device_type(devices)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if devices is not None and len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks: give one "
                         "device per rank")
    if axis_sizes is None:
        spec = spec or MeshSpec(dp=-1)
        axis_sizes = spec.resolve(n)
    names = [a for a in AXIS_ORDER if axis_sizes.get(a, 1) > 1] or ["dp"]
    shape = [axis_sizes.get(a, 1) for a in names]
    needed = math.prod(shape)
    if needed != n:
        raise ValueError(f"axis sizes {axis_sizes} need {needed} devices; "
                         f"the process group has {n} ranks")
    if dev_type == "cuda":
        dev = (torch.device(devices[dist.get_rank()]) if devices is not None
               else torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.set_device(dev)
    return init_device_mesh(dev_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def mesh_axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (JAX's `mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def sub_mesh_for_stage(mesh, stage: int):
    """The pipeline stage's sub-mesh (the pp axis taken at `stage`).
    Collective: every rank of `mesh` calls it for the same stage."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names or ())
    if "pp" not in names:
        raise ValueError("mesh has no pp axis")
    idx = names.index("pp")
    ranks = mesh.mesh.select(idx, stage)
    rest = tuple(a for a in names if a != "pp")
    if not rest:
        ranks, rest = ranks.reshape(1), ("dp",)
    return DeviceMesh(mesh.device_type, ranks, mesh_dim_names=rest)

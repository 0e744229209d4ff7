"""GPU accelerator management: device detection, the GPU resource, and
per-worker device visibility.

Reference surface: python/ray/_private/accelerators/nvidia_gpu.py —
`NvidiaGPUAcceleratorManager` counts the node's GPUs, advertises them
as the `GPU` resource, and pins workers to their allocation by
exporting `CUDA_VISIBLE_DEVICES`.

The port of `ray_tpu/_private/accelerators.py`, same shape: the node
service owns a device-id pool sized by the node's GPU resource; each GPU
worker process leases devices at spawn and the pool is repaid when the
worker dies.  Detection asks NVML (the library nvidia-smi reads, which
ships with the driver) and never imports torch or creates a CUDA
context — a context in the driver would hold memory on every card the
workers then share, and cost seconds of `init()`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

# What an entry point says when it needs a GPU and there is none
# (`device.resolve_device`; `GpuTrainer` with use_gpu on a cluster
# without the GPU resource).
NO_GPU_MESSAGE = ("ray_tpu_torch runs on CUDA and no GPU is available; "
                  "pass device='cpu' to run on the CPU explicitly")


def visible_gpu_ids() -> Optional[List[str]]:
    """The devices CUDA_VISIBLE_DEVICES grants this process (None when
    it is unset: every device)."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return None
    return [d.strip() for d in raw.split(",") if d.strip()]


def _nvml_device_count() -> int:
    """Devices NVML reports, as nvidia-smi lists them; 0 without the
    library (no NVIDIA driver, so no CUDA).  NVML creates no CUDA
    context."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    count = ctypes.c_uint(0)
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
        return count.value
    finally:
        nvml.nvmlShutdown()


def detect_num_gpus() -> int:
    """GPU count: env override, then the devices CUDA_VISIBLE_DEVICES
    grants, then NVML."""
    env = os.environ.get("RAY_TPU_NUM_GPUS")
    if env is not None:
        return int(env)
    visible = visible_gpu_ids()
    if visible is not None:
        return len(visible)
    return _nvml_device_count()


def gpu_resources(num_gpus: float) -> Dict[str, float]:
    """The resource dict a GPU host advertises."""
    if not num_gpus:
        return {}
    return {"GPU": float(num_gpus)}


class GpuAllocator:
    """Free-list of local device indices; GPU workers lease
    `RAY_TPU_GPUS_PER_WORKER` (default 1) devices at spawn.  Index i is
    the node's i-th device: the i-th entry of the node process's own
    CUDA_VISIBLE_DEVICES when that is set (an index, a `GPU-` UUID or a
    `MIG-` id, passed on as given), else device i."""

    def __init__(self, num_gpus: int) -> None:
        self._free: List[int] = list(range(int(num_gpus)))
        self._held: Dict[bytes, List[int]] = {}
        self._lock = threading.Lock()
        visible = visible_gpu_ids()
        if visible is not None and len(visible) < len(self._free):
            # Reference: resource_spec.py refuses the same request.
            raise ValueError(
                f"Attempting to start a node with {len(self._free)} GPUs, "
                f"but CUDA_VISIBLE_DEVICES contains {visible}.")
        self._names = (visible if visible is not None else
                       [str(i) for i in self._free])

    def acquire(self, worker_id: bytes,
                count: Optional[int] = None) -> List[int]:
        want = count if count is not None else int(
            os.environ.get("RAY_TPU_GPUS_PER_WORKER", "1"))
        with self._lock:
            # Prefer a full-size lease; fall back to whatever is free.
            # A partial lease may undersize a multi-GPU worker, but an
            # UNPINNED worker would see every device on the node —
            # colliding with live exclusive leases.  Only a
            # fully-drained pool spawns unpinned, and then node
            # resource accounting (GPU: n) is what bounds how many GPU
            # tasks actually run concurrently.
            take = self._free[:want]
            self._free = self._free[want:]
            if take:
                self._held[worker_id] = take
            return take

    def release(self, worker_id: bytes) -> None:
        with self._lock:
            devs = self._held.pop(worker_id, None)
            if devs:
                # Repay in sorted order so reuse is deterministic.
                self._free = sorted(self._free + devs)

    def visible_env(self, devs: List[int]) -> Dict[str, str]:
        """Env pinning a worker to its lease (reference:
        nvidia_gpu.py set_current_process_visible_accelerator_ids)."""
        if not devs:
            return {}
        return {"CUDA_VISIBLE_DEVICES": ",".join(self._names[d]
                                                  for d in devs)}

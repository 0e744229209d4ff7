"""Device resolution for the port's entry points.

The port runs on CUDA.  The CPU is used only when the caller asks for
it (`device="cpu"`, as the tests do); a missing GPU is an error, never
a silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

from ray_tpu_torch._private.accelerators import NO_GPU_MESSAGE

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """CUDA unless the caller names another device.  Raises when CUDA is
    required (no device given, or a cuda device named) but absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(NO_GPU_MESSAGE)
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev

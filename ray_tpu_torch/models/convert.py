"""Weights from the JAX package to the port.

`params_from_jax` takes the JAX parameter pytree as a dict of numpy
arrays — the caller does `jax.tree.map(np.asarray, params)` on the JAX
side, so this module never imports jax — and returns the port's
parameter dict: same keys, same shapes, same dtype, on `device`.  A
quantized leaf (the JAX `QuantizedArray`, whose `q` and `s` that map
turns into numpy) becomes the port's `QuantizedArray`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models.quantize import QuantizedArray
from ray_tpu_torch.models.transformer import TransformerConfig, param_specs


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def convert(specs, node, path):
        if set(specs) != set(node):
            raise ValueError(
                f"parameter keys at {path or '<root>'} differ from the "
                f"layout of this config: missing "
                f"{sorted(set(specs) - set(node))}, unexpected "
                f"{sorted(set(node) - set(specs))}")
        out = {}
        for key, spec in specs.items():
            where = f"{path}/{key}" if path else key
            if isinstance(spec, dict):
                out[key] = convert(spec, node[key], where)
                continue
            leaf = node[key]
            if hasattr(leaf, "q") and hasattr(leaf, "s"):
                out[key] = _quantized(leaf, spec[0], where, dev)
                continue
            arr = np.asarray(leaf)
            if tuple(arr.shape) != tuple(spec[0]):
                raise ValueError(f"{where}: shape {arr.shape} != "
                                 f"expected {spec[0]}")
            # torch.tensor copies: arrays from jax are read-only views.
            out[key] = torch.tensor(arr, device=dev)
        return out

    return convert(param_specs(cfg), tree, "")


def _quantized(leaf, shape, where: str, dev) -> QuantizedArray:
    """int8 q of the weight's shape and an f32 scale of the same rank
    whose axes are 1 or the weight's."""
    q, s = np.asarray(leaf.q), np.asarray(leaf.s)
    if tuple(q.shape) != tuple(shape) or q.dtype != np.int8:
        raise ValueError(f"{where}: quantized q {q.dtype}{q.shape} != "
                         f"expected int8{tuple(shape)}")
    if s.ndim != q.ndim or any(a not in (1, b) for a, b in
                               zip(s.shape, q.shape)):
        raise ValueError(f"{where}: scale shape {s.shape} does not "
                         f"broadcast per channel to {q.shape}")
    return QuantizedArray(torch.tensor(q, device=dev),
                          torch.tensor(s, device=dev))

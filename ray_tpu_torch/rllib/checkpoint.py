"""Algorithm checkpointing (reference: rllib Algorithm.save /
Algorithm.from_checkpoint, algorithms/algorithm.py).

Port of `ray_tpu/rllib/checkpoint.py`.  Each algorithm declares
`_ckpt_attrs`, the attributes that fully determine learner state
(parameter trees, optimizer state, counters), and a `device`.  save()
moves every tensor among them to the CPU and writes them as one pickle;
restore() loads them back onto the algorithm's device, then calls
`_restored()`: an algorithm re-derives its views of the state there, and
the asynchronous ones send the restored weights to their rollout
workers (the synchronous ones send them with every sample anyway).  The
workers hold no learned state of their own, as in the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable

import torch


def map_tensors(fn: Callable, obj: Any) -> Any:
    """`fn` over every tensor in nested dicts, lists and (named) tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


class RLCheckpointMixin:
    _ckpt_attrs: tuple = ()
    device: torch.device

    def save(self, path: str) -> str:
        """Write learner state; `path` is a directory (created)."""
        os.makedirs(path, exist_ok=True)
        state = {name: map_tensors(lambda t: t.detach().cpu(),
                                   getattr(self, name))
                 for name in self._ckpt_attrs}
        state["__class__"] = type(self).__name__
        out = os.path.join(path, "algorithm_state.pkl")
        tmp = out + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=5)
        os.replace(tmp, out)
        return out

    def restore(self, path: str) -> None:
        """Load state written by save(); accepts the directory or the
        state file itself."""
        if os.path.isdir(path):
            path = os.path.join(path, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        cls = state.pop("__class__", type(self).__name__)
        if cls != type(self).__name__:
            raise ValueError(
                f"checkpoint was written by {cls}, not "
                f"{type(self).__name__}")
        for name, value in state.items():
            setattr(self, name, map_tensors(lambda t: t.to(self.device),
                                            value))
        self._restored()

    def _restored(self) -> None:
        """Called after restore() has set the state."""

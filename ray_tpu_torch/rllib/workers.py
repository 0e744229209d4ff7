"""What every rollout worker and online driver shares: trees crossing to
the workers as numpy, the workers' own random streams, sampling from
drawn noise, spawning, gathering with a timeout and stopping.

Workers are CPU actors (`num_cpus=1`, no GPU: the runtime gives them an
empty CUDA_VISIBLE_DEVICES, so they cannot make a CUDA context) that run
policy inference in torch on the CPU, one thread each.  The learner's
parameters reach them as numpy trees through the object store
(`host_tree`), whatever device the learner runs on.

Each worker draws from its own `torch.Generator`, seeded as its JAX
counterpart seeds its key or RandomState, and draws the whole rollout's
noise before it steps the envs.  `sample(..., draws=)` takes that noise
instead, so a test can hand a worker the noise JAX's worker draws from
the same keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.optim import tree_map

# Seconds a driver waits for a worker's rollout (or a stream's batch).
SAMPLE_TIMEOUT_S = 300.0
# The smallest positive f32: jax.random.gumbel's lower bound on U.
_TINY = float(np.finfo(np.float32).tiny)


def worker_generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


def host_tree(tree) -> Any:
    """A parameter tree as numpy on the host: what crosses to workers."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def cpu_tree(tree) -> Any:
    """A numpy (or tensor) tree as CPU tensors the worker may keep."""
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to("cpu")
        return torch.tensor(np.asarray(a))     # a copy: store views are
                                               # read-only
    return tree_map(leaf, tree)


def as_cpu(x, dtype=None) -> torch.Tensor:
    """A draw given as numpy or a tensor, on the CPU."""
    t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    t = t.to("cpu")
    return t if dtype is None else t.to(dtype)


def obs_tensor(obs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(obs, np.float32))


def gumbel(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1), as
    jax.random.gumbel draws it."""
    u = torch.rand(tuple(shape), generator=gen).clamp_(min=_TINY)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, noise: torch.Tensor):
    """(action, log pi(action)) for rows of logits: the argmax of logits
    plus Gumbel noise, which is how jax.random.categorical samples."""
    action = torch.argmax(logits + noise, dim=-1)
    logp = F.log_softmax(logits, -1).gather(-1, action[..., None])[..., 0]
    return action, logp


def worker_draws(draws: Optional[Dict[str, Any]], index: int):
    """Worker `index`'s share of a driver's `draws` (None: its own)."""
    return None if draws is None else draws["workers"][index]


def spawn(cls, n: int, make_args: Callable[[int], tuple],
          **options) -> List[Any]:
    """n CPU worker actors of `cls`, worker i built from make_args(i)."""
    opts = {"num_cpus": 1, "num_gpus": 0, **options}
    return [cls.options(**opts).remote(*make_args(i)) for i in range(n)]


def gather(refs: List[Any]) -> List[Any]:
    return ray_tpu_torch.get(refs, timeout=SAMPLE_TIMEOUT_S)


def kill_all(workers: List[Any]) -> None:
    for w in workers:
        try:
            ray_tpu_torch.kill(w)
        except Exception:
            pass


def reward_mean(window: List[float]) -> float:
    return float(np.mean(window)) if window else 0.0


def floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar tensor metrics read from the learner's device in one
    transfer."""
    if not metrics:
        return {}
    values = torch.stack([v.reshape(()).float()
                          for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))

"""Learner weights and optimizer state between the JAX package and the
port.

The JAX side hands over its trees as numpy (`jax.tree.map(np.asarray,
tree)`), so this module never imports jax.  Trees keep their keys: the
MLP policy, the conv policy, SAC's actor, q1, q2 and the 0-d
`log_alpha`.  The one change of layout is a conv kernel: JAX's HWIO
becomes torch's OIHW (every 4-d leaf is one).  The conv policy flattens
its activations in NHWC order on both sides, so `fc` keeps its rows.

optax's Adam state (`ScaleByAdamState(count, mu, nu)`, alone or first in
`optax.adam`'s chain) becomes `optim.AdamState` with a host int count.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.optim import AdamState, tree_map

HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None
                    ) -> Dict[str, Any]:
    """A JAX parameter tree (numpy leaves) as the port's, on `device`."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(HWIO_TO_OIHW)
        # torch.tensor copies: arrays from jax are read-only views.
        return torch.tensor(a, device=dev)

    return tree_map(leaf, tree)


def params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree as numpy in the JAX package's layout."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        return a.transpose(OIHW_TO_HWIO) if a.ndim == 4 else a

    return tree_map(leaf, tree)


def _adam_leaves(opt_state):
    """optax's ScaleByAdamState, given alone or as the first element of
    `optax.adam`'s (ScaleByAdamState, EmptyState) chain."""
    if not hasattr(opt_state, "mu"):
        opt_state = opt_state[0]
    return opt_state.count, opt_state.mu, opt_state.nu


def adam_state_from_jax(opt_state, device: DeviceLike = None) -> AdamState:
    count, mu, nu = _adam_leaves(opt_state)
    return AdamState(int(np.asarray(count)), params_from_jax(mu, device),
                     params_from_jax(nu, device))


def adam_state_to_jax(state: AdamState) -> AdamState:
    """(count as int32, mu, nu) as numpy in JAX's layout, the fields of
    optax's ScaleByAdamState."""
    return AdamState(np.asarray(state.count, np.int32),
                     params_to_jax(state.mu), params_to_jax(state.nu))

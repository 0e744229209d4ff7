"""Functional pieces every learner shares: parameter trees, Adam as optax
keeps it, and gradients of a loss over a tree.

Parameters are nested dicts of tensors with the JAX package's keys (a bare
tensor, such as SAC's `log_alpha`, is a tree of one leaf).  Leaves are
ordered as JAX orders a pytree (sorted dict keys), so a gradient list, an
Adam moment and a converted optax state line up leaf by leaf.

`Adam` is `optax.adam(lr)`: the state is `AdamState(count, mu, nu)`,
optax's `ScaleByAdamState`, with the same arithmetic (moments
`(1 - b) * g + b * m`, bias correction by `1 - b ** count` in f32,
`mu_hat / (sqrt(nu_hat) + eps)`, times `-lr`).  `torch.optim` is not used:
its state cannot be matched to optax's leaf by leaf.  `step_` updates the
parameters and moments in place, where JAX donates them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (or a bare tensor) in sorted-key
    order."""
    if not isinstance(tree, dict):
        return [tree]
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        out.extend(tree_leaves(tree[key]))
    return out


def tree_unflatten(tree, leaves) -> Any:
    """`tree`'s structure with `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}

    return build(tree)


def tree_map(fn: Callable, tree) -> Any:
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def tree_copy(tree) -> Any:
    """A copy in new storage: a target network is never an alias of the
    online parameters, which the updates change in place."""
    return tree_map(lambda t: t.detach().clone(), tree)


def value_and_grad(loss_fn: Callable, params, *args, has_aux: bool = False
                   ) -> Tuple[Any, List[torch.Tensor]]:
    """(loss_fn(params, *args), gradients in `tree_leaves` order), as
    `jax.value_and_grad` with respect to the first argument.  The
    returned value (and aux) is detached.  A leaf the loss does not use
    gets a zero gradient, as in JAX."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    out = loss_fn(tree_unflatten(params, live), *args)
    loss = out[0] if has_aux else out
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    if has_aux:
        return (loss.detach(), _detach(out[1])), list(grads)
    return loss.detach(), list(grads)


def _detach(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, dict):
        return {k: _detach(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_detach(v) for v in obj)
    return obj


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: `count` is the number of steps taken (a
    host int: the step count is known without reading the card)."""
    count: int
    mu: Any
    nu: Any


class Adam:
    """optax.adam(lr) with b1 0.9, b2 0.999, eps 1e-8, eps_root 0."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def step_(self, params, grads: List[torch.Tensor], state: AdamState
              ) -> AdamState:
        """One update of `params` and the moments in place; `grads` in
        `tree_leaves(params)` order.  Returns the new state."""
        p, mu, nu = (tree_leaves(t) for t in (params, state.mu, state.nu))
        inc = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(inc))
        bc2 = float(f32(1) - f32(self.b2) ** f32(inc))
        g1 = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(p, upd)
        return AdamState(inc, state.mu, state.nu)


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """The learner's explicit random stream, on its device."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def seeded_params(seed: int, device: torch.device, init: Callable) -> Any:
    """`init(generator)`'s tree drawn on the CPU from `seed`, then moved
    to `device`: one seed gives the same initial weights on every
    device, as a JAX key does (torch's CUDA generator draws other
    numbers than its CPU one)."""
    tree = init(make_generator(seed, "cpu"))
    return tree_map(lambda t: t.to(device), tree)


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def as_tensors(batch: Dict[str, Any], device: torch.device,
               ints: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on `device`, typed as JAX
    would hold it: the index columns named in `ints` as int64, flags and
    float64 as float32, the rest as given."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
            if not v.flags.writeable:      # a view of a JAX array
                v = v.copy()
        t = torch.as_tensor(v, device=device)
        if k in ints:
            t = t.long()
        elif t.dtype in (torch.bool, torch.float64):
            t = t.float()
        out[k] = t
    return out


def randint(gen: torch.Generator, n: int, shape) -> torch.Tensor:
    """Uniform indices in [0, n) (`jax.random.randint(key, shape, 0, n)`'s
    role), int64 on the generator's device."""
    return torch.randint(0, n, tuple(shape), generator=gen,
                         device=gen.device)


def resolve_draws(draws: Optional[Dict[str, Any]], rng, draw: Callable,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The update's randomness, on the learner's device (index draws as
    int64): `draws` when the caller gives them (the seam the parity tests
    use, with JAX's draws from the same key), else `draw(rng)` from the
    learner's generator."""
    if draws is None:
        if rng is None:
            raise ValueError("pass a torch.Generator (rng) or the draws")
        draws = draw(rng)
    return as_tensors(draws, device, ints=("ix", "perms"))

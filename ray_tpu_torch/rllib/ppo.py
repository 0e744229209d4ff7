"""PPO's learner: the MLP policy, GAE and the clipped-surrogate update.

Port of `ray_tpu/rllib/ppo.py`.  JAX runs the update as one jitted program
(a reverse `lax.scan` for GAE, then `lax.scan`s over epochs and
minibatches); here it is the same arithmetic issued step by step on the
learner's device.  The randomness, one permutation per epoch, is drawn
first (`draw`) and then consumed, so a caller can pass JAX's draws
instead.  The rollout workers and the `PPO` algorithm need the actor runtime
(ROADMAP A8b): `PPOConfig.build()` raises until it lands.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, resolve_draws,
                                       value_and_grad)

WAITS_ON_RUNTIME = ("{} needs the actor runtime's rollout workers "
                    "(ROADMAP A8b, after A2); the learner is ported: {}")


def dense(rng: torch.Generator, n_in: int, n_out: int) -> Dict[str, Any]:
    """He-normal weight and zero bias, as the JAX package draws them."""
    w = torch.randn((n_in, n_out), generator=rng, device=rng.device)
    return {"w": w * math.sqrt(2.0 / n_in),
            "b": torch.zeros((n_out,), device=rng.device)}


def init_policy(rng: torch.Generator, obs_size: int, num_actions: int,
                hidden: int = 64) -> Dict[str, Any]:
    """Actor and critic heads over a two-layer tanh torso, on the
    generator's device."""
    return {"l1": dense(rng, obs_size, hidden),
            "l2": dense(rng, hidden, hidden),
            "pi": dense(rng, hidden, num_actions),
            "vf": dense(rng, hidden, 1)}


def _torso(params, obs):
    x = torch.tanh(obs @ params["l1"]["w"] + params["l1"]["b"])
    return torch.tanh(x @ params["l2"]["w"] + params["l2"]["b"])


def policy_forward(params, obs):
    """obs [..., obs_size] -> (logits [..., A], value [...])."""
    x = _torso(params, obs)
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def logits_forward(params, obs):
    """The actor head alone (what JAX's jit keeps of `policy_forward` when
    the value is unused)."""
    x = _torso(params, obs)
    return x @ params["pi"]["w"] + params["pi"]["b"]


def take(logp_all, actions):
    """logp_all[..., a] for each action (take_along_axis on the last
    axis)."""
    return logp_all.gather(-1, actions[..., None])[..., 0]


def gae(rewards, values, dones, gamma: float, lam: float):
    """Generalized advantage estimates by a reverse loop over T; `values`
    has T + 1 rows (the last is the bootstrap)."""
    nonterm = 1.0 - dones
    advs = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * values[t + 1] * nonterm[t] - values[t]
        carry = delta + gamma * lam * nonterm[t] * carry
        advs[t] = carry
    return advs


def make_update_fn(optimizer: Adam, clip: float, vf_coef: float,
                   ent_coef: float, gamma: float, lam: float,
                   num_minibatches: int, num_epochs: int,
                   device: DeviceLike = None) -> Callable:
    """update(params, opt_state, rollout, rng=None, draws=None) ->
    (params, opt_state, metrics).  `rollout` holds obs [T, N, ...],
    actions, logp, rewards, dones [T, N] and values [T + 1, N];
    `rng` is a torch.Generator, or `draws` gives {"perms": [num_epochs,
    T * N]} directly (`update.draw(rng, rollout)` draws them).
    Parameters and moments change in place."""
    dev = resolve_device(device)

    def loss_fn(params, batch):
        logits, value = policy_forward(params, batch["obs"])
        logp_all = F.log_softmax(logits, -1)
        logp = take(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv,
                            torch.clamp(ratio, 1 - clip, 1 + clip) * adv
                            ).mean()
        vf = 0.5 * ((value - batch["returns"]) ** 2).mean()
        ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pg + vf_coef * vf - ent_coef * ent
        return total, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    def draw(rng, rollout):
        B = rollout["rewards"].shape[0] * rollout["rewards"].shape[1]
        return {"perms": torch.stack([
            torch.randperm(B, generator=rng, device=rng.device)
            for _ in range(num_epochs)])}

    def update(params, opt_state, rollout, rng=None,
               draws: Optional[Dict[str, Any]] = None):
        r = as_tensors(rollout, dev, ints=("actions",))
        rewards = r["rewards"]
        T, N = rewards.shape
        B = T * N
        mb = B // num_minibatches
        perms = resolve_draws(draws, rng, lambda g: draw(g, r),
                              dev)["perms"]
        advs = gae(rewards, r["values"], r["dones"], gamma, lam)
        flat = {"obs": r["obs"].reshape(B, -1),
                "actions": r["actions"].reshape(B),
                "logp": r["logp"].reshape(B),
                "adv": advs.reshape(B),
                "returns": (advs + r["values"][:-1]).reshape(B)}
        history = []
        for e in range(num_epochs):
            for i in range(num_minibatches):
                sl = perms[e, i * mb:(i + 1) * mb]
                batch = {k: v[sl] for k, v in flat.items()}
                (_, metrics), grads = value_and_grad(
                    loss_fn, params, batch, has_aux=True)
                opt_state = optimizer.step_(params, grads, opt_state)
                history.append(metrics)
        return params, opt_state, {
            k: torch.stack([m[k] for m in history]).mean()
            for k in history[0]}

    update.draw = draw
    return update


class PPOConfig:
    def __init__(self) -> None:
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_len = 128
        self.env_maker: Optional[Callable] = None
        self.env_max_steps = 200
        self.lr = 3e-4
        self.gamma = 0.99
        self.lam = 0.95
        self.clip = 0.2
        self.vf_coef = 0.5
        self.ent_coef = 0.01
        self.num_minibatches = 4
        self.num_epochs = 4
        self.hidden = 64
        self.seed = 0

    def rollouts(self, *, num_rollout_workers=None,
                 num_envs_per_worker=None,
                 rollout_len=None) -> "PPOConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_len is not None:
            self.rollout_len = rollout_len
        return self

    def environment(self, env_maker=None, *,
                    max_steps=None) -> "PPOConfig":
        if env_maker is not None:
            self.env_maker = env_maker
        if max_steps is not None:
            self.env_max_steps = max_steps
        return self

    def training(self, *, lr=None, gamma=None, lam=None, clip=None,
                 vf_coef=None, ent_coef=None, num_minibatches=None,
                 num_epochs=None, hidden=None) -> "PPOConfig":
        for k, v in dict(lr=lr, gamma=gamma, lam=lam, clip=clip,
                         vf_coef=vf_coef, ent_coef=ent_coef,
                         num_minibatches=num_minibatches,
                         num_epochs=num_epochs, hidden=hidden).items():
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self):
        raise NotImplementedError(WAITS_ON_RUNTIME.format(
            "PPO", "make_update_fn"))

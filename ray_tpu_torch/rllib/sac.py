"""SAC's learner: the squashed-Gaussian actor, twin Q critics and the
critic / actor / temperature update with Polyak targets.

Port of `ray_tpu/rllib/sac.py`.  Each grad step updates the critics, then
the actor against the updated critics, then alpha with the actor's
log-probabilities, then moves the target critics by Polyak averaging in
place (they are their own storage, never an alias of the critics).  The
randomness is drawn first: the minibatch indices [num_grad_steps,
batch_size] and two standard-normal tensors [num_grad_steps, batch_size,
A] (the critic target's next actions, the actor's actions), from the
learner's generator or given as `draws`.  The stochastic workers and the
`SAC` algorithm need the actor runtime (ROADMAP A8b).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, normal, randint,
                                       resolve_draws, tree_copy,
                                       tree_leaves, value_and_grad)
from ray_tpu_torch.rllib.ppo import dense

LOG_STD_MIN = -10.0
LOG_STD_MAX = 2.0
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
LOG_2 = math.log(2.0)


def init_sac(rng: torch.Generator, obs_size: int, act_size: int,
             hidden: int = 128) -> Dict[str, Any]:
    def mlp(n_in, head, n_out):
        return {"l1": dense(rng, n_in, hidden),
                "l2": dense(rng, hidden, hidden),
                head: dense(rng, hidden, n_out)}

    actor = mlp(obs_size, "mu", act_size)
    actor["log_std"] = dense(rng, hidden, act_size)
    return {"actor": actor,
            "q1": mlp(obs_size + act_size, "q", 1),
            "q2": mlp(obs_size + act_size, "q", 1),
            "log_alpha": torch.zeros((), device=rng.device)}


def actor_forward(actor, obs):
    x = torch.tanh(obs @ actor["l1"]["w"] + actor["l1"]["b"])
    x = torch.tanh(x @ actor["l2"]["w"] + actor["l2"]["b"])
    mu = x @ actor["mu"]["w"] + actor["mu"]["b"]
    log_std = torch.clamp(x @ actor["log_std"]["w"] + actor["log_std"]["b"],
                          LOG_STD_MIN, LOG_STD_MAX)
    return mu, log_std


def sample_action(actor, obs, noise, action_scale: float):
    """Reparameterized tanh-Gaussian action and its log-density, from a
    standard-normal `noise` of the action's shape (JAX's
    `sample_action(actor, obs, key, ...)` draws it from `key`)."""
    mu, log_std = actor_forward(actor, obs)
    std = torch.exp(log_std)
    u = mu + std * noise
    logp = (-0.5 * ((u - mu) / std) ** 2 - log_std - HALF_LOG_2PI).sum(-1)
    # stable log(1 - tanh(u)^2) = 2*(log2 - u - softplus(-2u))
    logp = logp - (2.0 * (LOG_2 - u - F.softplus(-2.0 * u))).sum(-1)
    return torch.tanh(u) * action_scale, logp


def q_value(q, obs, act):
    x = torch.cat([obs, act], -1)
    x = torch.tanh(x @ q["l1"]["w"] + q["l1"]["b"])
    x = torch.tanh(x @ q["l2"]["w"] + q["l2"]["b"])
    return (x @ q["q"]["w"] + q["q"]["b"])[..., 0]


def min_q(qs, obs, act):
    return torch.minimum(q_value(qs["q1"], obs, act),
                         q_value(qs["q2"], obs, act))


def init_state(params, actor_opt: Adam, critic_opt: Adam, alpha_opt: Adam
               ) -> tuple:
    """The learner state the update carries: (actor, qs, target_qs,
    log_alpha, actor_opt_state, critic_opt_state, alpha_opt_state), the
    target critics a copy."""
    qs = {"q1": params["q1"], "q2": params["q2"]}
    return (params["actor"], qs, tree_copy(qs), params["log_alpha"],
            actor_opt.init(params["actor"]), critic_opt.init(qs),
            alpha_opt.init(params["log_alpha"]))


def make_grad_step(critic_loss, actor_opt: Adam, critic_opt: Adam,
                   alpha_opt: Adam, tau: float, target_entropy: float,
                   action_scale: float) -> Callable:
    """One SAC-family grad step: step(state, batch, critic_args,
    actor_noise) -> (state, critic loss, critic aux, actor loss, logp).
    `critic_loss(qs, actor, target_qs, log_alpha, batch, *critic_args)`
    returns (loss, aux)."""

    def actor_loss(actor, qs, log_alpha, batch, noise):
        a, logp = sample_action(actor, batch["obs"], noise, action_scale)
        q = min_q(qs, batch["obs"], a)
        return (torch.exp(log_alpha).detach() * logp - q).mean(), logp

    def alpha_loss(log_alpha, logp):
        return (-torch.exp(log_alpha) * (logp + target_entropy)).mean()

    def step(state, batch, critic_args, actor_noise):
        actor, qs, target_qs, log_alpha, a_opt, c_opt, al_opt = state
        (closs, caux), cgrad = value_and_grad(
            critic_loss, qs, actor, target_qs, log_alpha, batch,
            *critic_args, has_aux=True)
        c_opt = critic_opt.step_(qs, cgrad, c_opt)
        (aloss, logp), agrad = value_and_grad(
            actor_loss, actor, qs, log_alpha, batch, actor_noise,
            has_aux=True)
        a_opt = actor_opt.step_(actor, agrad, a_opt)
        _, algrad = value_and_grad(alpha_loss, log_alpha, logp)
        al_opt = alpha_opt.step_(log_alpha, algrad, al_opt)
        with torch.no_grad():
            for t, o in zip(tree_leaves(target_qs), tree_leaves(qs)):
                t.mul_(1.0 - tau).add_(tau * o)
        return ((actor, qs, target_qs, log_alpha, a_opt, c_opt, al_opt),
                closs, caux, aloss, logp)

    return step


def make_update_fn(actor_opt: Adam, critic_opt: Adam, alpha_opt: Adam,
                   gamma: float, tau: float, target_entropy: float,
                   num_grad_steps: int, batch_size: int,
                   action_scale: float, device: DeviceLike = None
                   ) -> Callable:
    """update(state, data, rng=None, draws=None) -> (state, mean critic
    loss, mean actor loss, mean entropy); `state` as `init_state` builds
    it, changed in place; `draws` {"ix": [S, B], "noise_next": [S, B, A],
    "noise_pi": [S, B, A]} (`update.draw(rng, data)` draws them)."""
    dev = resolve_device(device)

    def critic_loss(qs, actor, target_qs, log_alpha, batch, noise):
        with torch.no_grad():
            next_a, next_logp = sample_action(actor, batch["next_obs"],
                                              noise, action_scale)
            tq = min_q(target_qs, batch["next_obs"], next_a)
            target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * (
                tq - torch.exp(log_alpha) * next_logp)
        l1 = ((q_value(qs["q1"], batch["obs"], batch["actions"])
               - target) ** 2).mean()
        l2 = ((q_value(qs["q2"], batch["obs"], batch["actions"])
               - target) ** 2).mean()
        return l1 + l2, None

    grad_step = make_grad_step(critic_loss, actor_opt, critic_opt,
                               alpha_opt, tau, target_entropy,
                               action_scale)

    def draw(rng, data):
        (n, A), S, B = data["actions"].shape, num_grad_steps, batch_size
        return {"ix": randint(rng, n, (S, B)),
                "noise_next": normal(rng, (S, B, A)),
                "noise_pi": normal(rng, (S, B, A))}

    def update(state, data, rng=None,
               draws: Optional[Dict[str, Any]] = None):
        d = as_tensors(data, dev)
        r = resolve_draws(draws, rng, lambda g: draw(g, d), dev)
        closses, alosses, entropies = [], [], []
        for s in range(num_grad_steps):
            batch = {k: v[r["ix"][s]] for k, v in d.items()}
            state, closs, _, aloss, logp = grad_step(
                state, batch, (r["noise_next"][s],), r["noise_pi"][s])
            closses.append(closs)
            alosses.append(aloss)
            entropies.append(-logp.mean())
        return (state, torch.stack(closses).mean(),
                torch.stack(alosses).mean(), torch.stack(entropies).mean())

    update.draw = draw
    return update

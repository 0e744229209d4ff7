"""SAC: the squashed-Gaussian actor, twin Q critics, the critic / actor /
temperature update with Polyak targets, the stochastic workers and the
algorithm.

Port of `ray_tpu/rllib/sac.py`.  Each grad step updates the critics, then
the actor against the updated critics, then alpha with the actor's
log-probabilities, then moves the target critics by Polyak averaging in
place (they are their own storage, never an alias of the critics).  The
randomness is drawn first: the minibatch indices [num_grad_steps,
batch_size] and two standard-normal tensors [num_grad_steps, batch_size,
A] (the critic target's next actions, the actor's actions), from the
learner's generator or given as `draws`.

`SACWorker` actors act with the squashed Gaussian on the CPU (its
normals drawn first), or uniformly over the action box while the buffer
warms up (`uniform_random`); `SAC.train()` adds their transitions to the
replay buffer and, past `learning_starts`, runs one update on the
learner's device.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import workers as wk
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.dqn import ReplayBuffer
from ray_tpu_torch.rllib.env import PendulumEnv, VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, make_generator,
                                       normal, randint, resolve_draws,
                                       seeded_params, tree_copy,
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


@ray_tpu_torch.remote
class SACWorker:
    """Stochastic-policy transition collector (reference: off-policy
    EnvRunner sampling)."""

    def __init__(self, worker_index: int, num_envs: int,
                 rollout_len: int, env_maker=None,
                 max_steps: int = 200,
                 action_scale: float = 2.0) -> None:
        torch.set_num_threads(1)
        maker = env_maker or (
            lambda seed: PendulumEnv(max_steps=max_steps, seed=seed))
        self.vec = VectorEnv(maker, num_envs,
                             seed=9000 * (worker_index + 1))
        self.rollout_len = rollout_len
        self.obs = self.vec.reset()
        self.rng = wk.worker_generator(1234 + worker_index)
        self._action_scale = action_scale

    @torch.no_grad()
    def sample(self, actor, uniform_random: bool = False,
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One rollout.  Warm-up (`uniform_random`) acts uniformly over
        [-scale, scale]; else the squashed Gaussian.  `draws` gives
        {"uniform": [T, N, A]} (the actions themselves) or {"noise":
        [T, N, A]} (standard normals)."""
        p = wk.cpu_tree(actor)
        T, N = self.rollout_len, self.vec.num_envs
        A = self.vec.envs[0].action_size
        s = self._action_scale
        if draws is not None:
            drawn = wk.as_cpu(draws["uniform" if uniform_random
                                    else "noise"], torch.float32)
        elif uniform_random:      # warmup: cover the action space
            drawn = torch.rand((T, N, A), generator=self.rng) * (2 * s) - s
        else:
            drawn = torch.randn((T, N, A), generator=self.rng)
        obs_b, act_b, rew_b, nobs_b, done_b = [], [], [], [], []
        for t in range(T):
            if uniform_random:
                action = drawn[t].numpy()
            else:
                action, _ = sample_action(p, wk.obs_tensor(self.obs),
                                          drawn[t], s)
                action = action.numpy()
            prev = self.obs
            self.obs, rew, done = self.vec.step(action)
            obs_b.append(prev)
            act_b.append(action)
            rew_b.append(rew)
            nobs_b.append(self.obs)
            done_b.append(done)
        return {"obs": np.concatenate(obs_b),
                "actions": np.concatenate(act_b),
                "rewards": np.concatenate(rew_b),
                "next_obs": np.concatenate(nobs_b),
                "dones": np.concatenate(done_b),
                "episode_returns": self.vec.drain_episode_returns()}


class SACConfig:
    def __init__(self) -> None:
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_len = 32
        self.env_maker: Optional[Callable] = None
        self.env_max_steps = 200
        self.obs_size = PendulumEnv.observation_size
        self.action_size = PendulumEnv.action_size
        self.action_scale = PendulumEnv.action_high
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.target_entropy: Optional[float] = None   # -action_size
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.batch_size = 128
        self.num_grad_steps = 64
        self.hidden = 128
        self.seed = 0

    def rollouts(self, **kw) -> "SACConfig":
        for k, v in kw.items():
            if k == "max_steps":
                k = "env_max_steps"
            if not hasattr(self, k):
                raise ValueError(f"unknown SAC config option {k!r}")
            setattr(self, k, v)
        return self

    training = rollouts
    environment = rollouts

    def build(self, device: DeviceLike = None) -> "SAC":
        return SAC(self, device=device)


class SAC(RLCheckpointMixin):
    """`_state` is the update's (actor, qs, target_qs, log_alpha, and the
    three Adam states); `actor`, `qs`, `target_qs` and `log_alpha` are
    views of it."""

    _ckpt_attrs = ("_state", "iteration")

    def __init__(self, config: SACConfig, device: DeviceLike = None
                 ) -> None:
        c = self.config = config
        self.device = resolve_device(device)
        self._rng = make_generator(c.seed, self.device)
        params = seeded_params(c.seed, self.device, lambda g: init_sac(
            g, c.obs_size, c.action_size, hidden=c.hidden))
        opts = (Adam(c.actor_lr), Adam(c.critic_lr), Adam(c.alpha_lr))
        self._state = init_state(params, *opts)
        self._views()
        target_ent = (c.target_entropy if c.target_entropy is not None
                      else -float(c.action_size))
        self._update = make_update_fn(
            *opts, c.gamma, c.tau, target_ent, c.num_grad_steps,
            c.batch_size, c.action_scale, device=self.device)
        # Replay stores flat continuous actions: the DQN ring buffer
        # with an action matrix instead of an int vector.
        self.buffer = ReplayBuffer(c.buffer_capacity, c.obs_size)
        self.buffer.actions = np.zeros(
            (c.buffer_capacity, c.action_size), np.float32)
        self.workers = wk.spawn(SACWorker, c.num_rollout_workers,
                                lambda i: (i, c.num_envs_per_worker,
                                           c.rollout_len, c.env_maker,
                                           c.env_max_steps,
                                           c.action_scale))
        self._np_rng = np.random.RandomState(c.seed)
        self.iteration = 0
        self._reward_window: List[float] = []

    def _views(self) -> None:
        self.actor, self.qs, self.target_qs, self.log_alpha = \
            self._state[:4]

    _restored = _views

    def train(self, draws: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """One iteration; `draws` {"workers": [...], "update": {...}}
        replaces every random draw but the buffer's numpy one."""
        c = self.config
        t0 = time.time()
        warmup = self.buffer.size < c.learning_starts
        actor_ref = ray_tpu_torch.put(wk.host_tree(self.actor))
        samples = wk.gather([
            w.sample.remote(actor_ref, warmup, wk.worker_draws(draws, i))
            for i, w in enumerate(self.workers)])
        t1 = time.time()
        episode_returns = []
        for s in samples:
            self.buffer.add_batch(s["obs"], s["actions"], s["rewards"],
                                  s["next_obs"], s["dones"])
            episode_returns.extend(s["episode_returns"])
        self._reward_window.extend(episode_returns)
        self._reward_window = self._reward_window[-50:]

        losses = {"critic_loss": float("nan"), "actor_loss": float("nan"),
                  "entropy": float("nan")}
        if self.buffer.size >= c.learning_starts:
            slab = self.buffer.sample(self._np_rng,
                                      c.batch_size * c.num_grad_steps)
            self._state, closs, aloss, entropy = self._update(
                self._state, slab, self._rng,
                draws=None if draws is None else draws["update"])
            self._views()
            losses = wk.floats({"critic_loss": closs, "actor_loss": aloss,
                                "entropy": entropy})
        self.iteration += 1
        t2 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": wk.reward_mean(self._reward_window),
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": sum(len(s["actions"]) for s in samples),
            "buffer_size": self.buffer.size,
            "critic_loss": losses["critic_loss"],
            "actor_loss": losses["actor_loss"],
            "alpha": float(torch.exp(self.log_alpha)),
            "entropy": losses["entropy"],
            "time_this_iter_s": t2 - t0,
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def stop(self) -> None:
        wk.kill_all(self.workers)

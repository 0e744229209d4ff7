"""PPO: the MLP policy, GAE, the clipped-surrogate update, the rollout
workers and the algorithm.

Port of `ray_tpu/rllib/ppo.py`.  JAX runs the update as one jitted program
(a reverse `lax.scan` for GAE, then `lax.scan`s over epochs and
minibatches); here it is the same arithmetic issued step by step on the
learner's device.  The randomness, one permutation per epoch, is drawn
first (`draw`) and then consumed, so a caller can pass JAX's draws
instead.

`RolloutWorker` actors (CPU, one thread each; see `workers.py`) step
vectorized envs with the policy in torch on the CPU; `PPO.train()` puts
the parameters once, gathers every worker's rollout and runs one update
on the learner's device (`build(device=None)`: CUDA unless named).
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
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, make_generator,
                                       resolve_draws, seeded_params,
                                       value_and_grad)


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


@ray_tpu_torch.remote
class RolloutWorker:
    """Collects `rollout_len` vector-env steps per sample() call
    (reference: evaluation/rollout_worker.py sample())."""

    def __init__(self, worker_index: int, num_envs: int,
                 rollout_len: int, env_maker=None,
                 max_steps: int = 200) -> None:
        torch.set_num_threads(1)
        maker = env_maker or (
            lambda seed: CartPoleEnv(max_steps=max_steps, seed=seed))
        self.vec = VectorEnv(maker, num_envs,
                             seed=1000 * (worker_index + 1))
        self.rollout_len = rollout_len
        self.obs = self.vec.reset()
        self.rng = wk.worker_generator(worker_index)

    @torch.no_grad()
    def sample(self, params, draws: Optional[Dict[str, Any]] = None
               ) -> Dict[str, np.ndarray]:
        """One rollout; `draws` {"gumbel": [T, N, A]} replaces the
        worker's own noise."""
        p = wk.cpu_tree(params)
        T, N = self.rollout_len, self.vec.num_envs
        A = p["pi"]["b"].shape[0]
        noise = (wk.gumbel(self.rng, (T, N, A)) if draws is None
                 else wk.as_cpu(draws["gumbel"], torch.float32))
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T + 1, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        for t in range(T):
            logits, value = policy_forward(p, wk.obs_tensor(self.obs))
            action, logp = wk.categorical(logits, noise[t])
            obs_buf[t] = self.obs
            act_buf[t] = action.numpy()
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            self.obs, rew_buf[t], done_buf[t] = self.vec.step(act_buf[t])
        _, last_val = policy_forward(p, wk.obs_tensor(self.obs))
        val_buf[T] = last_val.numpy()
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "values": val_buf, "rewards": rew_buf,
                "dones": done_buf,
                "episode_returns": self.vec.drain_episode_returns()}


ROLLOUT_KEYS = ("obs", "actions", "logp", "values", "rewards", "dones")


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

    def build(self, device: DeviceLike = None) -> "PPO":
        return PPO(self, device=device)


class PPO(RLCheckpointMixin):
    """Trainer: parallel actor sampling + one learner update per train()
    on the learner's device (reference: Algorithm.train result dict)."""

    _ckpt_attrs = ("params", "opt_state", "iteration")

    def __init__(self, config: PPOConfig, device: DeviceLike = None
                 ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self._rng = make_generator(config.seed, self.device)
        self.params = seeded_params(config.seed, self.device, lambda g: (
            init_policy(g, CartPoleEnv.observation_size,
                        CartPoleEnv.num_actions, hidden=config.hidden)))
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = make_update_fn(
            self.optimizer, config.clip, config.vf_coef, config.ent_coef,
            config.gamma, config.lam, config.num_minibatches,
            config.num_epochs, device=self.device)
        self.workers = wk.spawn(RolloutWorker, config.num_rollout_workers,
                                lambda i: (i, config.num_envs_per_worker,
                                           config.rollout_len,
                                           config.env_maker,
                                           config.env_max_steps))
        self.iteration = 0
        self._reward_window: List[float] = []

    def sample(self, draws: Optional[Dict[str, Any]] = None
               ) -> List[Dict[str, np.ndarray]]:
        """Every worker's rollout from the current parameters, put
        once; `draws["workers"][i]` is worker i's noise."""
        params_ref = ray_tpu_torch.put(wk.host_tree(self.params))
        return wk.gather([w.sample.remote(params_ref,
                                          wk.worker_draws(draws, i))
                          for i, w in enumerate(self.workers)])

    def learn(self, rollout: Dict[str, np.ndarray],
              draws: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One update on a rollout [T, N_total, ...]; `draws` {"perms":
        ...} replaces the learner's."""
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, rollout, self._rng, draws=draws)
        return wk.floats(metrics)

    def train(self, draws: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """One iteration.  `draws` {"workers": [per worker], "update":
        {...}} replaces every random draw of it (the parity tests' seam)."""
        t0 = time.time()
        samples = self.sample(draws)
        t1 = time.time()
        # Concat workers along the env axis -> [T, N_total, ...]
        rollout = {k: np.concatenate([s[k] for s in samples], axis=1)
                   for k in ROLLOUT_KEYS}
        episode_returns = [r for s in samples
                           for r in s["episode_returns"]]
        self._reward_window.extend(episode_returns)
        self._reward_window = self._reward_window[-100:]
        metrics = self.learn(rollout,
                             None if draws is None else draws["update"])
        self.iteration += 1
        t2 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": wk.reward_mean(self._reward_window),
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": rollout["rewards"].size,
            "time_this_iter_s": t2 - t0,
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
            **metrics,
        }

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        """Greedy action for one observation (reference:
        Algorithm.compute_single_action)."""
        logits = logits_forward(self.params, torch.as_tensor(
            np.asarray(obs, np.float32)[None], device=self.device))
        return int(torch.argmax(logits[0]))

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy-policy evaluation on a fresh env."""
        maker = self.config.env_maker or (
            lambda seed: CartPoleEnv(max_steps=self.config.env_max_steps,
                                     seed=seed))
        returns = []
        for ep in range(num_episodes):
            env = maker(10_000 + ep)
            obs, total, done = env.reset(), 0.0, False
            while not done:
                obs, r, done, _ = env.step(self.compute_action(obs))
                total += r
            returns.append(total)
        return {"evaluation_reward_mean": float(np.mean(returns))}

    def stop(self) -> None:
        wk.kill_all(self.workers)

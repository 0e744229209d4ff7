"""DQN: double-DQN targets, Huber loss, replay buffers, n-step folding,
the epsilon-greedy workers and the algorithm.

Port of `ray_tpu/rllib/dqn.py`.  The replay buffers and `nstep_transform`
are numpy, copied from the JAX package (the port imports nothing of it).
`make_update_fn` returns `(update, td_fn)`: the update runs
`num_grad_steps` minibatch steps over a sampled slab, with the minibatch
indices drawn first ([num_grad_steps, batch_size] from the learner's
generator, or given as `draws`); `td_fn` is the TD error that feeds
prioritized replay.  The target network is passed in and never updated
here: the caller refreshes it by copy (`optim.tree_copy`), never by
alias, since the update changes the online parameters in place.

`DQNWorker` actors collect epsilon-greedy transitions on the CPU, their
random actions and coin flips drawn first; `DQN.train()` folds them
(n-step when asked) into the replay buffer and, past `learning_starts`,
runs one update on the learner's device.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import workers as wk
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, make_generator,
                                       randint, resolve_draws,
                                       seeded_params, tree_copy,
                                       value_and_grad)
from ray_tpu_torch.rllib.ppo import init_policy, logits_forward, take


def q_forward(params, obs):
    """The `pi` head doubles as Q-values."""
    return logits_forward(params, obs)


class ReplayBuffer:
    """Uniform ring buffer (reference:
    utils/replay_buffers/replay_buffer.py)."""

    def __init__(self, capacity: int, obs_size: int) -> None:
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.bool_)
        # Per-transition bootstrap discount (gamma for 1-step inserts,
        # gamma^k for n-step folds; 0 until written).
        self.discounts = np.zeros(capacity, np.float32)
        self.size = 0
        self._pos = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones,
                  discounts=None) -> np.ndarray:
        """Vectorized ring insert: at most two slice assignments per
        array (split at the wrap point).  Returns the written slot
        indices (subclasses key their side arrays off them)."""
        n = len(actions)
        if discounts is None:
            discounts = np.zeros(n, np.float32)
        if n > self.capacity:      # keep only the newest fit
            obs, actions = obs[-self.capacity:], actions[-self.capacity:]
            rewards, dones = (rewards[-self.capacity:],
                              dones[-self.capacity:])
            next_obs = next_obs[-self.capacity:]
            discounts = discounts[-self.capacity:]
            n = self.capacity
        first = min(n, self.capacity - self._pos)
        for dst, src in ((self.obs, obs), (self.actions, actions),
                         (self.rewards, rewards),
                         (self.next_obs, next_obs), (self.dones, dones),
                         (self.discounts, discounts)):
            dst[self._pos:self._pos + first] = src[:first]
            if n > first:
                dst[:n - first] = src[first:]
        ix = (self._pos + np.arange(n)) % self.capacity
        self._pos = (self._pos + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        return ix

    def sample(self, rng: np.random.RandomState, n: int) -> Dict:
        ix = rng.randint(0, self.size, size=n)
        return {"obs": self.obs[ix], "actions": self.actions[ix],
                "rewards": self.rewards[ix],
                "next_obs": self.next_obs[ix],
                "dones": self.dones[ix].astype(np.float32),
                "discounts": self.discounts[ix]}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    utils/replay_buffers/prioritized_replay_buffer.py — Schaul et al.):
    transitions sample with probability p_i^alpha / sum p^alpha, the
    induced bias is corrected with importance weights (N*P)^-beta
    normalized by their max, and |TD error| feeds back as the new
    priority.  New transitions get the current max priority so every
    transition is seen at least once."""

    def __init__(self, capacity: int, obs_size: int,
                 alpha: float = 0.6, beta: float = 0.4) -> None:
        super().__init__(capacity, obs_size)
        self.alpha = alpha
        self.beta = beta
        self.priorities = np.zeros(capacity, np.float64)
        self._max_priority = 1.0

    def add_batch(self, obs, actions, rewards, next_obs, dones,
                  discounts=None) -> np.ndarray:
        ix = super().add_batch(obs, actions, rewards, next_obs, dones,
                               discounts)
        self.priorities[ix] = self._max_priority
        return ix

    def sample(self, rng: np.random.RandomState, n: int) -> Dict:
        p = self.priorities[:self.size] ** self.alpha
        total = p.sum()
        if total <= 0:
            probs = np.full(self.size, 1.0 / self.size)
        else:
            probs = p / total
        ix = rng.choice(self.size, size=n, p=probs)
        w = (self.size * probs[ix]) ** (-self.beta)
        w /= w.max() if w.max() > 0 else 1.0
        return {"obs": self.obs[ix], "actions": self.actions[ix],
                "rewards": self.rewards[ix],
                "next_obs": self.next_obs[ix],
                "dones": self.dones[ix].astype(np.float32),
                "discounts": self.discounts[ix],
                "weights": w.astype(np.float32),
                "indices": ix}

    def update_priorities(self, ix: np.ndarray,
                          td_errors: np.ndarray) -> None:
        pr = np.abs(td_errors) + 1e-6
        self.priorities[ix] = pr
        self._max_priority = max(self._max_priority, float(pr.max()))


def nstep_transform(sample: Dict[str, np.ndarray], T: int, N: int,
                    n_step: int, gamma: float) -> Dict[str, np.ndarray]:
    """Fold a step-major [T*N] rollout into n-step transitions
    (reference: n_step option on DQN — utils/replay_buffers accum):
    R_t = sum_k gamma^k r_{t+k} up to n steps or episode end; the
    bootstrap observation is the last one consumed and the per-sample
    bootstrap discount is gamma^(steps consumed).  Windows truncate at
    the rollout boundary."""
    obs = sample["obs"].reshape(T, N, -1)
    nobs = sample["next_obs"].reshape(T, N, -1)
    rew = sample["rewards"].reshape(T, N)
    done = sample["dones"].reshape(T, N)
    act = sample["actions"].reshape(T, N)
    R = np.zeros((T, N), np.float32)
    disc = np.ones((T, N), np.float32)
    nxt = np.empty_like(nobs)
    dn = np.zeros((T, N), bool)
    for t in range(T):
        acc = np.zeros(N, np.float32)
        g = np.ones(N, np.float32)
        alive = np.ones(N, bool)
        last_next = nobs[t].copy()
        terminal = np.zeros(N, bool)
        for k in range(n_step):
            if t + k >= T:
                break
            acc += g * rew[t + k] * alive
            last_next[alive] = nobs[t + k][alive]
            terminal |= (done[t + k] & alive)
            g = np.where(alive, g * gamma, g)
            alive &= ~done[t + k]
        R[t], nxt[t], dn[t], disc[t] = acc, last_next, terminal, g
    return {"obs": obs.reshape(T * N, -1),
            "actions": act.reshape(-1),
            "rewards": R.reshape(-1),
            "next_obs": nxt.reshape(T * N, -1),
            "dones": dn.reshape(-1),
            "discounts": disc.reshape(-1)}


def huber(x):
    """optax.huber_loss(x, 0) with delta 1."""
    a = torch.abs(x)
    quadratic = torch.clamp(a, max=1.0)
    return 0.5 * quadratic ** 2 + (a - quadratic)


def make_update_fn(optimizer: Adam, gamma: float, num_grad_steps: int,
                   batch_size: int, device: DeviceLike = None
                   ) -> Tuple[Callable, Callable]:
    """(update, td_fn).

    update(params, target_params, opt_state, data, rng=None, draws=None)
    -> (params, opt_state, mean loss); `data` is a slab of obs, actions,
    rewards, next_obs, dones, discounts (and `weights` from prioritized
    replay), `draws` {"ix": [num_grad_steps, batch_size]}
    (`update.draw(rng, data)` draws them).
    td_fn(params, target_params, batch) -> the TD error per row.
    `gamma` is carried for JAX's signature: the per-row `discounts` hold
    it (gamma, or gamma^k for n-step folds)."""
    dev = resolve_device(device)

    def td_error(params, target_params, batch):
        q_sa = take(q_forward(params, batch["obs"]), batch["actions"])
        with torch.no_grad():
            # Double DQN: the online net picks a', the target net
            # values it.
            a_prime = torch.argmax(q_forward(params, batch["next_obs"]),
                                   dim=1)
            q_next = take(q_forward(target_params, batch["next_obs"]),
                          a_prime)
        target = batch["rewards"] \
            + batch["discounts"] * (1.0 - batch["dones"]) * q_next
        return q_sa - target

    def loss_fn(params, target_params, batch):
        per = huber(td_error(params, target_params, batch))
        w = batch.get("weights")
        if w is not None:
            per = per * w        # prioritized-replay IS correction
        return per.mean()

    def draw(rng, data):
        return {"ix": randint(rng, data["obs"].shape[0],
                              (num_grad_steps, batch_size))}

    def update(params, target_params, opt_state, data, rng=None,
               draws: Optional[Dict[str, Any]] = None):
        d = as_tensors(data, dev, ints=("actions",))
        ix = resolve_draws(draws, rng, lambda g: draw(g, d), dev)["ix"]
        losses = []
        for s in range(num_grad_steps):
            batch = {k: v[ix[s]] for k, v in d.items()}
            loss, grads = value_and_grad(loss_fn, params, target_params,
                                         batch)
            opt_state = optimizer.step_(params, grads, opt_state)
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    @torch.no_grad()
    def td_fn(params, target_params, batch):
        return td_error(params, target_params,
                        as_tensors(batch, dev, ints=("actions",)))

    update.draw = draw
    return update, td_fn


@ray_tpu_torch.remote
class DQNWorker:
    """Epsilon-greedy transition collector (reference: EnvRunner
    sampling for off-policy algos)."""

    def __init__(self, worker_index: int, num_envs: int,
                 rollout_len: int, env_maker=None,
                 max_steps: int = 200) -> None:
        torch.set_num_threads(1)
        maker = env_maker or (
            lambda seed: CartPoleEnv(max_steps=max_steps, seed=seed))
        self.vec = VectorEnv(maker, num_envs,
                             seed=7000 * (worker_index + 1))
        self.rollout_len = rollout_len
        self.obs = self.vec.reset()
        self.rng = wk.worker_generator(worker_index + 1)

    @torch.no_grad()
    def sample(self, params, epsilon: float,
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One rollout; `draws` {"random": [T, N] actions, "uniform":
        [T, N] in [0, 1)} replaces the worker's own: an env explores
        where its uniform is below epsilon."""
        p = wk.cpu_tree(params)
        T, N = self.rollout_len, self.vec.num_envs
        A = p["pi"]["b"].shape[0]
        if draws is None:
            random = torch.randint(0, A, (T, N), generator=self.rng)
            uniform = torch.rand((T, N), generator=self.rng,
                                 dtype=torch.float64)
        else:
            random = wk.as_cpu(draws["random"], torch.int64)
            uniform = wk.as_cpu(draws["uniform"], torch.float64)
        explore = (uniform < epsilon).numpy()
        random = random.numpy()
        obs_b, act_b, rew_b, nobs_b, done_b = [], [], [], [], []
        for t in range(T):
            greedy = torch.argmax(q_forward(p, wk.obs_tensor(self.obs)),
                                  dim=1).numpy()
            action = np.where(explore[t], random[t], greedy)
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


class DQNConfig:
    def __init__(self) -> None:
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_len = 64
        self.env_maker: Optional[Callable] = None
        self.env_max_steps = 200
        self.lr = 1e-3
        self.gamma = 0.99
        self.buffer_capacity = 50_000
        self.learning_starts = 500
        self.prioritized_replay = False
        self.pr_alpha = 0.6
        self.pr_beta = 0.4
        self.n_step = 1
        self.batch_size = 64
        self.num_grad_steps = 32
        self.target_update_interval = 4
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 15
        self.hidden = 64
        self.seed = 0

    def rollouts(self, **kw) -> "DQNConfig":
        for k, v in kw.items():
            if k == "max_steps":          # PPOConfig.environment parity
                k = "env_max_steps"
            if not hasattr(self, k):
                raise ValueError(f"unknown DQN config option {k!r}")
            setattr(self, k, v)
        return self

    training = rollouts
    environment = rollouts

    def build(self, device: DeviceLike = None) -> "DQN":
        return DQN(self, device=device)


class DQN(RLCheckpointMixin):
    _ckpt_attrs = ("params", "target_params", "opt_state", "iteration")

    def __init__(self, config: DQNConfig, device: DeviceLike = None
                 ) -> None:
        c = self.config = config
        self.device = resolve_device(device)
        self._rng = make_generator(c.seed, self.device)
        self.params = seeded_params(c.seed, self.device, lambda g: (
            init_policy(g, CartPoleEnv.observation_size,
                        CartPoleEnv.num_actions, hidden=c.hidden)))
        # Its own storage: the update changes params in place.
        self.target_params = tree_copy(self.params)
        self.optimizer = Adam(c.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update, self._td_fn = make_update_fn(
            self.optimizer, c.gamma, c.num_grad_steps, c.batch_size,
            device=self.device)
        if c.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                c.buffer_capacity, CartPoleEnv.observation_size,
                alpha=c.pr_alpha, beta=c.pr_beta)
        else:
            self.buffer = ReplayBuffer(c.buffer_capacity,
                                       CartPoleEnv.observation_size)
        self.workers = wk.spawn(DQNWorker, c.num_rollout_workers,
                                lambda i: (i, c.num_envs_per_worker,
                                           c.rollout_len, c.env_maker,
                                           c.env_max_steps))
        self._np_rng = np.random.RandomState(c.seed)
        self.iteration = 0
        self._reward_window: List[float] = []

    def _epsilon(self) -> float:
        c = self.config
        frac = min(self.iteration / max(c.epsilon_decay_iters, 1), 1.0)
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def _add(self, s: Dict[str, Any]) -> None:
        c = self.config
        if c.n_step > 1:
            t = nstep_transform(s, c.rollout_len, c.num_envs_per_worker,
                                c.n_step, c.gamma)
        else:
            t = dict(s)
            t["discounts"] = np.full(len(s["actions"]), c.gamma,
                                     np.float32)
        self.buffer.add_batch(t["obs"], t["actions"], t["rewards"],
                              t["next_obs"], t["dones"],
                              discounts=t["discounts"])

    def train(self, draws: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """One iteration; `draws` {"workers": [...], "update": {"ix":
        ...}} replaces every random draw but the buffer's numpy one."""
        c = self.config
        t0 = time.time()
        eps = self._epsilon()
        params_ref = ray_tpu_torch.put(wk.host_tree(self.params))
        samples = wk.gather([w.sample.remote(params_ref, eps,
                                             wk.worker_draws(draws, i))
                             for i, w in enumerate(self.workers)])
        t1 = time.time()
        episode_returns = []
        for s in samples:
            self._add(s)
            episode_returns.extend(s["episode_returns"])
        self._reward_window.extend(episode_returns)
        self._reward_window = self._reward_window[-100:]

        loss = float("nan")
        if self.buffer.size >= c.learning_starts:
            # A fixed-shape slab of num_grad_steps minibatches, sampled
            # with replacement (as JAX, whose scan would recompile on a
            # changing shape).
            slab = self.buffer.sample(self._np_rng,
                                      c.batch_size * c.num_grad_steps)
            slab_ix = slab.pop("indices", None)
            data = as_tensors(slab, self.device, ints=("actions",))
            self.params, self.opt_state, loss_t = self._update(
                self.params, self.target_params, self.opt_state, data,
                self._rng, draws=None if draws is None else draws["update"])
            loss = float(loss_t)
            if slab_ix is not None:
                # Post-update TD errors become the slab's priorities.
                td = self._td_fn(self.params, self.target_params, data)
                self.buffer.update_priorities(slab_ix, td.cpu().numpy())
        self.iteration += 1
        if self.iteration % c.target_update_interval == 0:
            self.target_params = tree_copy(self.params)
        t2 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": wk.reward_mean(self._reward_window),
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": sum(len(s["actions"]) for s in samples),
            "buffer_size": self.buffer.size,
            "epsilon": eps,
            "loss": loss,
            "time_this_iter_s": t2 - t0,
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def stop(self) -> None:
        wk.kill_all(self.workers)

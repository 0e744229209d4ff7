"""DQN's learner: double-DQN targets, Huber loss, replay buffers and
n-step folding.

Port of `ray_tpu/rllib/dqn.py`.  The replay buffers and `nstep_transform`
are numpy, copied from the JAX package (the port imports nothing of it).
`make_update_fn` returns `(update, td_fn)`: the update runs
`num_grad_steps` minibatch steps over a sampled slab, with the minibatch
indices drawn first ([num_grad_steps, batch_size] from the learner's
generator, or given as `draws`); `td_fn` is the TD error that feeds
prioritized replay.  The target network is passed in and never updated
here: the caller refreshes it by copy (`optim.tree_copy`), never by
alias, since the update changes the online parameters in place.  The
epsilon-greedy workers and the `DQN` algorithm need the actor runtime
(ROADMAP A8b).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, randint,
                                       resolve_draws, value_and_grad)
from ray_tpu_torch.rllib.ppo import logits_forward, take


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

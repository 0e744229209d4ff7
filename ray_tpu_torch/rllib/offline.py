"""Offline RL: trajectory logging, behavior cloning and MARWIL from
logged transitions.

Port of `ray_tpu/rllib/offline.py`.  `collect_expert_episodes` and
`compute_returns` are numpy, copied from the JAX package.  BC and MARWIL
minimize a (weighted) negative log-likelihood with minibatch steps whose
indices are drawn first ([num_grad_steps, batch_size], from the learner's
generator or given as `draws`).  The interchange format is the JAX
package's: columnar parquet through `ray_tpu_torch.data`, one row per
transition with columns obs (list<float>), action (int or list<float>),
reward, done — `log_transitions` writes it, `MARWIL(input_path=)` reads
it whole and `BC` streams it in read-batches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.cql import read_transitions
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, make_generator,
                                       randint, resolve_draws,
                                       value_and_grad)
from ray_tpu_torch.rllib.ppo import init_policy, policy_forward, take


def log_transitions(path: str, obs: np.ndarray, actions: np.ndarray,
                    rewards: np.ndarray, dones: np.ndarray,
                    block_rows: int = 4096) -> List[str]:
    """Write transition columns as a parquet dataset (the
    DatasetWriter role, rllib/offline/dataset_writer.py)."""
    from ray_tpu_torch import data as rdata
    ds = rdata.from_numpy({
        "obs": np.asarray(obs, np.float32),
        "action": np.asarray(actions),
        "reward": np.asarray(rewards, np.float32),
        "done": np.asarray(dones).astype(np.float32),
    }, block_rows=block_rows)
    return ds.write_parquet(path)


def collect_expert_episodes(policy_fn: Callable[[np.ndarray], Any],
                            env_maker: Callable[[int], Any],
                            num_episodes: int, seed: int = 0
                            ) -> Dict[str, np.ndarray]:
    """Roll a scripted/learned policy and return transition columns
    (host-side helper for building offline datasets in tests/demos)."""
    obs_b, act_b, rew_b, done_b = [], [], [], []
    for ep in range(num_episodes):
        env = env_maker(seed + ep)
        o = env.reset()
        done = False
        while not done:
            a = policy_fn(o)
            obs_b.append(o)
            act_b.append(a)
            o, r, done, _ = env.step(a)
            rew_b.append(r)
            done_b.append(done)
    return {"obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b),
            "rewards": np.asarray(rew_b, np.float32),
            "dones": np.asarray(done_b, np.bool_)}


def compute_returns(rewards: np.ndarray, dones: np.ndarray,
                    gamma: float) -> np.ndarray:
    """Per-transition discounted return-to-go within each episode
    (host-side; logged data is episode-ordered)."""
    out = np.zeros_like(rewards, np.float32)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out


def _nll(params, batch):
    logits, v = policy_forward(params, batch["obs"])
    return -take(F.log_softmax(logits, -1), batch["action"]), v


def _make_minibatch_update(loss_fn: Callable, optimizer: Adam,
                           batch_size: int, num_grad_steps: int,
                           device: DeviceLike) -> Callable:
    """update(params, opt_state, data, rng=None, draws=None) ->
    (params, opt_state, per-output means over the steps); `draws` {"ix":
    [num_grad_steps, batch_size]} (`update.draw(rng, data)` draws
    them)."""
    dev = resolve_device(device)

    def draw(rng, data):
        return {"ix": randint(rng, data["obs"].shape[0],
                              (num_grad_steps, batch_size))}

    def update(params, opt_state, data, rng=None,
               draws: Optional[Dict[str, Any]] = None):
        d = as_tensors(data, dev, ints=("action",))
        ix = resolve_draws(draws, rng, lambda g: draw(g, d), dev)["ix"]
        outs = []
        for s in range(num_grad_steps):
            batch = {k: v[ix[s]] for k, v in d.items()}
            (loss, aux), grads = value_and_grad(loss_fn, params, batch,
                                                has_aux=True)
            opt_state = optimizer.step_(params, grads, opt_state)
            outs.append(torch.stack((loss,) + aux))
        return (params, opt_state, *torch.stack(outs).mean(0).unbind())

    update.draw = draw
    return update


def make_bc_update_fn(optimizer: Adam, batch_size: int,
                      num_grad_steps: int, device: DeviceLike = None
                      ) -> Callable:
    """update(params, opt_state, data, rng=None, draws=None) ->
    (params, opt_state, mean loss) over data {obs, action}."""

    def loss_fn(params, batch):
        return _nll(params, batch)[0].mean(), ()

    return _make_minibatch_update(loss_fn, optimizer, batch_size,
                                  num_grad_steps, device)


def make_marwil_update_fn(optimizer: Adam, batch_size: int,
                          num_grad_steps: int, beta: float,
                          vf_coef: float, device: DeviceLike = None
                          ) -> Callable:
    """MARWIL: exponentially advantage-weighted log-likelihood + value
    regression toward the empirical returns (beta 0 is BC).
    update(params, opt_state, data, rng=None, draws=None) -> (params,
    opt_state, mean loss, mean actor loss, mean critic loss) over data
    {obs, action, returns}."""

    def loss_fn(params, batch):
        nll, v = _nll(params, batch)
        adv = batch["returns"] - v
        # Batch-normalized advantages inside the exp keep the weights
        # scale-free; the exponent is clipped for stability.
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-6)
        w = torch.exp(torch.clamp(beta * adv_n.detach(), -5.0, 5.0))
        actor = (w * nll).mean()
        critic = (adv ** 2).mean()
        return actor + vf_coef * critic, (actor, critic)

    return _make_minibatch_update(loss_fn, optimizer, batch_size,
                                  num_grad_steps, device)


class MARWILConfig:
    def __init__(self) -> None:
        self.input_path: Optional[str] = None
        self.data: Optional[Dict[str, np.ndarray]] = None
        self.obs_size = CartPoleEnv.observation_size
        self.num_actions = CartPoleEnv.num_actions
        self.lr = 1e-3
        self.gamma = 0.99
        self.beta = 1.0            # 0.0 => plain BC
        self.vf_coef = 1.0
        self.batch_size = 256
        self.num_grad_steps = 256
        self.hidden = 64
        self.seed = 0

    def offline_data(self, **kw) -> "MARWILConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown MARWIL option {k!r}")
            setattr(self, k, v)
        return self

    training = offline_data
    environment = offline_data

    def build(self, device: DeviceLike = None) -> "MARWIL":
        return MARWIL(self, device=device)


class MARWIL(RLCheckpointMixin):
    """Monotonic advantage re-weighted imitation learning from logged
    transitions (columns obs, action, reward, done): imitates good
    actions more than bad ones, so it beats BC on mixed-quality data."""

    _ckpt_attrs = ("params", "opt_state", "iteration")

    def __init__(self, config: MARWILConfig, device: DeviceLike = None
                 ) -> None:
        self.config = config
        self.device = resolve_device(device)
        data = config.data
        if data is None:
            if not config.input_path:
                raise ValueError("MARWILConfig needs input_path or data")
            data = read_transitions(config.input_path, {
                "obs": "obs", "action": "action", "reward": "reward",
                "done": "done"})
        returns = compute_returns(
            np.asarray(data["reward"], np.float32),
            np.asarray(data["done"]).astype(bool), config.gamma)
        self.data = as_tensors(
            {"obs": np.asarray(data["obs"], np.float32),
             "action": data["action"], "returns": returns},
            self.device, ints=("action",))
        self._rng = make_generator(config.seed, self.device)
        self.params = init_policy(self._rng, config.obs_size,
                                  config.num_actions, hidden=config.hidden)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = make_marwil_update_fn(
            self.optimizer, config.batch_size, config.num_grad_steps,
            config.beta, config.vf_coef, device=self.device)
        self.iteration = 0

    def train(self, draws: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """num_grad_steps minibatch steps; `draws` ({"ix": [num_grad_steps,
        batch_size]}) replaces the learner's own draws."""
        t0 = time.time()
        (self.params, self.opt_state, loss, actor,
         critic) = self._update(self.params, self.opt_state, self.data,
                                self._rng, draws=draws)
        self.iteration += 1
        loss, actor, critic = torch.stack([loss, actor, critic]).tolist()
        return {"training_iteration": self.iteration, "loss": loss,
                "actor_loss": actor, "critic_loss": critic,
                "time_this_iter_s": round(time.time() - t0, 2)}

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        logits, _ = policy_forward(self.params, torch.as_tensor(
            np.asarray(obs, np.float32), device=self.device))
        return int(torch.argmax(logits))

    def evaluate(self, env_maker: Optional[Callable] = None,
                 num_episodes: int = 5, seed: int = 100) -> float:
        maker = env_maker or (lambda s: CartPoleEnv(seed=s))
        total = 0.0
        for ep in range(num_episodes):
            env = maker(seed + ep)
            o, done = env.reset(), False
            while not done:
                o, r, done, _ = env.step(self.compute_action(o))
                total += r
        return total / num_episodes


class BCConfig:
    def __init__(self) -> None:
        self.input_path: Optional[str] = None
        self.obs_size = CartPoleEnv.observation_size
        self.num_actions = CartPoleEnv.num_actions
        self.lr = 1e-3
        self.batch_size = 128
        self.num_grad_steps = 64
        self.read_batch_size = 4096
        self.hidden = 64
        self.seed = 0

    def offline_data(self, **kw) -> "BCConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown BC config option {k!r}")
            setattr(self, k, v)
        return self

    training = offline_data
    environment = offline_data

    def build(self, device: DeviceLike = None) -> "BC":
        return BC(self, device=device)


class BC(RLCheckpointMixin):
    """Behavior cloning from logged parquet transitions (reference:
    rllib/algorithms/bc/bc.py trained purely from offline data via
    the Data-backed reader, rllib/offline/dataset_reader.py)."""

    _ckpt_attrs = ("params", "opt_state", "iteration")

    def __init__(self, config: BCConfig, device: DeviceLike = None
                 ) -> None:
        if not config.input_path:
            raise ValueError("BCConfig.input_path is required "
                             "(offline_data(input_path=...))")
        self.config = config
        self.device = resolve_device(device)
        from ray_tpu_torch import data as rdata
        self._dataset = rdata.read_parquet(config.input_path)
        self._rng = make_generator(config.seed, self.device)
        self.params = init_policy(self._rng, config.obs_size,
                                  config.num_actions, hidden=config.hidden)
        self.optimizer = Adam(config.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = make_bc_update_fn(
            self.optimizer, config.batch_size, config.num_grad_steps,
            device=self.device)
        self.iteration = 0

    def train(self, draws: Optional[Sequence[Dict[str, Any]]] = None
              ) -> Dict[str, Any]:
        """One pass over the offline dataset, streamed in read-batches;
        each read-batch gets num_grad_steps minibatch steps.  `draws`,
        one {"ix": [num_grad_steps, batch_size]} a read-batch, replaces
        the learner's own draws."""
        t0 = time.time()
        losses = []
        rows = 0
        for i, batch in enumerate(self._dataset.iter_batches(
                batch_size=self.config.read_batch_size)):
            data = {"obs": np.asarray(batch["obs"], np.float32),
                    "action": batch["action"]}
            rows += int(data["obs"].shape[0])
            self.params, self.opt_state, loss = self._update(
                self.params, self.opt_state, data, self._rng,
                draws=None if draws is None else draws[i])
            losses.append(loss)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "loss": (torch.stack(losses).mean().item()
                         if losses else float("nan")),
                "rows_this_iter": rows,
                "time_this_iter_s": time.time() - t0}

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> int:
        logits, _ = policy_forward(self.params, torch.as_tensor(
            np.asarray(obs, np.float32), device=self.device))
        return int(torch.argmax(logits))

    def evaluate(self, env_maker: Optional[Callable] = None,
                 num_episodes: int = 5, seed: int = 100) -> float:
        """Greedy-policy rollouts in a live env; returns mean return."""
        maker = env_maker or (lambda s: CartPoleEnv(seed=s))
        total = 0.0
        for ep in range(num_episodes):
            env = maker(seed + ep)
            o, done = env.reset(), False
            while not done:
                o, r, done, _ = env.step(self.compute_action(o))
                total += r
        return total / num_episodes

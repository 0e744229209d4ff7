"""Multi-agent RL: dict-keyed envs, one PPO learner per policy, the
dict-keyed rollout workers and the algorithm.

Port of `ray_tpu/rllib/multi_agent.py`.  The envs are numpy, copied from
the JAX package.  Each policy's rollout is a rectangular [T, lanes] batch
(lanes = its agents x envs), so every policy update is PPO's
(`ppo.make_update_fn`); `MultiAgentLearner` holds the policies, their
optimizer states and updates.  `MultiAgentWorker` actors sample every
policy's lanes on the CPU; `MultiAgentPPO.train()` concatenates each
policy's lanes over the workers and updates each policy on the learner's
device.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import workers as wk
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.optim import Adam, make_generator, seeded_params
from ray_tpu_torch.rllib.ppo import (init_policy, make_update_fn,
                                    policy_forward)


class MultiAgentEnv:
    """Dict-keyed multi-agent env (reference:
    env/multi_agent_env.py).  Subclasses define `agent_ids` and the
    dict-valued reset/step."""

    agent_ids: List[str] = []

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        """-> (obs_dict, reward_dict, done_dict, info).  Agents
        auto-reset individually; done=True marks the step that closed
        that agent's episode."""
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent CartPoles sharing one env step (the reference's
    canonical multi-agent test env, env/tests/test_multi_agent_env.py
    MultiAgentCartPole).  Each agent auto-resets on its own fall."""

    def __init__(self, num_agents: int = 2, max_steps: int = 200,
                 seed: Optional[int] = None) -> None:
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {
            aid: CartPoleEnv(max_steps=max_steps,
                             seed=None if seed is None else seed + i)
            for i, aid in enumerate(self.agent_ids)}
        self.episode_returns: Dict[str, float] = {}
        self.completed: List[float] = []

    def reset(self) -> Dict[str, np.ndarray]:
        self.episode_returns = {aid: 0.0 for aid in self.agent_ids}
        return {aid: e.reset() for aid, e in self._envs.items()}

    def step(self, action_dict: Dict[str, Any]):
        obs, rews, dones = {}, {}, {}
        for aid, env in self._envs.items():
            o, r, d, _ = env.step(int(action_dict[aid]))
            self.episode_returns[aid] += r
            if d:
                self.completed.append(self.episode_returns[aid])
                self.episode_returns[aid] = 0.0
                o = env.reset()
            obs[aid], rews[aid], dones[aid] = o, r, d
        return obs, rews, dones, {}

    def drain_episode_returns(self) -> List[float]:
        out, self.completed = self.completed, []
        return out


@ray_tpu_torch.remote
class MultiAgentWorker:
    """Rollout collector over dict-keyed envs: per POLICY, transitions
    stack into [T, lanes] arrays (lanes = that policy's agents x this
    worker's envs) — the shape ppo.make_update_fn consumes."""

    def __init__(self, worker_index: int, num_envs: int,
                 rollout_len: int, env_maker,
                 policy_mapping: Dict[str, str]) -> None:
        torch.set_num_threads(1)
        self.envs = [env_maker(4000 * (worker_index + 1) + i)
                     for i in range(num_envs)]
        self.rollout_len = rollout_len
        self.mapping = dict(policy_mapping)
        # Stable lane order: (env_index, agent_id) per policy.
        self.lanes: Dict[str, List[tuple]] = {}
        for e, env in enumerate(self.envs):
            for aid in env.agent_ids:
                if aid not in self.mapping:
                    raise ValueError(
                        f"env agent {aid!r} has no entry in "
                        f"policy_mapping {sorted(self.mapping)}")
                self.lanes.setdefault(self.mapping[aid], []).append(
                    (e, aid))
        # env index -> [(policy_id, lane_index, agent_id)]: the
        # reward/done scatter is one pass per env step.
        self._env_lanes: Dict[int, List[tuple]] = {}
        for pid, lanes in self.lanes.items():
            for li, (e, aid) in enumerate(lanes):
                self._env_lanes.setdefault(e, []).append((pid, li, aid))
        self.obs = [env.reset() for env in self.envs]
        self.rng = wk.worker_generator(worker_index)

    def _lane_obs(self, pid: str) -> np.ndarray:
        return np.stack([self.obs[e][aid] for e, aid in self.lanes[pid]])

    @torch.no_grad()
    def sample(self, policy_params: Dict[str, Any],
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One rollout of every policy's lanes; `draws` {"gumbel":
        {policy_id: [T, lanes, A]}} replaces the worker's own noise
        (drawn per step and policy, in lane order)."""
        T = self.rollout_len
        params = {pid: wk.cpu_tree(policy_params[pid])
                  for pid in self.lanes}
        if draws is None:
            steps = [{pid: wk.gumbel(self.rng, (
                len(lanes), params[pid]["pi"]["b"].shape[0]))
                for pid, lanes in self.lanes.items()} for _ in range(T)]
            noise = {pid: torch.stack([s[pid] for s in steps])
                     for pid in self.lanes}
        else:
            noise = {pid: wk.as_cpu(g, torch.float32)
                     for pid, g in draws["gumbel"].items()}
        out: Dict[str, dict] = {}
        for pid, lanes in self.lanes.items():
            L = len(lanes)
            obs_size = len(self.obs[lanes[0][0]][lanes[0][1]])
            out[pid] = {
                "obs": np.zeros((T, L, obs_size), np.float32),
                "actions": np.zeros((T, L), np.int32),
                "logp": np.zeros((T, L), np.float32),
                "values": np.zeros((T + 1, L), np.float32),
                "rewards": np.zeros((T, L), np.float32),
                "dones": np.zeros((T, L), np.bool_),
            }
        for t in range(T):
            actions_by_env: List[Dict[str, int]] = [
                {} for _ in self.envs]
            for pid, lanes in self.lanes.items():
                lane_obs = self._lane_obs(pid)
                logits, value = policy_forward(params[pid],
                                               wk.obs_tensor(lane_obs))
                action, logp = wk.categorical(logits, noise[pid][t])
                o = out[pid]
                o["obs"][t] = lane_obs
                o["actions"][t] = action.numpy()
                o["logp"][t] = logp.numpy()
                o["values"][t] = value.numpy()
                for (e, aid), a in zip(lanes, o["actions"][t]):
                    actions_by_env[e][aid] = int(a)
            for e, env in enumerate(self.envs):
                obs, rews, dones, _ = env.step(actions_by_env[e])
                self.obs[e] = obs
                for pid, li, aid in self._env_lanes.get(e, ()):
                    out[pid]["rewards"][t, li] = rews[aid]
                    out[pid]["dones"][t, li] = dones[aid]
        # Bootstrap values for the final observation.
        for pid in self.lanes:
            _, value = policy_forward(params[pid],
                                      wk.obs_tensor(self._lane_obs(pid)))
            out[pid]["values"][T] = value.numpy()
        returns = []
        for env in self.envs:
            returns.extend(env.drain_episode_returns())
        return {"per_policy": out, "episode_returns": returns}


class MultiAgentPPOConfig:
    """Builder config (reference: AlgorithmConfig.multi_agent(policies,
    policy_mapping_fn))."""

    def __init__(self) -> None:
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 2
        self.rollout_len = 128
        self.env_maker: Optional[Callable] = None
        self.policies: Dict[str, dict] = {}
        self.policy_mapping: Dict[str, str] = {}
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

    def rollouts(self, **kw) -> "MultiAgentPPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    training = rollouts
    environment = rollouts

    def multi_agent(self, *, policies: Dict[str, dict],
                    policy_mapping: Dict[str, str]
                    ) -> "MultiAgentPPOConfig":
        """policies: {policy_id: {"obs_size": int, "num_actions": int}};
        policy_mapping: {agent_id: policy_id}."""
        self.policies = dict(policies)
        self.policy_mapping = dict(policy_mapping)
        return self

    def validate(self) -> "MultiAgentPPOConfig":
        if not self.policies or not self.policy_mapping:
            raise ValueError("multi_agent(policies=..., "
                             "policy_mapping=...) is required")
        missing = set(self.policy_mapping.values()) - set(self.policies)
        if missing:
            raise ValueError(f"mapping targets unknown policies "
                             f"{sorted(missing)}")
        return self

    def build(self, device: DeviceLike = None) -> "MultiAgentPPO":
        return MultiAgentPPO(self.validate(), device=device)


class MultiAgentLearner:
    """Per policy (in sorted order): parameters from the learner's
    generator, an Adam state and PPO's update."""

    def __init__(self, config: MultiAgentPPOConfig,
                 device: DeviceLike = None) -> None:
        c = config.validate()
        self.config = c
        self.device = resolve_device(device)
        self._rng = make_generator(c.seed, self.device)
        self.optimizer = Adam(c.lr)
        self.params: Dict[str, Any] = seeded_params(
            c.seed, self.device, lambda g: {
                pid: init_policy(g, spec["obs_size"], spec["num_actions"],
                                 hidden=spec.get("hidden", c.hidden))
                for pid, spec in sorted(c.policies.items())})
        self.opt_states: Dict[str, Any] = {}
        self._updates: Dict[str, Callable] = {}
        for pid, spec in sorted(c.policies.items()):
            self.opt_states[pid] = self.optimizer.init(self.params[pid])
            self._updates[pid] = make_update_fn(
                self.optimizer, c.clip, c.vf_coef, c.ent_coef, c.gamma,
                c.lam, c.num_minibatches, c.num_epochs, device=self.device)

    def update(self, rollouts: Dict[str, Dict[str, Any]],
               draws: Optional[Dict[str, Dict[str, Any]]] = None
               ) -> Dict[str, Dict[str, float]]:
        """One PPO update per policy that has a rollout ({policy_id:
        rollout}, each [T, lanes]); `draws` optionally per policy.
        Returns {policy_id: metrics}, read from the card once after every
        update."""
        metrics = {}
        for pid in self.params:
            if pid not in rollouts:
                continue
            self.params[pid], self.opt_states[pid], metrics[pid] = \
                self._updates[pid](
                    self.params[pid], self.opt_states[pid], rollouts[pid],
                    self._rng, draws=None if draws is None else draws[pid])
        flat = [(pid, k, v) for pid, m in metrics.items()
                for k, v in m.items()]
        values = torch.stack([v for _, _, v in flat]).tolist() if flat \
            else []
        out: Dict[str, Dict[str, float]] = {pid: {} for pid in metrics}
        for (pid, k, _), v in zip(flat, values):
            out[pid][k] = v
        return out


class MultiAgentPPO(RLCheckpointMixin):
    """One PPO update per policy over its own [T, lanes] batch, on the
    learner's device; rollouts come from dict-keyed env workers."""

    _ckpt_attrs = ("params", "opt_states", "iteration")

    def __init__(self, config: MultiAgentPPOConfig,
                 device: DeviceLike = None) -> None:
        c = self.config = config
        self.learner = MultiAgentLearner(c, device=device)
        self.device = self.learner.device
        maker = c.env_maker or (
            lambda seed: MultiAgentCartPole(num_agents=2, seed=seed))
        self.workers = wk.spawn(MultiAgentWorker, c.num_rollout_workers,
                                lambda i: (i, c.num_envs_per_worker,
                                           c.rollout_len, maker,
                                           c.policy_mapping))
        self.iteration = 0
        self._reward_window: List[float] = []

    # The learner owns the trees; save/restore reach them through these.
    @property
    def params(self) -> Dict[str, Any]:
        return self.learner.params

    @params.setter
    def params(self, value: Dict[str, Any]) -> None:
        self.learner.params = value

    @property
    def opt_states(self) -> Dict[str, Any]:
        return self.learner.opt_states

    @opt_states.setter
    def opt_states(self, value: Dict[str, Any]) -> None:
        self.learner.opt_states = value

    def train(self, draws: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """One iteration; `draws` {"workers": [...], "update": {policy_id:
        {"perms": ...}}} replaces every random draw of it."""
        t0 = time.time()
        params_ref = ray_tpu_torch.put(wk.host_tree(self.params))
        samples = wk.gather([w.sample.remote(params_ref,
                                             wk.worker_draws(draws, i))
                             for i, w in enumerate(self.workers)])
        t1 = time.time()
        episode_returns = [r for s in samples
                           for r in s["episode_returns"]]
        self._reward_window.extend(episode_returns)
        self._reward_window = self._reward_window[-100:]
        rollouts = {}
        for pid in self.params:
            # Concatenate the workers' lanes for this policy.
            parts = [s["per_policy"][pid] for s in samples
                     if pid in s["per_policy"]]
            if parts:
                rollouts[pid] = {k: np.concatenate([p[k] for p in parts],
                                                   axis=1)
                                 for k in parts[0]}
        metrics = self.learner.update(
            rollouts, None if draws is None else draws["update"])
        self.iteration += 1
        t2 = time.time()
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": wk.reward_mean(self._reward_window),
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": sum(p["actions"].size for s in samples
                                       for p in s["per_policy"].values()),
            "per_policy": metrics,
            "time_this_iter_s": t2 - t0,
            "sample_time_s": t1 - t0,
            "learn_time_s": t2 - t1,
        }

    def stop(self) -> None:
        wk.kill_all(self.workers)

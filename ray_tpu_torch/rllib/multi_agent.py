"""Multi-agent RL: dict-keyed envs and one PPO learner per policy.

Port of `ray_tpu/rllib/multi_agent.py`.  The envs are numpy, copied from
the JAX package.  Each policy's rollout is a rectangular [T, lanes] batch
(lanes = its agents x envs), so every policy update is PPO's
(`ppo.make_update_fn`); `MultiAgentLearner` holds the policies, their
optimizer states and updates, which is the learner half of the JAX
package's `MultiAgentPPO`.  The dict-keyed rollout workers and the
`MultiAgentPPO` algorithm need the actor runtime (ROADMAP A8b):
`MultiAgentPPOConfig.build()` validates, then raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.optim import Adam, make_generator
from ray_tpu_torch.rllib.ppo import (WAITS_ON_RUNTIME, init_policy,
                                    make_update_fn)


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

    def build(self):
        self.validate()
        raise NotImplementedError(WAITS_ON_RUNTIME.format(
            "MultiAgentPPO", "MultiAgentLearner"))


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
        self.params: Dict[str, Any] = {}
        self.opt_states: Dict[str, Any] = {}
        self._updates: Dict[str, Callable] = {}
        for pid, spec in sorted(c.policies.items()):
            self.params[pid] = init_policy(
                self._rng, spec["obs_size"], spec["num_actions"],
                hidden=spec.get("hidden", c.hidden))
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

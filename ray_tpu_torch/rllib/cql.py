"""CQL: conservative Q-learning, offline RL for continuous actions.

Port of `ray_tpu/rllib/cql.py`: SAC's grad step (`sac.make_grad_step`)
with one more critic term that pushes Q down on out-of-distribution
actions and up on dataset actions,

    L_cons = E_s[ logsumexp_a Q(s, a) - E_{a~data} Q(s, a) ]

estimated from K uniform actions and K policy actions at s and at s'
(CQL(H)), each weighted by its log-density.  `CQL` trains on the
learner's device from a dataset given as `data=` (columns obs, actions,
rewards, next_obs, dones) or read from parquet with `input_path=`
(columns obs, action, reward, next_obs, done, through
`ray_tpu_torch.data.read_parquet`, as the JAX package reads it); it
never touches an environment.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.env import PendulumEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, make_generator,
                                       normal, randint, resolve_draws)
from ray_tpu_torch.rllib.sac import (actor_forward, init_sac, init_state,
                                     make_grad_step, min_q, q_value,
                                     sample_action)

def read_transitions(path: str, columns: Dict[str, str]
                     ) -> Dict[str, np.ndarray]:
    """Logged transitions from a parquet dataset (`input_path=`), read
    through the port's Data as the JAX package reads them: {name:
    column} for each `columns` item name -> parquet column, floats as
    f32 and `action` as stored (discrete actions stay integers)."""
    from ray_tpu_torch import data as rdata
    tbl = rdata.read_parquet(path).to_pandas()
    out = {}
    for name, col in columns.items():
        values = tbl[col].to_numpy()
        if values.dtype == object:          # list<float> rows
            values = np.stack(values)
        out[name] = (values if col == "action" and
                     values.dtype.kind in "iu"
                     else values.astype(np.float32))
    return out


def make_cql_update_fn(actor_opt: Adam, critic_opt: Adam, alpha_opt: Adam,
                       gamma: float, tau: float, target_entropy: float,
                       num_grad_steps: int, batch_size: int,
                       action_scale: float, min_q_weight: float,
                       num_cql_actions: int, device: DeviceLike = None
                       ) -> Callable:
    """update(state, data, rng=None, draws=None) -> (state, mean critic
    loss, mean actor loss, mean conservative gap); `state` as
    `sac.init_state` builds it, changed in place.  `draws`: "ix" [S, B];
    standard normals "noise_next" [S, B, A] (the target's next actions),
    "noise_cql_pi" and "noise_cql_next" [S, K, B, A] (policy proposals at
    s and s'), "noise_pi" [S, B, A] (the actor's actions); "unif" [S, K,
    B, A] uniform in [-action_scale, action_scale).  `update.draw(rng,
    data)` draws them."""
    dev = resolve_device(device)
    K = num_cql_actions

    def conservative_term(qs, actor, batch, unif, noise_pi, noise_next):
        obs = batch["obs"]
        B, A = batch["actions"].shape
        with torch.no_grad():
            logp_unif = torch.full((K, B), -A * math.log(2 * action_scale),
                                   device=obs.device)
            pi_a, pi_logp = sample_action(
                actor, obs.expand((K,) + obs.shape), noise_pi, action_scale)
            pi2_a, pi2_logp = sample_action(
                actor, batch["next_obs"].expand((K,) + obs.shape),
                noise_next, action_scale)
            # sample_action's density is of the unscaled tanh variable;
            # the |da/du| = action_scale Jacobian puts both sets of
            # weights in the scaled action space.
            jac = A * math.log(action_scale)
            cat_a = torch.cat([unif, pi_a, pi2_a], 0)
            cat_logp = torch.cat([logp_unif, pi_logp - jac,
                                  pi2_logp - jac], 0)
        obs_rep = obs.expand((cat_a.shape[0],) + obs.shape)
        out = 0.0
        for name in ("q1", "q2"):
            qvals = q_value(qs[name], obs_rep, cat_a)          # [3K, B]
            lse = torch.logsumexp(qvals - cat_logp, 0) \
                - math.log(cat_a.shape[0])
            data_q = q_value(qs[name], obs, batch["actions"])
            out = out + (lse - data_q).mean()
        return out

    def critic_loss(qs, actor, target_qs, log_alpha, batch, noise,
                    unif, noise_cql_pi, noise_cql_next):
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
        cons = conservative_term(qs, actor, batch, unif, noise_cql_pi,
                                 noise_cql_next)
        return l1 + l2 + min_q_weight * cons, cons

    grad_step = make_grad_step(critic_loss, actor_opt, critic_opt,
                               alpha_opt, tau, target_entropy,
                               action_scale)

    def draw(rng, data):
        (n, A), S, B = data["actions"].shape, num_grad_steps, batch_size
        unif = torch.rand((S, K, B, A), generator=rng, device=rng.device)
        return {"ix": randint(rng, n, (S, B)),
                "noise_next": normal(rng, (S, B, A)),
                "unif": unif * (2 * action_scale) - action_scale,
                "noise_cql_pi": normal(rng, (S, K, B, A)),
                "noise_cql_next": normal(rng, (S, K, B, A)),
                "noise_pi": normal(rng, (S, B, A))}

    def update(state, data, rng=None,
               draws: Optional[Dict[str, Any]] = None):
        d = as_tensors(data, dev)
        r = resolve_draws(draws, rng, lambda g: draw(g, d), dev)
        closses, alosses, conss = [], [], []
        for s in range(num_grad_steps):
            batch = {k: v[r["ix"][s]] for k, v in d.items()}
            state, closs, cons, aloss, _ = grad_step(
                state, batch, (r["noise_next"][s], r["unif"][s],
                               r["noise_cql_pi"][s], r["noise_cql_next"][s]),
                r["noise_pi"][s])
            closses.append(closs)
            alosses.append(aloss)
            conss.append(cons)
        return (state, torch.stack(closses).mean(),
                torch.stack(alosses).mean(), torch.stack(conss).mean())

    update.draw = draw
    return update


class CQLConfig:
    def __init__(self) -> None:
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.min_q_weight = 5.0
        self.num_cql_actions = 4
        self.num_grad_steps = 256
        self.batch_size = 256
        self.hidden = 128
        self.action_scale = 2.0
        self.seed = 0
        self.input_path: Optional[str] = None   # parquet dir
        self.data: Optional[Dict[str, np.ndarray]] = None

    def offline_data(self, **kw) -> "CQLConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown CQL config option {k!r}")
            setattr(self, k, v)
        return self

    training = offline_data

    def build(self, device: DeviceLike = None) -> "CQL":
        return CQL(self, device=device)


class CQL(RLCheckpointMixin):
    """Offline learner: logged transitions in, policy out — no env."""

    _ckpt_attrs = ("_state", "iteration")

    def __init__(self, config: CQLConfig, device: DeviceLike = None
                 ) -> None:
        self.config = config
        self.device = resolve_device(device)
        data = config.data
        if data is None:
            if not config.input_path:
                raise ValueError("CQLConfig needs input_path or data")
            data = read_transitions(config.input_path, {
                "obs": "obs", "actions": "action", "rewards": "reward",
                "next_obs": "next_obs", "dones": "done"})
        self.data = as_tensors(data, self.device)
        obs_size = int(self.data["obs"].shape[-1])
        act_size = int(self.data["actions"].shape[-1])
        self._rng = make_generator(config.seed, self.device)
        params = init_sac(self._rng, obs_size, act_size,
                          hidden=config.hidden)
        opts = [Adam(config.lr) for _ in range(3)]
        self._state = init_state(params, *opts)
        self.actor, self.qs = self._state[0], self._state[1]
        self._update = make_cql_update_fn(
            *opts, config.gamma, config.tau,
            target_entropy=-float(act_size),
            num_grad_steps=config.num_grad_steps,
            batch_size=config.batch_size,
            action_scale=config.action_scale,
            min_q_weight=config.min_q_weight,
            num_cql_actions=config.num_cql_actions, device=self.device)
        self.iteration = 0

    def _restored(self) -> None:
        # actor/qs are views of _state; re-derive them so compute_action
        # and mean_q work right after a restore.
        self.actor, self.qs = self._state[0], self._state[1]

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        self._state, closs, aloss, cons = self._update(
            self._state, self.data, self._rng)
        self.actor, self.qs = self._state[0], self._state[1]
        self.iteration += 1
        closs, aloss, cons, alpha = torch.stack(
            [closs, aloss, cons, torch.exp(self._state[3])]).tolist()
        return {"iteration": self.iteration, "critic_loss": closs,
                "actor_loss": aloss, "conservative_gap": cons,
                "alpha": alpha, "grad_steps": self.config.num_grad_steps,
                "wall_s": round(time.time() - t0, 2)}

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32),
                               device=self.device)

    @torch.no_grad()
    def compute_action(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic (tanh of the mean) action for eval."""
        mu, _ = actor_forward(self.actor, self._tensor(obs))
        return (torch.tanh(mu) * self.config.action_scale).cpu().numpy()

    @torch.no_grad()
    def mean_q(self, obs: np.ndarray, actions: np.ndarray) -> float:
        return float(min_q(self.qs, self._tensor(obs),
                           self._tensor(actions)).mean())

    def evaluate(self, env_maker: Optional[Callable] = None,
                 num_episodes: int = 3, seed: int = 77
                 ) -> Dict[str, float]:
        maker = env_maker or (lambda s: PendulumEnv(seed=s))
        rets = []
        for ep in range(num_episodes):
            env = maker(seed + ep)
            o, done, total = env.reset(), False, 0.0
            while not done:
                o, r, done, _ = env.step(self.compute_action(o))
                total += r
            rets.append(total)
        return {"evaluation_reward_mean": float(np.mean(rets))}

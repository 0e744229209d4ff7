"""IMPALA's learner: the conv policy for pixel observations and the
V-trace update.

Port of `ray_tpu/rllib/impala.py`.  The policies and the update are here;
the streaming rollout workers and `IMPALA.train_async` need the actor
runtime (ROADMAP A8b): `IMPALAConfig.build()` raises until it lands.

The conv policy keeps JAX's parameter tree (`c1`, `c2`, `fc`, `pi`,
`vf`) with conv kernels in torch's OIHW layout (`convert.py` transposes
JAX's HWIO).  Observations stay NHWC as the envs give them; the convs
run NCHW, with XLA's "SAME" padding for stride 2 written out (torch's
`padding="same"` refuses a stride), and the activations go back to NHWC
before the flatten so `fc`'s rows mean what they mean in JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.optim import Adam, as_tensors, value_and_grad
from ray_tpu_torch.rllib.ppo import WAITS_ON_RUNTIME, dense, take


def init_conv_policy(rng: torch.Generator, obs_shape, num_actions: int,
                     hidden: int = 128) -> Dict[str, Any]:
    """obs_shape: (H, W, C).  Two stride-2 4x4 convs + a dense torso."""
    H, W, C = obs_shape

    def conv(cin, cout, k):
        w = torch.randn((cout, cin, k, k), generator=rng,
                        device=rng.device)
        return {"w": w * math.sqrt(2.0 / (cin * k * k)),
                "b": torch.zeros((cout,), device=rng.device)}

    h2, w2 = (H + 1) // 2, (W + 1) // 2
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
    return {"c1": conv(C, 8, 4), "c2": conv(8, 16, 4),
            "fc": dense(rng, h4 * w4 * 16, hidden),
            "pi": dense(rng, hidden, num_actions),
            "vf": dense(rng, hidden, 1)}


def same_pads(n: int, k: int, stride: int = 2):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x):
    """x [B, C, H, W] -> relu(conv_SAME_stride2(x) + b)."""
    k = p["w"].shape[-1]
    top, bottom = same_pads(x.shape[2], k)
    left, right = same_pads(x.shape[3], k)
    x = F.pad(x, (left, right, top, bottom))
    return F.relu(F.conv2d(x, p["w"], stride=2)
                  + p["b"][:, None, None])


def conv_policy_forward(params, obs):
    """obs [..., H, W, C] -> (logits [..., A], value [...])."""
    lead = obs.shape[:-3]
    x = obs.reshape((-1,) + tuple(obs.shape[-3:])).permute(0, 3, 1, 2)
    x = _conv(params["c2"], _conv(params["c1"], x))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.tanh(x @ params["fc"]["w"] + params["fc"]["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return (logits.reshape(tuple(lead) + logits.shape[-1:]),
            value.reshape(lead))


@torch.no_grad()
def vtrace_targets(rho_c, cs, rewards, not_done, values, gamma: float):
    """(vs, pg_adv), both without gradient: V-trace value targets by a
    reverse loop over T and the policy-gradient advantages.  `values`
    has T + 1 rows; the last bootstraps `vs_next`."""
    v = values[:-1]
    deltas = rho_c * (rewards + gamma * not_done * values[1:] - v)
    adv_v = torch.empty_like(deltas)
    acc = torch.zeros_like(deltas[0])
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * not_done[t] * cs[t] * acc
        adv_v[t] = acc
    vs = v + adv_v
    vs_next = torch.cat([vs[1:], values[-1][None]], 0)
    pg_adv = rho_c * (rewards + gamma * not_done * vs_next - v)
    return vs, pg_adv


def behaviour_terms(forward, params, batch):
    """The live network over obs and last_obs: (logits [T], values
    [T + 1], log pi(a), log-softmax) for a [T, N] batch."""
    obs = batch["obs"]
    T = obs.shape[0]
    logits, values = forward(params, torch.cat(
        [obs, batch["last_obs"][None]], 0))
    logits = logits[:T]
    logp_all = F.log_softmax(logits, -1)
    return logits, values, take(logp_all, batch["actions"]), logp_all


def entropy_of(logits, logp_all):
    return -(F.softmax(logits, -1) * logp_all).sum(-1).mean()


def make_vtrace_update(forward: Callable, optimizer: Adam, gamma: float,
                       rho_clip: float, c_clip: float, vf_coef: float,
                       ent_coef: float, device: DeviceLike = None
                       ) -> Callable:
    """update(params, opt_state, batch) -> (params, opt_state, metrics)
    for a batch of obs [T, N, ...], actions, logp, rewards, dones [T, N]
    and last_obs [N, ...].  Parameters and moments change in place."""
    dev = resolve_device(device)

    def loss_fn(params, batch):
        logits, values, tgt_logp, logp_all = behaviour_terms(
            forward, params, batch)
        rho = torch.exp(tgt_logp - batch["logp"])
        rho_c = torch.clamp(rho, max=rho_clip)
        cs = torch.clamp(rho, max=c_clip)
        not_done = 1.0 - batch["dones"]
        vs, pg_adv = vtrace_targets(rho_c, cs, batch["rewards"],
                                    not_done, values, gamma)
        pg_loss = -(tgt_logp * pg_adv).mean()
        vf_loss = 0.5 * ((values[:-1] - vs) ** 2).mean()
        entropy = entropy_of(logits, logp_all)
        total = pg_loss + vf_coef * vf_loss - ent_coef * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_rho": rho.mean()}

    def update(params, opt_state, batch):
        b = as_tensors(batch, dev, ints=("actions",))
        (loss, metrics), grads = value_and_grad(loss_fn, params, b,
                                                has_aux=True)
        opt_state = optimizer.step_(params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return update


@dataclass
class IMPALAConfig:
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 4
    rollout_len: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    broadcast_every: int = 1
    network: str = "mlp"             # "mlp" | "conv" (pixel obs)
    env_maker: Optional[Callable] = None
    env_max_steps: int = 200
    hidden: int = 64
    seed: int = 0

    def rollouts(self, **kw) -> "IMPALAConfig":
        for k, v in kw.items():
            setattr(self, k, v)
        return self

    training = rollouts
    environment = rollouts

    def build(self):
        raise NotImplementedError(WAITS_ON_RUNTIME.format(
            type(self).__name__[:-len("Config")],
            "make_vtrace_update / appo.make_appo_update"))

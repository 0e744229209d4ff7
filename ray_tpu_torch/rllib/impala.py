"""IMPALA: the conv policy for pixel observations, the V-trace update,
the streaming rollout workers and the asynchronous driver.

Port of `ray_tpu/rllib/impala.py`.  The conv policy keeps JAX's parameter
tree (`c1`, `c2`, `fc`, `pi`, `vf`) with conv kernels in torch's OIHW
layout (`convert.py` transposes JAX's HWIO).  Observations stay NHWC as
the envs give them; the convs run NCHW, with XLA's "SAME" padding for
stride 2 written out (torch's `padding="same"` refuses a stride), and the
activations go back to NHWC before the flatten so `fc`'s rows mean what
they mean in JAX.

`VTraceRolloutWorker` actors (max_concurrency=2) stream trajectory
batches from a generator method while `set_params` swaps in the weights
the learner broadcasts; `IMPALA.train_async` drains the streams through
threads into a bounded queue and applies one V-trace update per batch on
the learner's device, a stale policy by design.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib import workers as wk
from ray_tpu_torch.rllib.checkpoint import RLCheckpointMixin
from ray_tpu_torch.rllib.env import CartPoleEnv, PixelCartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, seeded_params,
                                       value_and_grad)
from ray_tpu_torch.rllib.ppo import (dense, init_policy, policy_forward,
                                     take)


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


class VTraceRolloutWorker:
    """Continuously produces rollout batches with the latest params it
    has SEEN — a stale policy by design; V-trace corrects the gap.
    Runs with max_concurrency=2 so set_params interleaves with the live
    stream_rollouts generator (streaming-generator actor method)."""

    def __init__(self, worker_index: int, num_envs: int,
                 rollout_len: int, params, network: str,
                 env_maker=None, max_steps: int = 200) -> None:
        torch.set_num_threads(1)
        self._network = network
        if network == "conv":
            maker = env_maker or (lambda s: PixelCartPoleEnv(
                max_steps=max_steps, seed=s))
            self._forward = conv_policy_forward
        else:
            maker = env_maker or (lambda s: CartPoleEnv(
                max_steps=max_steps, seed=s))
            self._forward = policy_forward
        self.vec = VectorEnv(maker, num_envs,
                             seed=1000 * (worker_index + 1))
        self.rollout_len = rollout_len
        self.obs = self.vec.reset()
        self.rng = wk.worker_generator(worker_index)
        self._params = wk.cpu_tree(params)
        self.batches_produced = 0

    def set_params(self, params) -> int:
        """Weight broadcast target (fire-and-forget from the learner)."""
        self._params = wk.cpu_tree(params)
        return self.batches_produced

    def stream_rollouts(self, num_batches: int):
        """Streaming generator: one trajectory batch per yield."""
        for _ in range(num_batches):
            yield self.sample()
            self.batches_produced += 1

    @torch.no_grad()
    def sample(self, draws: Optional[Dict[str, Any]] = None
               ) -> Dict[str, np.ndarray]:
        """One batch from the latest params; `draws` {"gumbel": [T, N,
        A]} replaces the worker's own noise."""
        params = self._params        # snapshot for the whole batch
        T, N = self.rollout_len, self.vec.num_envs
        A = params["pi"]["b"].shape[0]
        noise = (wk.gumbel(self.rng, (T, N, A)) if draws is None
                 else wk.as_cpu(draws["gumbel"], torch.float32))
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        for t in range(T):
            logits, _ = self._forward(params, wk.obs_tensor(self.obs))
            action, logp = wk.categorical(logits, noise[t])
            obs_buf[t] = self.obs
            act_buf[t] = action.numpy()
            logp_buf[t] = logp.numpy()
            self.obs, rew_buf[t], done_buf[t] = self.vec.step(act_buf[t])
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "rewards": rew_buf, "dones": done_buf,
                "last_obs": self.obs.astype(np.float32),
                "episode_returns": self.vec.drain_episode_returns()}


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

    def build(self, device: DeviceLike = None) -> "IMPALA":
        return IMPALA(self, device=device)


# Batches waiting between the drain threads and the learner.
QUEUE_DEPTH = 4


class IMPALA(RLCheckpointMixin):
    """Async actor-learner driver: workers stream rollout batches into
    a learner queue (the runtime's streaming generators); the learner
    applies V-trace updates as batches arrive and broadcasts weights
    back."""

    _ckpt_attrs = ("params", "opt_state", "updates")

    def __init__(self, config: IMPALAConfig, device: DeviceLike = None
                 ) -> None:
        c = self.config = config
        self.device = resolve_device(device)
        if c.network == "conv":
            probe_env = (c.env_maker or (lambda s: PixelCartPoleEnv(
                max_steps=c.env_max_steps, seed=s)))(0)
            self.params = seeded_params(c.seed, self.device, lambda g: (
                init_conv_policy(g, probe_env.reset().shape,
                                 probe_env.num_actions, hidden=c.hidden)))
            self._forward = conv_policy_forward
        else:
            probe_env = (c.env_maker or (lambda s: CartPoleEnv(
                max_steps=c.env_max_steps, seed=s)))(0)
            self.params = seeded_params(c.seed, self.device, lambda g: (
                init_policy(g, probe_env.reset().shape[0],
                            probe_env.num_actions, hidden=c.hidden)))
            self._forward = policy_forward
        self.optimizer = Adam(c.lr)
        self.opt_state = self.optimizer.init(self.params)
        self._update = make_vtrace_update(
            self._forward, self.optimizer, c.gamma, c.rho_clip, c.c_clip,
            c.vf_coef, c.ent_coef, device=self.device)
        host_params = wk.host_tree(self.params)
        self.workers = wk.spawn(
            ray_tpu_torch.remote(VTraceRolloutWorker),
            c.num_rollout_workers,
            lambda i: (i, c.num_envs_per_worker, c.rollout_len,
                       host_params, c.network, c.env_maker,
                       c.env_max_steps),
            max_concurrency=2)
        self.updates = 0
        self._reward_window: List[float] = []

    def _restored(self) -> None:
        """The restored weights reach every worker before its next
        batch."""
        pref = ray_tpu_torch.put(wk.host_tree(self.params))
        wk.gather([w.set_params.remote(pref) for w in self.workers])

    def learn(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One V-trace update on a [T, N] batch."""
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, batch)
        return metrics

    def _result(self, steps: int, needed: int, wall: float,
                metrics: Dict[str, Any], learn_s: float) -> Dict[str, Any]:
        return {
            "num_updates": self.updates,
            "episode_reward_mean": wk.reward_mean(self._reward_window),
            "env_steps": steps,
            "learner_steps_per_s": round(steps / max(wall, 1e-9), 1),
            "updates_per_s": round(needed / max(wall, 1e-9), 2),
            "wall_s": round(wall, 2),
            "learn_time_s": learn_s,
            **wk.floats(metrics),
        }

    def train_async(self, num_updates: int) -> Dict[str, Any]:
        """Run the async loop until `num_updates` learner updates have
        been applied (a total over the algorithm's life); returns
        aggregate metrics including learner throughput."""
        needed = num_updates - self.updates
        if needed <= 0:
            return self._result(0, 0, 0.0, {}, 0.0)
        per_worker = -(-needed // len(self.workers))
        gens = [w.stream_rollouts.options(
            num_returns="streaming").remote(per_worker)
            for w in self.workers]
        batch_q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()

        def drain(gen) -> None:
            try:
                for ref in gen:
                    item = ray_tpu_torch.get(ref,
                                             timeout=wk.SAMPLE_TIMEOUT_S)
                    while not stop.is_set():
                        try:
                            batch_q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            pass
            except Exception as e:          # surface on the learner
                batch_q.put(e)

        threads = [threading.Thread(target=drain, args=(g,), daemon=True,
                                    name="rtorch-impala-drain")
                   for g in gens]
        for t in threads:
            t.start()

        t0 = time.time()
        steps = 0
        learn_s = 0.0
        metrics: Dict[str, Any] = {}
        try:
            while self.updates < num_updates:
                batch = batch_q.get(timeout=wk.SAMPLE_TIMEOUT_S)
                if isinstance(batch, Exception):
                    raise batch
                self._reward_window.extend(batch.pop("episode_returns"))
                self._reward_window = self._reward_window[-100:]
                steps += batch["rewards"].size
                t1 = time.time()
                metrics = self.learn(batch)
                learn_s += time.time() - t1
                self.updates += 1
                if self.updates % self.config.broadcast_every == 0:
                    pref = ray_tpu_torch.put(wk.host_tree(self.params))
                    for w in self.workers:
                        w.set_params.remote(pref)   # fire-and-forget
            wall = time.time() - t0
        finally:
            # Per-worker batch counts round up, so up to W-1 surplus
            # batches may still be in flight: let the drain threads
            # finish reading them, and drop what they would queue.
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    batch_q.get(timeout=0.2)
                except queue.Empty:
                    pass
            for t in threads:
                t.join(timeout=wk.SAMPLE_TIMEOUT_S)
        return self._result(steps, needed, wall, metrics, learn_s)

    def stop(self) -> None:
        wk.kill_all(self.workers)

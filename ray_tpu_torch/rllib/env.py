"""RL environments: gym-style API + a vectorized CartPole in numpy.

Reference analog: RLlib's env layer (rllib/env/) consumes external gym
envs; this tree ships a self-contained classic-control benchmark so the
algorithm stack runs with zero external dependencies (the image has no
gym).  The VectorEnv steps N instances batched — rollout workers always
operate on the vector form.

The port's own copy of `ray_tpu/rllib/env.py` (numpy only, as there):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np


class CartPoleEnv:
    """Classic cart-pole balancing (Barto-Sutton-Anderson dynamics, the
    same constants as the canonical benchmark).  Observation
    [x, x_dot, theta, theta_dot]; actions {0: left, 1: right}; +1 reward
    per step; episode ends on |x|>2.4, |theta|>12deg, or step limit."""

    GRAVITY = 9.8
    CART_M = 1.0
    POLE_M = 0.1
    POLE_HALF_L = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * math.pi / 360

    observation_size = 4
    num_actions = 2

    def __init__(self, max_steps: int = 200,
                 seed: Optional[int] = None) -> None:
        self.max_steps = max_steps
        self.rng = np.random.RandomState(seed)
        self.state = np.zeros(4, np.float64)
        self.steps = 0

    def reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.steps = 0
        return self.state.astype(np.float32)

    def step(self, action: int
             ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        x, x_dot, th, th_dot = self.state
        force = self.FORCE if action == 1 else -self.FORCE
        total_m = self.CART_M + self.POLE_M
        pm_l = self.POLE_M * self.POLE_HALF_L
        cos, sin = math.cos(th), math.sin(th)
        tmp = (force + pm_l * th_dot ** 2 * sin) / total_m
        th_acc = (self.GRAVITY * sin - cos * tmp) / (
            self.POLE_HALF_L * (4.0 / 3.0
                                - self.POLE_M * cos ** 2 / total_m))
        x_acc = tmp - pm_l * th_acc * cos / total_m
        self.state = np.array([x + self.DT * x_dot,
                               x_dot + self.DT * x_acc,
                               th + self.DT * th_dot,
                               th_dot + self.DT * th_acc])
        self.steps += 1
        done = (abs(self.state[0]) > self.X_LIMIT
                or abs(self.state[2]) > self.THETA_LIMIT
                or self.steps >= self.max_steps)
        return self.state.astype(np.float32), 1.0, done, {}


class PendulumEnv:
    """Classic underactuated pendulum swing-up (the canonical
    continuous-action benchmark, same dynamics/constants as the
    standard Pendulum-v1).  Observation [cos th, sin th, th_dot];
    action: torque in [-2, 2] (continuous); reward
    -(angle^2 + 0.1 th_dot^2 + 0.001 torque^2); fixed-length episodes.
    """

    GRAVITY = 10.0
    MASS = 1.0
    LENGTH = 1.0
    DT = 0.05
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0

    observation_size = 3
    action_size = 1
    continuous_actions = True
    action_low = -2.0
    action_high = 2.0

    def __init__(self, max_steps: int = 200,
                 seed: Optional[int] = None) -> None:
        self.max_steps = max_steps
        self.rng = np.random.RandomState(seed)
        self.th = 0.0
        self.th_dot = 0.0
        self.steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([math.cos(self.th), math.sin(self.th),
                         self.th_dot], np.float32)

    def reset(self) -> np.ndarray:
        self.th = self.rng.uniform(-math.pi, math.pi)
        self.th_dot = self.rng.uniform(-1.0, 1.0)
        self.steps = 0
        return self._obs()

    def step(self, action
             ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th_norm = ((self.th + math.pi) % (2 * math.pi)) - math.pi
        cost = th_norm ** 2 + 0.1 * self.th_dot ** 2 + 0.001 * u ** 2
        g, m, L, dt = self.GRAVITY, self.MASS, self.LENGTH, self.DT
        self.th_dot += (3 * g / (2 * L) * math.sin(self.th)
                        + 3.0 / (m * L * L) * u) * dt
        self.th_dot = float(np.clip(self.th_dot, -self.MAX_SPEED,
                                    self.MAX_SPEED))
        self.th += self.th_dot * dt
        self.steps += 1
        done = self.steps >= self.max_steps
        return self._obs(), -cost, done, {}


class VectorEnv:
    """N independent env instances, stepped as a batch; auto-resets
    finished episodes (rllib vector_env semantics).  Continuous-action
    envs (declaring `continuous_actions = True`) receive their action
    row as-is; discrete envs get a python int."""

    def __init__(self, make_env, num_envs: int,
                 seed: int = 0) -> None:
        self.envs = [make_env(seed + i) for i in range(num_envs)]
        self.num_envs = num_envs
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list = []

    def reset(self) -> np.ndarray:
        self.episode_returns[:] = 0.0
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs, rews, dones = [], [], []
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, d, _ = env.step(
                a if getattr(env, "continuous_actions", False)
                else int(a))
            self.episode_returns[i] += r
            if d:
                self.completed_returns.append(self.episode_returns[i])
                self.episode_returns[i] = 0.0
                o = env.reset()
            obs.append(o)
            rews.append(r)
            dones.append(d)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(dones, np.bool_))

    def drain_episode_returns(self) -> list:
        out, self.completed_returns = self.completed_returns, []
        return out


class PixelCartPoleEnv:
    """CartPole with PIXEL observations: the 'CartPole -> Atari' shape
    (BASELINE config #4) without shipping ROMs.  Each step renders the
    cart (block) and pole (line) into a small grayscale frame; the
    observation stacks the last two frames as channels so velocity is
    visible (the same role as Atari frame-stacking).

    Observation: [H, W, 2] float32 in [0, 1]; actions as CartPoleEnv.
    """

    H = 40
    W = 60
    num_actions = 2

    def __init__(self, max_steps: int = 200,
                 seed: Optional[int] = None) -> None:
        self._env = CartPoleEnv(max_steps=max_steps, seed=seed)
        self._prev = np.zeros((self.H, self.W), np.float32)

    @property
    def observation_shape(self) -> Tuple[int, int, int]:
        return (self.H, self.W, 2)

    def _render(self) -> np.ndarray:
        x, _, th, _ = self._env.state
        f = np.zeros((self.H, self.W), np.float32)
        # cart: 3x7 block on the bottom band, x in [-2.4, 2.4] -> col
        cx = int((x / CartPoleEnv.X_LIMIT + 1) * 0.5 * (self.W - 1))
        cx = min(max(cx, 3), self.W - 4)
        f[self.H - 6:self.H - 3, cx - 3:cx + 4] = 1.0
        # pole: line from cart top at angle th (up = -rows)
        L = self.H - 12
        for i in range(L):
            r = self.H - 7 - int(i * math.cos(th))
            c = cx + int(i * math.sin(th))
            if 0 <= r < self.H and 0 <= c < self.W:
                f[r, c] = 1.0
        return f

    def reset(self) -> np.ndarray:
        self._env.reset()
        frame = self._render()
        self._prev = frame
        return np.stack([frame, frame], axis=-1)

    def step(self, action: int
             ) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        _, r, done, info = self._env.step(action)
        frame = self._render()
        obs = np.stack([self._prev, frame], axis=-1)
        self._prev = frame
        return obs, r, done, info

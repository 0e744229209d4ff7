"""Connector pipelines: observation/action pre- and post-processing.

Reference surface: rllib/connectors/ — AgentConnectorPipeline
transforms raw env observations before they reach the policy
(clipping, normalization, frame-stacking), ActionConnectorPipeline
transforms policy outputs before they reach the env (unsquash, clip).
Connectors are plain callables composed in order, stateful when they
need to be (e.g. running mean/std), and picklable so rollout workers
can ship them (reference: connectors/connector.py Connector).

The port's own copy of `ray_tpu/rllib/connectors.py` (numpy only, as
there): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


class Connector:
    """One transform stage; override __call__."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear per-episode state (frame stacks etc.)."""


class ConnectorPipeline(Connector):
    """Ordered composition (reference: connectors/connector.py
    ConnectorPipeline)."""

    def __init__(self, connectors: Sequence[Connector]) -> None:
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0) -> None:
        self.low, self.high = low, high

    def __call__(self, x):
        return np.clip(x, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std normalization (Welford accumulation over every
    observation seen; reference: MeanStdFilter,
    rllib/utils/filter.py)."""

    def __init__(self, eps: float = 1e-8) -> None:
        self.count = 0
        self.mean: Any = None
        self.m2: Any = None
        self.eps = eps

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        batch = x if x.ndim > 1 else x[None]
        for row in batch:
            self.count += 1
            if self.mean is None:
                self.mean = row.copy()
                self.m2 = np.zeros_like(row)
            else:
                delta = row - self.mean
                self.mean += delta / self.count
                self.m2 += delta * (row - self.mean)
        std = np.sqrt(self.m2 / max(self.count - 1, 1)) \
            if self.count > 1 else np.ones_like(self.mean)
        out = (x - self.mean) / (std + self.eps)
        return out.astype(np.float32)


class FrameStack(Connector):
    """Stack the last k observations along the last axis (the Atari
    idiom; reference: connectors/agent/frame_stacking.py)."""

    def __init__(self, k: int = 4) -> None:
        self.k = k
        self._frames: List[np.ndarray] = []

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        if not self._frames:
            self._frames = [x] * self.k
        else:
            self._frames = self._frames[1:] + [x]
        return np.concatenate([f[..., None] for f in self._frames],
                              axis=-1)

    def reset(self) -> None:
        self._frames = []


class FlattenObs(Connector):
    def __call__(self, x):
        x = np.asarray(x)
        return x.reshape(-1).astype(np.float32)


class ClipActions(Connector):
    """Clip continuous actions into the env's bounds (reference:
    connectors/action/clip.py)."""

    def __init__(self, low: float, high: float) -> None:
        self.low, self.high = low, high

    def __call__(self, a):
        return np.clip(a, self.low, self.high)


class UnsquashActions(Connector):
    """Map policy outputs in [-1, 1] onto [low, high] (reference:
    action-space unsquashing, connectors/action/normalize.py role)."""

    def __init__(self, low: float, high: float) -> None:
        self.low, self.high = low, high

    def __call__(self, a):
        a = np.asarray(a, np.float32)
        return self.low + (np.clip(a, -1.0, 1.0) + 1.0) * 0.5 \
            * (self.high - self.low)


class ConnectedEnv:
    """Wrap an env with obs/action connector pipelines so any algorithm
    consumes preprocessed observations transparently (reference: the
    env-to-module connector seam in EnvRunner)."""

    def __init__(self, env, obs_connectors: Sequence[Connector] = (),
                 action_connectors: Sequence[Connector] = ()) -> None:
        self._env = env
        self.obs_pipeline = ConnectorPipeline(list(obs_connectors))
        self.action_pipeline = ConnectorPipeline(
            list(action_connectors))
        for attr in ("observation_size", "num_actions", "action_size",
                     "continuous_actions", "action_low",
                     "action_high", "observation_shape"):
            if hasattr(env, attr):
                setattr(self, attr, getattr(env, attr))
        if self.obs_pipeline.connectors:
            # Connectors may reshape observations (FrameStack,
            # FlattenObs): probe one reset so the advertised shape is
            # what algorithms will actually receive, then clear the
            # probe's pipeline state.
            probe = self.obs_pipeline(env.reset())
            self.obs_pipeline.reset()
            self.observation_shape = tuple(np.shape(probe))
            if np.ndim(probe) == 1:
                self.observation_size = int(np.shape(probe)[0])
            elif hasattr(self, "observation_size"):
                del self.observation_size

    def reset(self):
        self.obs_pipeline.reset()
        self.action_pipeline.reset()
        return self.obs_pipeline(self._env.reset())

    def step(self, action):
        o, r, d, info = self._env.step(self.action_pipeline(action))
        return self.obs_pipeline(o), r, d, info

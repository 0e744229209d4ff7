"""RL library of the port, in PyTorch.

Port of `ray_tpu/rllib/`.  Every learner of the JAX package is here as a
plain function of parameter dicts, an optax-shaped Adam state, a batch
and a torch.Generator (or the draws themselves): PPO with GAE, V-trace
for IMPALA (MLP and conv policies) and APPO, double DQN with replay
buffers and n-step folding, SAC, CQL, BC and MARWIL, and PPO per policy
for multi-agent envs.  The online algorithms (PPO, DQN, SAC, IMPALA,
APPO, MultiAgentPPO) sample through CPU rollout-worker actors on the
port's runtime and learn on the learner's device (CUDA unless
`build(device=...)` names another); the offline ones (`CQL`, `MARWIL`,
`BC`) train from in-memory data or from parquet through
`ray_tpu_torch.data` (`log_transitions` writes it).  Every algorithm
saves and restores its learner state (`checkpoint.py`).
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig, make_appo_update
from ray_tpu_torch.rllib.connectors import (ClipActions, ClipObs,
                                            ConnectedEnv, Connector,
                                            ConnectorPipeline, FlattenObs,
                                            FrameStack, NormalizeObs,
                                            UnsquashActions)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig, make_cql_update_fn
from ray_tpu_torch.rllib.env import (CartPoleEnv, PendulumEnv,
                                     PixelCartPoleEnv, VectorEnv)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, make_vtrace_update
from ray_tpu_torch.rllib.multi_agent import (MultiAgentCartPole,
                                             MultiAgentEnv,
                                             MultiAgentLearner,
                                             MultiAgentPPO,
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.offline import (BC, MARWIL, BCConfig,
                                         MARWILConfig,
                                         collect_expert_episodes,
                                         log_transitions)
from ray_tpu_torch.rllib.optim import Adam, AdamState
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, RolloutWorker
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = ["PPO", "PPOConfig", "DQN", "DQNConfig", "IMPALA",
           "IMPALAConfig", "APPO", "APPOConfig", "SAC", "SACConfig",
           "RolloutWorker", "MultiAgentPPO", "CQL", "CQLConfig",
           "MARWIL", "MARWILConfig", "BC", "BCConfig",
           "collect_expert_episodes", "log_transitions",
           "make_appo_update", "make_cql_update_fn", "make_vtrace_update",
           "Adam", "AdamState", "CartPoleEnv", "PendulumEnv",
           "PixelCartPoleEnv", "VectorEnv", "Connector",
           "ConnectorPipeline", "ClipObs", "NormalizeObs", "FrameStack",
           "FlattenObs", "ClipActions", "UnsquashActions", "ConnectedEnv",
           "MultiAgentEnv", "MultiAgentCartPole", "MultiAgentLearner",
           "MultiAgentPPOConfig"]

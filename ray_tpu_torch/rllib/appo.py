"""APPO's learner: IMPALA's V-trace bootstrapped from a target network,
with PPO's clipped surrogate.

Port of `ray_tpu/rllib/appo.py`.  `APPO` is IMPALA's driver (streaming
workers, `train_async`) with this update in place of V-trace's.  The update takes and returns the packed
`(opt_state, target_params, step)` that the JAX algorithm keeps where
IMPALA keeps its optimizer state; build it as `(optimizer.init(params),
tree_copy(params), 0)`.  The target refreshes in place from the live
parameters when `step % target_update_freq == 0`, counted after the
increment, and stays its own storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.impala import (IMPALA, IMPALAConfig,
                                        behaviour_terms, entropy_of,
                                        vtrace_targets)
from ray_tpu_torch.rllib.optim import (Adam, as_tensors, tree_copy,
                                       tree_leaves, value_and_grad)


def make_appo_update(forward: Callable, optimizer: Adam, gamma: float,
                     rho_clip: float, c_clip: float, clip_param: float,
                     vf_coef: float, ent_coef: float,
                     target_update_freq: int, device: DeviceLike = None
                     ) -> Callable:
    """update(params, (opt_state, target_params, step), batch) ->
    (params, (opt_state, target_params, step), metrics)."""
    dev = resolve_device(device)

    def loss_fn(params, target_params, batch):
        logits, values, tgt_logp, logp_all = behaviour_terms(
            forward, params, batch)
        with torch.no_grad():
            _, tvalues = forward(target_params, torch.cat(
                [batch["obs"], batch["last_obs"][None]], 0))
        rho = torch.exp(tgt_logp - batch["logp"])
        rho_c = torch.clamp(rho, max=rho_clip)
        cs = torch.clamp(rho, max=c_clip)
        not_done = 1.0 - batch["dones"]
        vs, pg_adv = vtrace_targets(rho_c, cs, batch["rewards"],
                                    not_done, tvalues, gamma)
        pg_adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0)
                                             + 1e-8)
        surr = torch.minimum(
            rho * pg_adv,
            torch.clamp(rho, 1.0 - clip_param, 1.0 + clip_param) * pg_adv)
        pg_loss = -surr.mean()
        vf_loss = 0.5 * ((values[:-1] - vs) ** 2).mean()
        entropy = entropy_of(logits, logp_all)
        total = pg_loss + vf_coef * vf_loss - ent_coef * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_rho": rho.mean()}

    def update(params, wrapped, batch):
        opt_state, target_params, step = wrapped
        b = as_tensors(batch, dev, ints=("actions",))
        (loss, metrics), grads = value_and_grad(
            loss_fn, params, target_params, b, has_aux=True)
        opt_state = optimizer.step_(params, grads, opt_state)
        step = step + 1
        if step % target_update_freq == 0:
            with torch.no_grad():
                for t, p in zip(tree_leaves(target_params),
                                tree_leaves(params)):
                    t.copy_(p)
        metrics["loss"] = loss
        return params, (opt_state, target_params, step), metrics

    return update


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.3
    target_update_freq: int = 4

    def build(self, device: DeviceLike = None) -> "APPO":
        return APPO(self, device=device)


class APPO(IMPALA):
    """IMPALA driver + PPO surrogate learner (see module docstring).

    The async loop, streaming workers, and broadcast cadence are
    inherited; only the update (and the state packed next to the
    optimizer state) differ."""

    def __init__(self, config: APPOConfig, device: DeviceLike = None
                 ) -> None:
        super().__init__(config, device=device)
        self._update = make_appo_update(
            self._forward, self.optimizer, config.gamma, config.rho_clip,
            config.c_clip, config.clip_param, config.vf_coef,
            config.ent_coef, config.target_update_freq,
            device=self.device)
        # Pack (opt_state, target_params, step) where the driver keeps
        # opt_state: train_async stays IMPALA's.
        self.opt_state = (self.opt_state, tree_copy(self.params), 0)

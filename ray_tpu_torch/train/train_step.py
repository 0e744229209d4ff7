"""One-device training step: the counterpart of `ray_tpu/train/train_step.py`.

`CompiledTrainStep(cfg)` runs `models.transformer.loss_fn` forward,
autograd backward (the flash kernels B1-B3 on every layer) and the
optimizer, eagerly, on one CUDA device — or on the CPU when the caller
passes `device="cpu"`, as the tests do.  The JAX class compiles the whole
step into one XLA program over a mesh; here `mesh` must be None (the
sharded path is ROADMAP Queue A, A6), and the name is kept so callers and
telemetry hooks (`_cache_size`, `flops_per_token`, `shard_batch`) carry
over.

`make_optimizer` is a plain-PyTorch transcription of the JAX package's
optax chain (`clip_by_global_norm` then `adamw` on a warmup-cosine
schedule), with optax's exact rules: the learning rate is read at the
count before the increment (the first step's is 0); clipping multiplies
by max/norm only when norm >= max, with no epsilon; AdamW uses eps=1e-8,
eps_root=0, bias corrections, and decays every parameter (norms and
embeddings too); the first moment is updated and bias-corrected in f32
and only then stored as `mu_dtype` (bf16 by default).  The decay
`b1 * mu` multiplies the stored mu by b1 rounded to `mu_dtype` (JAX's
weak typing) and keeps the product in f32, unrounded, as XLA's fused
update does; the second moment is f32.  `torch.optim.AdamW` and `clip_grad_norm_` differ from it
in these details.  Parameters and moments are updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer
from ray_tpu_torch.train.telemetry import transformer_flops_per_token

# Eager PyTorch compiles nothing per input shape: `_cache_size` is this
# constant, so a telemetry compile detector watching it grow never
# classifies a step as a compile.
EAGER_CACHE_SIZE = 1


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]
    opt_state: Dict[str, Any]


def _leaves(tree) -> List[torch.Tensor]:
    """Tensors of a nested dict in JAX's pytree order (sorted keys)."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        out.extend(_leaves(node) if isinstance(node, dict) else [node])
    return out


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


class AdamW:
    """clip_by_global_norm(grad_clip) -> adamw(warmup-cosine schedule),
    as the JAX package's `make_optimizer` chains them in optax."""

    def __init__(self, learning_rate: float, warmup_steps: int,
                 total_steps: int, weight_decay: float, b1: float,
                 b2: float, grad_clip: float, mu_dtype) -> None:
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)
        self.weight_decay = weight_decay
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = 1e-8, 0.0
        self.grad_clip = grad_clip
        self.mu_dtype = _dtype(mu_dtype)

    def lr(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay) at
        `count`, in f32 arithmetic as optax evaluates it."""
        f32 = np.float32
        peak, w = f32(self.learning_rate), self.warmup_steps
        if count < w:                        # linear 0 -> peak
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return float((f32(0) - peak) * frac + peak)
        steps = self.decay_steps - w
        c = f32(min(count - w, steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps)))
        return float(peak * cosine)

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": _map(lambda p: torch.zeros_like(
                    p, dtype=self.mu_dtype), params),
                "nu": _map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], opt_state, params
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """One step, in place on `params` and the moments.  `grads` are
        in `_leaves(params)` order.  Returns (opt_state, raw grad norm)."""
        count = opt_state["count"]
        f32 = np.float32
        lr = self.lr(count)
        inc = count + 1
        bc1 = float(f32(1) - f32(self.b1) ** f32(inc))
        bc2 = float(f32(1) - f32(self.b2) ** f32(inc))
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.grad_clip
        b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
        for p, g, mu, nu in zip(_leaves(params), grads,
                                _leaves(opt_state["mu"]),
                                _leaves(opt_state["nu"])):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            m = g * (1 - self.b1) + mu.float() * b1
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / (torch.sqrt(nu / bc2 + self.eps_root)
                             + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * torch.tensor(-lr, dtype=u.dtype, device=u.device))
            mu.copy_(m)
        return dict(opt_state, count=inc), norm


def make_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                   total_steps: int = 10_000, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0, mu_dtype="bfloat16",
                   kind: str = "adamw") -> AdamW:
    if kind == "adafactor":
        raise NotImplementedError(
            "Adafactor is not ported yet (ROADMAP Queue A: transcribe "
            "optax.adafactor's defaults); use kind='adamw'")
    if kind != "adamw":
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return AdamW(learning_rate, warmup_steps, total_steps, weight_decay,
                 b1, b2, grad_clip, mu_dtype)


class CompiledTrainStep:
    """The train step for one model on one device (eager; see module
    docstring)."""

    def __init__(self, cfg: transformer.TransformerConfig, mesh=None,
                 optimizer: Optional[AdamW] = None,
                 device: DeviceLike = None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "CompiledTrainStep runs on one device (mesh=None); the "
                "sharded step is ROADMAP Queue A, A6")
        self.cfg = cfg
        self.mesh = None
        self.optimizer = optimizer or make_optimizer()
        self.device = resolve_device(device)

    # -- public API --------------------------------------------------------
    def init_state(self, seed: int = 0,
                   params: Optional[Dict[str, Any]] = None) -> TrainState:
        """Fresh state: random parameters from `seed` (a torch.Generator;
        see transformer.init_params), or the given ones moved to this
        step's device, with zeroed optimizer moments."""
        if params is None:
            params = transformer.init_params(self.cfg, seed, self.device)
        else:
            params = _map(lambda p: p.detach().to(
                self.device, self.cfg.param_dtype).clone(), params)
        for p in _leaves(params):
            p.requires_grad_(True)
        return TrainState(0, params, self.optimizer.init(params))

    def _cache_size(self) -> int:
        """Compiled-variant count, telemetry's compile detector: eager
        PyTorch compiles nothing, so this is `EAGER_CACHE_SIZE`."""
        return EAGER_CACHE_SIZE

    def flops_per_token(self, seq: int,
                        n_params: Optional[int] = None) -> float:
        """Model FLOPs per trained token (6N + attention)."""
        if n_params is None:
            n_params = sum(math.prod(shape) for shape, _ in _leaves(
                transformer.param_specs(self.cfg)))
        return transformer_flops_per_token(
            n_params, self.cfg.n_layers, seq, self.cfg.d_model)

    def shard_batch(self, tokens) -> torch.Tensor:
        """Tokens [B, S+1] as an int64 tensor on this step's device."""
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)

    def __call__(self, state: TrainState, tokens: torch.Tensor
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = _leaves(state.params)
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(state.params, tokens,
                                                self.cfg)
            grads = torch.autograd.grad(loss, leaves)
        opt_state, grad_norm = self.optimizer.update_(
            list(grads), state.opt_state, state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, opt_state), metrics


"""The training step: the counterpart of `ray_tpu/train/train_step.py`.

`CompiledTrainStep(cfg, mesh)` runs `models.transformer.loss_fn` forward,
autograd backward (the flash kernels B1-B3 on every layer) and the
optimizer, eagerly, on CUDA — or on the CPU when the caller passes
`device="cpu"` or a CPU mesh, as the tests do.  The JAX class compiles
the whole step into one XLA program over a mesh; the name is kept so
callers and telemetry hooks (`_cache_size`, `flops_per_token`,
`shard_batch`) carry over.

Meshes (`parallel/mesh.py`).  `mesh=None` and a mesh of one device run
the same one-device step, bit for bit.  On a larger mesh (dp, fsdp, tp,
sp, ep; a pp axis is replicated, as in JAX: the pipeline is
`parallel/pipeline.py`) the parameters are DTensors placed by
`transformer.logical_axes` and the rules (`parallel/sharding.py`),
experts split over ep, and the optimizer state as JAX's
`_state_shardings` places it: trees that mirror the parameters (AdamW's
moments) take their placements, everything else (Adafactor's factored
statistics) is replicated, and the count is a Python int on every rank.
Gradients arrive in the parameters' placements; AdamW updates each
rank's shards elementwise, with the global gradient norm summed over
every shard; Adafactor updates each leaf from its whole gathered
gradient, one leaf at a time, and each rank applies its own part, so the
factored statistics and block RMS are those of the whole leaf.

`make_optimizer` is a plain-PyTorch transcription of the JAX package's
optax chains on a warmup-cosine schedule: `kind="adamw"` (the default)
is `clip_by_global_norm` then `adamw`, `kind="adafactor"` is
`optax.adafactor(learning_rate=schedule)` with its defaults (see
`Adafactor`).  AdamW follows optax's exact rules: the learning rate is
read at the count before the increment (the first step's is 0); clipping
multiplies by max/norm only when norm >= max, with no epsilon; AdamW
uses eps=1e-8, eps_root=0, bias corrections, and decays every parameter
(norms and embeddings too); the first moment is updated and
bias-corrected in f32 and only then stored as `mu_dtype` (bf16 by
default).  The decay `b1 * mu` multiplies the stored mu by b1 rounded to
`mu_dtype` (JAX's weak typing) and keeps the product in f32, unrounded,
as XLA's fused update does; the second moment is f32.
`torch.optim.AdamW` and `clip_grad_norm_` differ from it in these
details.  Parameters and moments are updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models import transformer
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, Rules,
                                             is_dtensor, mesh_trivial,
                                             spec_for, tree_specs)
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


def _local(t):
    """A DTensor's local shard; a plain tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _local_region(shape, mesh, placements) -> Tuple[slice, ...]:
    """The part of a global tensor of `shape` that this rank's shard
    holds under `placements`, as slices: each Shard placement, in mesh
    order, splits what the earlier ones left as `torch.chunk` does."""
    start, stop = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        d = p.dim
        size = -(-(stop[d] - start[d]) // mesh.size(i))
        lo = min(start[d] + coord[i] * size, stop[d])
        start[d], stop[d] = lo, min(lo + size, stop[d])
    return tuple(slice(a, b) for a, b in zip(start, stop))


def _region(t) -> Tuple[slice, ...]:
    return _local_region(t.shape, t.device_mesh, t.placements)


def _place(full: torch.Tensor, mesh, placements):
    """The DTensor with these placements whose whole is `full` (the same
    on every rank): each rank keeps its part, nothing is sent."""
    from torch.distributed.tensor import DTensor
    part = full[_local_region(full.shape, mesh, placements)]
    return DTensor.from_local(part.contiguous(), mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def _vector_norm(t) -> torch.Tensor:
    """The f32 2-norm of a tensor, or of a DTensor's whole: each rank's
    shard's sum of squares, added over the mesh dims that split it."""
    if not is_dtensor(t):
        return torch.linalg.vector_norm(t, dtype=torch.float32)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    local = torch.linalg.vector_norm(t.to_local(), dtype=torch.float32)
    return DTensor.from_local(local.square(), t.device_mesh, [
        Partial() if p.is_shard() else Replicate() for p in t.placements],
        run_check=False).full_tensor().sqrt()


class _Scheduled:
    """The learning-rate schedule both optimizers read:
    optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))."""

    def __init__(self, learning_rate: float, warmup_steps: int,
                 total_steps: int) -> None:
        self.learning_rate = learning_rate
        self.warmup_steps = warmup_steps
        self.decay_steps = max(total_steps, warmup_steps + 1)

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


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm),
    over every shard of DTensor gradients."""
    return torch.linalg.vector_norm(torch.stack(
        [_vector_norm(g) for g in grads]))


class AdamW(_Scheduled):
    """clip_by_global_norm(grad_clip) -> adamw(warmup-cosine schedule),
    as the JAX package's `make_optimizer` chains them in optax."""

    def __init__(self, learning_rate: float, warmup_steps: int,
                 total_steps: int, weight_decay: float, b1: float,
                 b2: float, grad_clip: float, mu_dtype) -> None:
        super().__init__(learning_rate, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = 1e-8, 0.0
        self.grad_clip = grad_clip
        self.mu_dtype = _dtype(mu_dtype)

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
        norm = _global_norm(grads)
        keep = norm < self.grad_clip
        b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
        for p, g, mu, nu in zip(*(map(_local, t) for t in (
                _leaves(params), grads, _leaves(opt_state["mu"]),
                _leaves(opt_state["nu"])))):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            m = g * (1 - self.b1) + mu.float() * b1
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            u = (m / bc1) / (torch.sqrt(nu / bc2 + self.eps_root)
                             + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * torch.tensor(-lr, dtype=u.dtype, device=u.device))
            mu.copy_(m)
        return dict(opt_state, count=inc), norm


def _factored_dims(shape, min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """optax's choice: the second-largest and the largest axis (as
    np.argsort orders `shape`), or None when the second-largest is under
    `min_dim_size_to_factor` or the leaf has fewer than 2 axes."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Scheduled):
    """optax.adafactor(learning_rate=schedule) with its defaults, as the
    JAX package's `make_optimizer(kind="adafactor")` builds it: per leaf,
    scale_by_factored_rms (decay 1 - (count+1)^-0.8, eps 1e-30, the two
    largest axes factored when both are >= 128) -> clip_by_block_rms(1)
    -> the schedule's learning rate at the count before the increment ->
    scale_by_param_block_rms (max(rms(param), 1e-3)) -> scale(-1).  No
    momentum, weight decay or global-norm clip.

    State, all f32: per factored leaf the running means of g^2 + eps over
    each factored axis (`v_row` drops the largest axis, `v_col` the
    second-largest), per other leaf the full `v`; the unused entries are
    (1,) zeros, as optax keeps them.  Both block RMS steps take the RMS
    over the whole stacked leaf.  A leaf is walked in chunks of at most
    `chunk_elements` along its first axis (never a factored one): one
    pass updates the state and sums the update's squares, a second
    applies it, so the largest temporary is one chunk."""

    decay_rate = 0.8
    eps = 1e-30
    min_dim_size_to_factor = 128
    clipping_threshold = 1.0
    min_scale = 1e-3
    chunk_elements = 1 << 28

    def _dims(self, shape) -> Optional[Tuple[int, int]]:
        return _factored_dims(shape, self.min_dim_size_to_factor)

    def init(self, params) -> Dict[str, Any]:
        def state(p, which):
            dims = self._dims(p.shape)
            if dims is None:
                shape = p.shape if which == "v" else (1,)
            elif which == "v":
                shape = (1,)
            else:                  # v_row drops d0, v_col drops d1
                shape = np.delete(p.shape,
                                  dims[1 if which == "v_row" else 0])
            return torch.zeros(tuple(shape), dtype=torch.float32,
                               device=p.device)

        return {"count": 0, **{which: _map(
            lambda p, w=which: state(p, w), params)
            for which in ("v_row", "v_col", "v")}}

    def _chunks(self, shape, dims):
        """Slices along axis 0 of at most `chunk_elements` elements each
        (one slice of the whole leaf when axis 0 is factored)."""
        if len(shape) < 2 or (dims is not None and 0 in dims):
            return [slice(None)]
        step = max(1, self.chunk_elements // max(1, math.prod(shape[1:])))
        return [slice(i, i + step) for i in range(0, shape[0], step)]

    def _scaled(self, g, dims, vr, vc, v):
        """The update of scale_by_factored_rms from the new state."""
        if dims is None:
            return g * v.rsqrt()
        d1, d0 = dims
        row_mean = vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
        return (g * (vr / row_mean).rsqrt().unsqueeze(d0)
                * vc.rsqrt().unsqueeze(d1))

    @torch.no_grad()
    def update_(self, grads: List[Optional[torch.Tensor]], opt_state,
                params) -> Tuple[Dict[str, Any], torch.Tensor]:
        """One step, in place on `params` and the state.  `grads` are in
        `_leaves(params)` order; each entry is set to None once its leaf
        is updated, so a caller that holds no other reference frees it.
        Returns (opt_state, raw grad norm)."""
        count = opt_state["count"]
        f32 = np.float32
        decay = f32(1) - f32(count + 1) ** f32(-self.decay_rate)
        keep, add = float(decay), float(f32(1) - decay)
        lr = self.lr(count)
        norm = _global_norm(grads)
        for i, (p, *state) in enumerate(zip(_leaves(params), *(
                _leaves(opt_state[w]) for w in ("v_row", "v_col", "v")))):
            g = grads[i]
            dims = self._dims(p.shape)
            chunks = self._chunks(p.shape, dims)
            region = None
            if is_dtensor(p):
                # The whole gradient and state (the statistics are the
                # whole leaf's); the chunks walk axis 0 only where this
                # rank holds all of it.
                g, region = g.full_tensor(), _region(p)
                if region[0] != slice(0, p.shape[0]):
                    chunks = [slice(None)]
            vr, vc, v = whole = [t.full_tensor() if is_dtensor(t) else t
                                 for t in state]
            sumsq = torch.zeros((), dtype=torch.float32, device=p.device)
            # Each chunk's temporaries are freed (del) before the next
            # chunk allocates its own: the peak is one chunk's worth.
            for c in chunks:                 # state, and sum of u^2
                gsq = g[c].float().square().add_(self.eps)
                if dims is None:
                    v[c] = v[c] * keep + gsq * add
                else:
                    d1, d0 = dims
                    vr[c] = vr[c] * keep + gsq.mean(d0) * add
                    vc[c] = vc[c] * keep + gsq.mean(d1) * add
                del gsq
                u = self._scaled(g[c].float(), dims, vr[c], vc[c], v[c])
                sumsq += torch.linalg.vector_norm(u).square()
                del u
            n = p.numel()
            clip = torch.clamp(sumsq.div(n).sqrt() / self.clipping_threshold,
                               min=1.0)
            rms = _vector_norm(p) / n ** 0.5
            step = rms.clamp(min=self.min_scale) * -lr / clip
            for c in chunks:                 # apply
                u = self._scaled(g[c].float(), dims, vr[c], vc[c], v[c])
                if region is None:
                    p[c].addcmul_(u, step)
                elif c == slice(None):       # this rank's part of u
                    p.to_local().addcmul_(u[region], step)
                else:                        # rows c, held whole here
                    p.to_local()[c].addcmul_(
                        u[(slice(None),) + region[1:]], step)
                del u
            for t, full in zip(state, whole):   # keep this rank's part
                if is_dtensor(t):
                    t.to_local().copy_(full[_region(t)])
            grads[i] = g = None
        return dict(opt_state, count=count + 1), norm


def make_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                   total_steps: int = 10_000, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0, mu_dtype="bfloat16",
                   kind: str = "adamw"):
    """The JAX package's optimizer: AdamW (`kind="adamw"`) or, for
    `kind="adafactor"`, optax.adafactor's defaults on the same schedule
    (weight_decay, b1, b2, grad_clip and mu_dtype apply to AdamW only)."""
    if kind == "adafactor":
        return Adafactor(learning_rate, warmup_steps, total_steps)
    if kind != "adamw":
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return AdamW(learning_rate, warmup_steps, total_steps, weight_decay,
                 b1, b2, grad_clip, mu_dtype)


class CompiledTrainStep:
    """The train step for one model, on one device or a mesh (eager; see
    the module docstring).  `rules` maps logical axes to mesh axes
    (default `sharding.DEFAULT_RULES`); `donate_state=False` leaves the
    state passed in untouched (the step updates copies), `True` lets the
    step update its tensors in place."""

    def __init__(self, cfg: transformer.TransformerConfig, mesh=None,
                 optimizer=None, rules: Optional[Rules] = None,
                 donate_state: bool = True,
                 device: DeviceLike = None) -> None:
        transformer._check_supported(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules if rules is not None else DEFAULT_RULES
        self.optimizer = optimizer or make_optimizer()
        self.donate_state = donate_state
        self.sharded = not mesh_trivial(mesh)
        if device is None and mesh is not None:
            device = ("cpu" if mesh.device_type == "cpu" else
                      torch.device(mesh.device_type,
                                   torch.cuda.current_device()))
        self.device = resolve_device(device)
        if self.sharded:
            self.param_placements = tree_specs(
                transformer.logical_axes(cfg), self.rules, mesh)
            self.data_placements = spec_for(("batch", None), self.rules,
                                            mesh)

    # -- public API --------------------------------------------------------
    def init_state(self, seed: int = 0,
                   params: Optional[Dict[str, Any]] = None) -> TrainState:
        """Fresh state: random parameters from `seed` (a torch.Generator;
        see transformer.init_params), or the given ones moved to this
        step's device, with zeroed optimizer moments.  On a mesh every
        rank makes the whole tensors and keeps its part, so every mesh
        starts from the parameters of `mesh=None`."""
        if params is None:
            params = transformer.init_params(self.cfg, seed, self.device)
        else:
            params = _map(lambda p: p.detach().to(
                self.device, self.cfg.param_dtype).clone(), params)
        if self.sharded:
            params = _zip_map(lambda p, pl: _place(p, self.mesh, pl),
                              params, self.param_placements)
        for p in _leaves(params):
            p.requires_grad_(True)
        opt_state = self.optimizer.init(params)
        if self.sharded:
            opt_state = self._place_state(opt_state, params)
        return TrainState(0, params, opt_state)

    def _place_state(self, opt_state, params):
        """JAX's `_state_shardings`: a tree that mirrors the parameters
        (same keys, same shapes) takes their placements, any other tensor
        is replicated; counts stay Python ints."""
        from torch.distributed.tensor import Replicate
        shapes = [p.shape for p in _leaves(params)]
        replicated = [Replicate()] * self.mesh.ndim

        def place(t, pl):
            return t if is_dtensor(t) else _place(t, self.mesh, pl)

        out = {}
        for key, node in opt_state.items():
            if not isinstance(node, dict):
                out[key] = node
            elif [t.shape for t in _leaves(node)] == shapes:
                out[key] = _zip_map(place, node, self.param_placements)
            else:
                out[key] = _map(lambda t: place(t, replicated), node)
        return out

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
        """Tokens [B, S+1] as an int64 tensor on this step's device; on a
        mesh, a DTensor split on the batch axis only (each rank keeps its
        rows of the whole batch it is given).  A tensor already on the
        device passes through without a host round trip, as
        `jax.device_put` does."""
        if isinstance(tokens, torch.Tensor):
            if is_dtensor(tokens):
                return tokens
            tokens = tokens.to(self.device, torch.int64)
        else:
            tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                     device=self.device)
        if not self.sharded:
            return tokens
        return _place(tokens, self.mesh, self.data_placements)

    def __call__(self, state: TrainState, tokens: torch.Tensor
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not self.donate_state:
            state = _copy_state(state)
        leaves = _leaves(state.params)
        with torch.enable_grad():
            loss, metrics = transformer.loss_fn(state.params, tokens,
                                                self.cfg, self.mesh)
            grads = list(torch.autograd.grad(loss, leaves))
        if self.sharded:      # summed parts -> the parameters' placements
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        opt_state, grad_norm = self.optimizer.update_(
            grads, state.opt_state, state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, state.params, opt_state), metrics


def _zip_map(fn, tree, other):
    """fn over the leaves of two trees of the same keys."""
    return {k: (_zip_map(fn, v, other[k]) if isinstance(v, dict)
                else fn(v, other[k])) for k, v in tree.items()}


def _copy_state(state: TrainState) -> TrainState:
    """A copy of `state` that the step can update in place."""
    params = _map(lambda p: p.detach().clone().requires_grad_(True),
                  state.params)
    opt_state = {k: (_map(lambda t: t.clone(), v) if isinstance(v, dict)
                     else v) for k, v in state.opt_state.items()}
    return TrainState(state.step, params, opt_state)

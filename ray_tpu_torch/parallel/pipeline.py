"""Pipeline parallelism over the `pp` mesh axis: GPipe.

Counterpart of `ray_tpu/parallel/pipeline.py`.  JAX keeps the schedule
inside one SPMD program (`shard_map` over pp, activations hop stages with
`ppermute`, and `jax.grad` derives the reverse pipeline).  The port runs
the same GPipe schedule eagerly on each rank, in `_GPipe`, an autograd
Function:

* forward: rank j of the pp axis holds stage j's layers only.  It runs
  its microbatches in order: stage 0 takes microbatch m from the input,
  every later stage receives it from stage j - 1, and every stage but the
  last sends its output on to stage j + 1 (point-to-point, one tensor a
  microbatch).  Each microbatch's stage graph is built under
  `enable_grad` and kept.  The last stage's outputs are made whole on
  every pp rank by an all-reduce over pp of outputs that are zero on the
  other stages (JAX's psum of masked outputs).
* backward: the schedule in reverse.  The last stage takes its outputs'
  gradient from the all-reduced outputs' gradient, every other stage
  receives it from stage j + 1; each stage back-propagates microbatch m
  through its kept graph and sends the input's gradient to stage j - 1.

JAX runs every stage at every one of its M + pp - 1 ticks and discards
the bubble's results; here each stage runs exactly its M microbatches
and sends only what the next stage reads, with the same outputs and
gradients.  Microbatch rows split over dp and fsdp as JAX's `xspec` does
(each rank runs its rows of every microbatch, the data ranks' gradients
summed); other mesh axes are replicated.

Layer parameters come in two forms, leaf by leaf.  A DTensor split on
dim 0 over pp (and replicated on the other axes) is held stage-sharded,
as JAX's shard_map takes `P("pp")` params: each pp rank holds and uses
only its stage's layers, and the gradient comes back split the same way
(summed over dp and fsdp), so pp divides the layers' parameter and
gradient memory.  A plain tensor, the same on every rank, is the
convenience form: each rank cuts its stage from it, and its gradient
comes back whole, all-gathered over pp every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import transformer as tf
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import is_dtensor

DATA_AXES = ("dp", "fsdp")


def split_stages(layer_params, num_stages: int):
    """Reshape stacked layer params [L, ...] -> [num_stages, L/ps, ...]
    so the leading axis shards over `pp`."""
    def r(x):
        L = x.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers not divisible by "
                             f"{num_stages} stages")
        return x.reshape(num_stages, L // num_stages, *x.shape[1:])

    return tf._map_specs(r, layer_params)


def _apply_layers(stacked, x, layer_fn):
    """layer_fn over a dict of stacked [L, ...] tensors, layer by layer."""
    for p in tf._layers({"layers": stacked}):
        x = layer_fn(x, p)
    return x


class _Plan:
    """What a rank's `_GPipe` needs: its stage, its neighbours' global
    ranks, the pp group, the layer function and the leaf names."""

    def __init__(self, mesh, layer_fn, names, grad: bool) -> None:
        coord = list(mesh.get_coordinate())
        dim = list(mesh.mesh_dim_names).index("pp")
        self.pp = mesh.size(dim)
        self.stage = coord[dim]

        def rank_at(stage):
            at = list(coord)
            at[dim] = stage
            return int(mesh.mesh[tuple(at)])

        self.prv = rank_at(self.stage - 1) if self.stage > 0 else None
        self.nxt = rank_at(self.stage + 1) if self.stage < self.pp - 1 \
            else None
        self.group = mesh.get_group("pp")
        self.layer_fn, self.names, self.grad = layer_fn, names, grad


class _GPipe(torch.autograd.Function):
    """outs [M, rows, S, D] = this rank's microbatch rows through every
    stage (see the module docstring); `leaves` are this stage's layer
    tensors [L/pp, ...] in `plan.names` order."""

    @staticmethod
    def forward(ctx, plan: _Plan, xm, *leaves):
        import torch.distributed as dist
        M = xm.shape[0]
        outs = torch.zeros_like(xm)
        graphs = []
        with torch.set_grad_enabled(plan.grad):
            params = [t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
            stacked = dict(zip(plan.names, params))
            for m in range(M):
                if plan.prv is None:
                    inp = xm[m]
                else:
                    inp = torch.empty_like(xm[m])
                    dist.recv(inp, plan.prv)
                inp = inp.detach().requires_grad_(plan.grad)
                out = _apply_layers(stacked, inp, plan.layer_fn)
                if plan.nxt is None:
                    outs[m] = out.detach()
                else:
                    dist.send(out.detach().contiguous(), plan.nxt)
                if plan.grad:
                    graphs.append((inp, out))
        dist.all_reduce(outs, group=plan.group)
        ctx.plan, ctx.graphs, ctx.params = plan, graphs, params
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        import torch.distributed as dist
        plan, params = ctx.plan, ctx.params
        wanted = [p for p in params if p.requires_grad]
        g_x = torch.zeros_like(g_outs)
        g_params = [None] * len(wanted)
        for m in reversed(range(len(ctx.graphs))):
            inp, out = ctx.graphs[m]
            if plan.nxt is None:
                g = g_outs[m]
            else:
                g = torch.empty_like(out)
                dist.recv(g, plan.nxt)
            got = torch.autograd.grad(out, [inp] + wanted, g,
                                      allow_unused=True)
            ctx.graphs[m] = None
            if plan.prv is None:
                g_x[m] = got[0]
            else:
                dist.send(got[0].contiguous(), plan.prv)
            g_params = [a if b is None else b if a is None else a + b
                        for a, b in zip(g_params, got[1:])]
        it = iter(g_params)
        return (None, g_x, *[next(it) if p.requires_grad else None
                             for p in params])


def pipeline_apply(stage_params, x, mesh, layer_fn: Callable,
                   num_microbatches: int):
    """GPipe forward over the mesh's `pp` axis.

    stage_params: dict of [num_stages, layers_per_stage, ...] leaves (from
    split_stages), each a DTensor split on dim 0 over pp or a whole tensor
    (the module docstring).  x: [B, S, D] activations, the same on every
    rank.  layer_fn(x, p) applies ONE layer (p: a dict of that layer's
    tensors).  Returns [B, S, D] after all layers, whole on every rank.
    Differentiable: autograd runs the reverse schedule.  At pp == 1 every
    layer is applied in order (no microbatches)."""
    pp = mesh_axis_size(mesh, "pp")
    if pp == 1:
        return _apply_layers({k: v.reshape(-1, *v.shape[2:])
                              for k, v in stage_params.items()}, x,
                             layer_fn)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, D = x.shape
    M = num_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    names = list(mesh.mesh_dim_names)
    data = [i for i, a in enumerate(names) if a in DATA_AXES]
    pdim = names.index("pp")
    whole = [Replicate()] * mesh.ndim

    def placements(on_pp, on_data, other=Replicate()):
        return [on_pp if i == pdim else on_data if i in data else other
                for i in range(mesh.ndim)]

    # This rank's rows of each microbatch (split over dp and fsdp, outer
    # axis first); the input's gradient is summed over pp (stage 0 alone
    # reads it) and gathered over the data axes.
    xm = DTensor.from_local(x.reshape(M, B // M, S, D), mesh, whole,
                            run_check=False).redistribute(
        mesh, placements(Replicate(), Shard(1))).to_local(
        grad_placements=placements(Partial(), Shard(1)))
    held = placements(Shard(0), Replicate())

    def stage_leaf(name, t):
        """This stage's [L/pp, ...] layers of leaf `t`; the gradient is
        summed over the data axes and comes back placed as `t`."""
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        elif t.device_mesh != mesh or list(t.placements) != held:
            raise ValueError(f"stage param {name!r} is placed "
                             f"{tuple(t.placements)} on {t.device_mesh}; "
                             f"pipeline_apply takes whole tensors or "
                             f"DTensors placed {tuple(held)} on its mesh")
        return t.redistribute(mesh, held).to_local(
            grad_placements=placements(Shard(0), Partial()))[0]

    keys = sorted(stage_params)
    leaves = [stage_leaf(k, stage_params[k]) for k in keys]
    grad = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in leaves))
    outs = _GPipe.apply(_Plan(mesh, layer_fn, keys, grad), xm, *leaves)
    out = DTensor.from_local(outs, mesh, placements(Replicate(), Shard(1)),
                             run_check=False, shape=(M, B // M, S, D),
                             stride=(B // M * S * D, S * D, D, 1))
    return out.full_tensor().reshape(B, S, D)


def pipeline_forward_hidden(params: Dict[str, Any], tokens, cfg, mesh,
                            num_microbatches: int = 4):
    """Transformer forward_hidden with the layer stack pipelined over
    `pp` (embedding and final norm replicated on all stages).  The layer
    leaves `params["layers"]` [L, ...] may be DTensors split on dim 0
    over pp: each rank then holds only its stage's layers."""
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["tok_embed"]).to(cfg.dtype)
    # [1, S]: broadcasts against any microbatch size inside the stages.
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    if cfg.arch == "gpt2":
        x = x + params["pos_embed"][:S][None].to(cfg.dtype)

    pp = mesh_axis_size(mesh, "pp")
    stage_params = split_stages(params["layers"], pp)

    def layer_fn(h, p):
        h, _aux = tf._layer_body(cfg, None, h, p, positions)
        return h

    x = pipeline_apply(stage_params, x, mesh, layer_fn, num_microbatches)
    rms = cfg.arch == "llama"
    return tf._norm(x, params["final_norm"], params.get("final_norm_b"),
                    cfg.norm_eps, rms)


def pipeline_loss_fn(params, tokens, cfg, mesh, num_microbatches: int = 4):
    """Pipelined next-token loss; gradients flow through the schedule."""
    targets = tokens[:, 1:]
    x = pipeline_forward_hidden(params, tokens[:, :-1], cfg, mesh,
                                num_microbatches)
    return tf.fused_cross_entropy(x, tf._w_out(params, cfg), targets, cfg)

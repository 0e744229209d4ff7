"""Ring attention: sequence parallelism over the `sp` mesh axis.

Counterpart of `ray_tpu/ops/ring_attention.py`.  Every rank of the sp
axis holds a [B, H, S/n, D] shard of q, k and v.  Step 0 attends the
local shard causally (the diagonal block); then n - 1 steps rotate k and
v to rank + 1 and attend the incoming shard non-causally, a future
shard's partial nulled by setting its lse to NEG_INF (every rank runs
the same steps, as JAX's SPMD program does).  Each step gives a
normalised partial (o, lse); the partials merge by the logsumexp rule,
in f32, in JAX's order of operations.

Partials are routed by device (`impl`, as `attention_with_lse`): B1
through `flash_attention_with_lse` on CUDA tensors, which raises on a
shard it cannot tile, and `attention_reference_with_lse` on CPU tensors
(as JAX off the TPU) or with impl "reference".  Their backward runs B2
and B3 with the dlse that `_merge` hands each partial.

The rotation is the body's one seam (`rotate`).  On a mesh it is
`_RingShift`, an autograd Function over the sp group: isend to rank + 1
and irecv from rank - 1 in one `batch_isend_irecv`; its backward sends
the gradients the other way (JAX's transpose of ppermute).  The body
issues the next step's rotation before the current step's partial
attention, so the transfer can overlap it.  `_virtual_ring` runs every
rank of a ring in one process, handing virtual rank r the shard
(r - t) mod n at step t: the CPU tests and `chip_smoke.py` drive the
body that way on one device.

Remat: the port has no name tags, so JAX's `save_residuals=False` on the
partials has no counterpart argument.  Under remat the transformer runs
the whole ring inside one non-reentrant `torch.utils.checkpoint`
(`models/transformer.py` `_attention`), which keeps q, k and v and
recomputes the partials in the backward: what JAX gets from
`save_residuals=False` under its "names" and "dots" policies.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from ray_tpu_torch.ops.attention import (NEG_INF, _route,
                                         attention_reference_with_lse,
                                         flash_attention_with_lse)
from ray_tpu_torch.parallel.sharding import is_dtensor


def _partial_attn(q, k, v, scale, causal, impl: str = "auto"):
    """(o, lse) for one kv shard, routed by device as `attention_with_lse`
    routes: the flash kernels for CUDA tensors (which raise on a shape
    they cannot tile), the reference for CPU tensors (as JAX off the
    TPU) or when `impl` is "reference"."""
    if _route(q, impl) == "flash":
        return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)
    return attention_reference_with_lse(q, k, v, causal=causal, scale=scale)


def _merge(o_a, lse_a, o_b, lse_b):
    """Combine two normalised partial attentions (logsumexp weights)."""
    lse = torch.maximum(lse_a, lse_b)
    # Guard -inf - -inf (a fully masked pair) => weight 0.
    w_a = torch.exp(torch.where(lse_a == NEG_INF, NEG_INF, lse_a - lse))
    w_b = torch.exp(torch.where(lse_b == NEG_INF, NEG_INF, lse_b - lse))
    norm = w_a + w_b
    norm = torch.where(norm == 0.0, 1.0, norm)
    o = (o_a.float() * w_a[..., None]
         + o_b.float() * w_b[..., None]) / norm[..., None]
    return o.to(o_a.dtype), lse + torch.log(norm)


# rotate(t, k, v) starts moving this rank's current shard (k, v) one rank
# on and returns a function that waits and gives the shard of step t.
Rotate = Callable[[int, torch.Tensor, torch.Tensor], Callable[[], tuple]]


def _ring_attention_sharded(q, k, v, *, n: int, rank: int, rotate: Rotate,
                            causal: bool, scale: float, impl: str = "auto"):
    """Per-shard body: q, k, v [B, H, S/n, D] of ring rank `rank` of n."""
    pending = rotate(1, k, v) if n > 1 else None
    # Step 0: the diagonal block, statically causal.
    o_run, lse_run = _partial_attn(q, k, v, scale, causal, impl)
    o_run = o_run.float()
    for t in range(1, n):
        # After t rotations this rank holds the shard of rank (rank - t).
        k_t, v_t = pending()
        if t + 1 < n:
            pending = rotate(t + 1, k_t, v_t)
        src = (rank - t) % n
        o_p, lse_p = _partial_attn(q, k_t, v_t, scale, False, impl)
        if causal and src > rank:
            # A future shard: computed, then nulled by lse = -inf.
            lse_p = torch.full_like(lse_p, NEG_INF)
        o_run, lse_run = _merge(o_run, lse_run, o_p, lse_p)
    return o_run.to(q.dtype)


class _RingShift(torch.autograd.Function):
    """(k, v) of sp rank - 1: sends (k, v) to rank + 1 and receives from
    rank - 1 without waiting: `pending` gets the requests and the buffers
    they use, and the caller waits on them before it reads the outputs.
    The backward sends the gradients to rank - 1 and receives from
    rank + 1."""

    @staticmethod
    def forward(ctx, k, v, nxt: int, prv: int, group, pending: dict):
        import torch.distributed as dist
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        k, v = k.contiguous(), v.contiguous()
        rk, rv = torch.empty_like(k), torch.empty_like(v)
        pending["works"] = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, k, nxt, group),
            dist.P2POp(dist.isend, v, nxt, group),
            dist.P2POp(dist.irecv, rk, prv, group),
            dist.P2POp(dist.irecv, rv, prv, group)])
        pending["sent"] = (k, v)
        return rk, rv

    @staticmethod
    def backward(ctx, gk, gv):
        import torch.distributed as dist
        gk, gv = gk.contiguous(), gv.contiguous()
        rk, rv = torch.empty_like(gk), torch.empty_like(gv)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, gk, ctx.prv, ctx.group),
                dist.P2POp(dist.isend, gv, ctx.prv, ctx.group),
                dist.P2POp(dist.irecv, rk, ctx.nxt, ctx.group),
                dist.P2POp(dist.irecv, rv, ctx.nxt, ctx.group)]):
            work.wait()
        return rk, rv, None, None, None, None


def _group_rotate(group, n: int, rank: int) -> Rotate:
    """The rotation over a process group of n ranks (`rank` is this
    rank's index in it)."""
    import torch.distributed as dist
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)

    def rotate(t, k, v):
        pending: dict = {}
        rk, rv = _RingShift.apply(k, v, nxt, prv, group, pending)

        def wait():
            for work in pending.pop("works"):
                work.wait()
            return rk, rv

        return wait

    return rotate


def _virtual_ring(q, k, v, n: int, causal: bool = True,
                  scale: Optional[float] = None, impl: str = "auto"):
    """All n ranks of a ring in one process, on whole [B, H, S, D]
    tensors: the sequence cut into n shards, rank r's body run with a
    rotation that hands it shard (r - t) mod n at step t, the ranks'
    outputs concatenated.  Autograd reaches q, k and v as on the ring:
    each shard's gradient sums every rank's use of it."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (t.chunk(n, 2) for t in (q, k, v))

    def rotate_for(r):
        def rotate(t, k_, v_):
            src = (r - t) % n
            return lambda: (ks[src], vs[src])
        return rotate

    return torch.cat([_ring_attention_sharded(
        qs[r], ks[r], vs[r], n=n, rank=r, rotate=rotate_for(r),
        causal=causal, scale=scale, impl=impl) for r in range(n)], 2)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, impl: str = "auto"):
    """Sequence-parallel attention over `axis_name` of `mesh`.

    q, k, v: [B, H, S, D] DTensors whose S dim is split over `axis_name`
    (other mesh dims may split batch and heads), or whole tensors, the
    same on every rank, which each rank cuts to its shard (their
    gradients come back whole).  `impl` routes the partials as
    `attention_with_lse`'s does.  Each rank runs the per-shard body on its
    local shards (`local_map`) over the axis's process group.  Returns
    the [B, H, S, D] output as a DTensor placed as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = list(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh {tuple(names)} has no {axis_name!r} axis")
    dim = names.index(axis_name)
    n = mesh.size(dim)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"ring attention needs sequence lengths divisible "
                         f"by {axis_name}={n}: sq={q.shape[2]}, "
                         f"sk={k.shape[2]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    spec = [Replicate()] * mesh.ndim
    spec[dim] = Shard(2)

    def placed(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False).redistribute(mesh, spec)
        if t.placements[dim] != Shard(2):
            raise ValueError(f"ring attention takes tensors split on the "
                             f"sequence (dim 2) over {axis_name!r}, got "
                             f"{t.placements}")
        return t

    q, k, v = placed(q), placed(k), placed(v)
    rank = mesh.get_local_rank(axis_name)
    body = functools.partial(
        _ring_attention_sharded, n=n, rank=rank,
        rotate=_group_rotate(mesh.get_group(axis_name), n, rank),
        causal=causal, scale=scale, impl=impl)
    return local_map(body, out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)

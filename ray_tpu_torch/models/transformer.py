"""Decoder-only transformer family (Llama-style and GPT-2-style), PyTorch.

Counterpart of `ray_tpu/models/transformer.py`.  Parameters keep the
JAX pytree's layout and key names — a plain dict, per-layer weights
stacked on axis 0 under "layers" (`wq [L,d,h,dh]`, `wo [L,h,dh,d]`, ...)
— so one set of weights means the same thing in both packages
(`models/convert.py` moves them across).  Parameters are f32; compute
runs in `cfg.dtype` with f32 norms, softmax and logits, as in the JAX
package.

Ported: the config, presets, init, the helpers the serving path uses
(`_norm`, `_rope`, `_w_out`), and the training forward for llama and
gpt2, dense or MoE, on one device: `_moe_block`, `_layer_body`,
`forward_hidden_aux`, `forward_hidden`, `forward`, `fused_cross_entropy`,
`loss_fn` and `logical_axes`.  Every layer reaches the flash kernels
through `ops.attention.attention_with_lse` (`cfg.attn_impl`).

Meshes.  `mesh=None` or a mesh of one device runs the one-device path
(no DTensor).  On a larger mesh (dp, fsdp, tp) the parameters are
DTensors placed by the sharding rules and tokens are split on the batch
axis (`train_step.CompiledTrainStep.shard_batch`): each parameter is
gathered over the mesh axes that split the batch (FSDP's all-gather; its
gradient comes back reduce-scattered), the layers run as DTensor ops with
tp-split heads and MLP columns (DTensor inserts the Megatron all-reduces
at the constraints JAX's model sets), attention runs on each rank's local
batch rows and heads through `local_map` (exact when tp divides
n_kv_heads), and the embedding gather and cross-entropy run on each
rank's tokens against the whole table, their sums reduced over the mesh
axes that split the tokens.

An sp axis splits the sequence: the token ids and their global positions
are constrained to ("batch", "seq") before the embedding, so every
activation is split on the sequence as in JAX, RoPE rotates each rank's
shard by its global positions, attention runs `ops.ring_attention`
(under remat inside one non-reentrant checkpoint, so the ring's partials
are recomputed and only q, k, v and its output are kept), and the
cross-entropy takes each rank's sequence chunk of the hidden states and
targets as they are (no gather), its sums reduced over batch and sp.

MoE on a mesh (`_moe_block_sharded`) keeps JAX's global routing: the
capacity comes from the global token count, and every pair's slot from
the experts chosen for every token, gathered over the ranks that hold
tokens in global order t = b * S + s, so the pairs kept and dropped are
those of one device.  Each rank dispatches its own tokens into the
[E, cap, D] expert inputs; these are summed over the token-holding ranks
onto the ranks that own each expert ("expert" -> ep: a local slice, then
an all-reduce of E / ep experts' rows), the expert products run on local
experts only, and the outputs are gathered over ep for each rank's
combine.  A pp axis is replicated (no rule maps to it); the pipeline is
`parallel/pipeline.py`.

MoE.  `_moe_block` computes JAX's GShard-style block (top-k routing in
f32, renormalised gates, a fixed capacity per expert, pairs past it
dropped) with index-based dispatch instead of JAX's dense [T, E, cap]
one-hot einsums: each kept (token, choice) pair gets a flat slot
`expert * cap + position`, each expert's [cap, D] input is gathered by
slot, the experts run as batched products, and each token sums its
kept slots' outputs times its gates.  Dropped pairs are masked out:
dispatched into a spare row that is cut off, combined with weight 0.
Same function, no [T, E, cap] tensor.

Remat.  `cfg.remat` checkpoints each layer with `torch.utils.checkpoint`
by policy: "names" and "dots" checkpoint the two halves around the
attention call — (norm, qkv, rope) and (wo, residual, norm, MLP) — and
leave the attention Function outside, so its own residuals (q, k, v, o,
lse) are kept and the flash forward is never re-run in the backward pass
(a ctypes launch is invisible to selective checkpointing).  "dots" also
keeps the outputs of products without a batch dimension (JAX's
`dots_with_no_batch_dims_saveable`: the einsums lower to `bmm` with a
batch of 1), so MoE's batched expert products are recomputed, as in
JAX; "names" recomputes every product.
"nothing" checkpoints the whole layer and re-runs everything, the flash
forward included, as JAX's `nothing_saveable` does.  Policies change
memory and FLOPs, never values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import attention_with_lse
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.mesh import mesh_sizes
from ray_tpu_torch.parallel.sharding import (constrain, is_dtensor,
                                             mesh_trivial, spec_for, use_mesh)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None      # None => MHA
    d_ff: Optional[int] = None            # None => arch default
    max_seq: int = 2048
    arch: str = "llama"                   # "llama" | "gpt2"
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "dots"            # dots | nothing
    attn_impl: str = "auto"               # auto | flash | reference
    attn_block_q: int = 512
    attn_block_k: int = 512
    xent_chunk: Optional[int] = 1024
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.arch == "llama":
            return ((int(self.d_model * 8 / 3) + 127) // 128) * 128
        return 4 * self.d_model


PRESETS: Dict[str, TransformerConfig] = {
    "tiny": TransformerConfig(vocab_size=512, d_model=128, n_layers=2,
                              n_heads=4, max_seq=256, remat=False),
    "gpt2-small": TransformerConfig(vocab_size=50_304, d_model=768,
                                    n_layers=12, n_heads=12, arch="gpt2",
                                    max_seq=1024, rope_theta=0.0),
    "llama-1b": TransformerConfig(vocab_size=128_256, d_model=2048,
                                  n_layers=16, n_heads=32, n_kv_heads=8,
                                  d_ff=8192, max_seq=8192),
    "llama-8b": TransformerConfig(vocab_size=128_256, d_model=4096,
                                  n_layers=32, n_heads=32, n_kv_heads=8,
                                  d_ff=14_336, max_seq=8192),
    "mixtral-8x7b": TransformerConfig(vocab_size=32_000, d_model=4096,
                                      n_layers=32, n_heads=32,
                                      n_kv_heads=8, d_ff=14_336,
                                      max_seq=8192, moe_experts=8,
                                      moe_top_k=2),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter layout: a dict (same keys and nesting as the JAX
    pytree) of `(shape, init)` leaves, init being "ones", "zeros" or a
    float normal-std.  Per-layer shapes carry the leading [L] axis."""
    d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.ff_dim)
    L = cfg.n_layers
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(d) / math.sqrt(2 * L)
    layer: Dict[str, Tuple[tuple, Any]] = {
        "attn_norm": ((d,), "ones"),
        "wq": ((d, h, dh), scale_in),
        "wk": ((d, hkv, dh), scale_in),
        "wv": ((d, hkv, dh), scale_in),
        "wo": ((h, dh, d), scale_out),
        "mlp_norm": ((d,), "ones"),
        "w_down": ((f, d), scale_out),
    }
    if cfg.moe_experts > 0:
        E = cfg.moe_experts
        layer["w_router"] = ((d, E), scale_in)
        layer["w_gate"] = ((E, d, f), scale_in)
        layer["w_up"] = ((E, d, f), scale_in)
        layer["w_down"] = ((E, f, d), scale_out)
        if cfg.arch == "gpt2":
            layer["attn_norm_b"] = ((d,), "zeros")
            layer["mlp_norm_b"] = ((d,), "zeros")
    elif cfg.arch == "llama":
        layer["w_gate"] = ((d, f), scale_in)
        layer["w_up"] = ((d, f), scale_in)
    else:
        layer["w_up"] = ((d, f), scale_in)
        layer["b_up"] = ((f,), "zeros")
        layer["b_down"] = ((d,), "zeros")
        layer["attn_norm_b"] = ((d,), "zeros")
        layer["mlp_norm_b"] = ((d,), "zeros")
    specs: Dict[str, Any] = {
        "tok_embed": ((cfg.vocab_size, d), 1.0),
        "layers": {k: ((L,) + shape, init)
                   for k, (shape, init) in layer.items()},
        "final_norm": ((d,), "ones"),
    }
    if cfg.arch == "gpt2":
        specs["pos_embed"] = ((cfg.max_seq, d), 0.01)
        specs["final_norm_b"] = ((d,), "zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, cfg.vocab_size), scale_in)
    return specs


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters made on `device` from a `torch.Generator`
    seeded with `seed` (the numbers differ from `jax.random`'s; tests
    that compare packages convert JAX weights with convert.py)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(spec):
        shape, init = spec
        if init == "ones":
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(init).to(cfg.param_dtype)

    return _map_specs(make, param_specs(cfg))


def _map_specs(fn, specs):
    return {k: (_map_specs(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in specs.items()}


def logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Tree (matching init_params) of logical axis-name tuples."""
    layer = {
        "attn_norm": ("embed",),
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "mlp_norm": ("embed",),
        "w_down": ("mlp", "embed"),
    }
    if cfg.moe_experts > 0:
        layer["w_router"] = ("embed", None)
        layer["w_gate"] = ("expert", "embed", "mlp")
        layer["w_up"] = ("expert", "embed", "mlp")
        layer["w_down"] = ("expert", "mlp", "embed")
        if cfg.arch == "gpt2":
            layer["attn_norm_b"] = ("embed",)
            layer["mlp_norm_b"] = ("embed",)
    elif cfg.arch == "llama":
        layer["w_gate"] = ("embed", "mlp")
        layer["w_up"] = ("embed", "mlp")
    else:
        layer["w_up"] = ("embed", "mlp")
        layer["b_up"] = ("mlp",)
        layer["b_down"] = ("embed",)
        layer["attn_norm_b"] = ("embed",)
        layer["mlp_norm_b"] = ("embed",)
    # stacked layer axis is the scan ("layers") axis
    layer = {k: ("layers",) + v for k, v in layer.items()}
    axes: Dict[str, Any] = {
        "tok_embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("embed",),
    }
    if cfg.arch == "gpt2":
        axes["pos_embed"] = (None, "embed")
        axes["final_norm_b"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# helpers shared with decoding
# ---------------------------------------------------------------------------
def _norm(x, w, b, eps, rms: bool):
    xf = x.float()
    if rms:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _rope(x, positions, theta):
    """x: [B, S, H, Dh]; rotary embedding over the head dim (split
    halves, frequencies exp(-log(theta) * i / half))."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    if is_dtensor(positions):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = positions.device_mesh
        freqs = DTensor.from_local(freqs, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    angles = positions[..., None].float() * freqs          # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _w_out(params, cfg: TransformerConfig):
    return (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])


class _MatmulF32Out(torch.autograd.Function):
    """bf16 [M, K] @ [K, N] on the card with f32 accumulation and an f32
    output (cuBLAS via `torch.mm(out_dtype=)`, which has no autograd
    formula).  The backward multiplies in bf16 with f32 accumulation and
    returns gradients in the operands' dtype, as JAX casts its f32
    transposed products back to bf16; the f32 cotangent is rounded to
    bf16 first, one of the places where bf16 rounds differently in the
    two packages."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.t() if ctx.needs_input_grad[0] else None
        gb = a.t() @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def _matmul_f32(a, b):
    """[M, K] @ [K, N] -> f32: operands in their dtype, f32 accumulation
    and output (JAX's `preferred_element_type=jnp.float32`).  bf16 on the
    card goes through `_MatmulF32Out`; elsewhere the operands are widened
    (exact for bf16) and multiplied in f32."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return _MatmulF32Out.apply(a, b)
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------
def _check_supported(cfg: TransformerConfig, mesh) -> None:
    """Raise for a mesh whose head split does not divide n_kv_heads:
    local attention would pair a rank's query heads with another rank's
    kv heads."""
    if mesh_trivial(mesh):
        return
    split = math.prod(mesh.size(i) for i, p in enumerate(
        spec_for(("batch", "kv_heads", "seq", None), mesh=mesh))
        if getattr(p, "dim", None) == 1)
    if cfg.kv_heads % split:
        raise ValueError(
            f"the mesh splits heads {split} ways, which does not divide "
            f"n_kv_heads={cfg.kv_heads}: local attention would pair query "
            "heads with another rank's kv heads")


def _batch_dims(t) -> frozenset:
    """Mesh dimensions on which DTensor `t` is split along its dim 0."""
    return frozenset(i for i, p in enumerate(t.placements)
                     if getattr(p, "dim", None) == 0)


def _split_dims(t) -> frozenset:
    """Mesh dimensions on which DTensor `t` is split (any tensor dim): for
    tokens [B, S], the ranks that hold different tokens."""
    return frozenset(i for i, p in enumerate(t.placements) if p.is_shard())


def _gathered(w, batch_dims):
    """The whole of DTensor `w` as a plain tensor on every rank, for a
    computation on the rank's batch rows: its gradient is a part to sum
    over `batch_dims` and the same on the other mesh dimensions."""
    from torch.distributed.tensor import Partial, Replicate
    n = w.device_mesh.ndim
    full = w.redistribute(w.device_mesh, [Replicate()] * n)
    return full.to_local(grad_placements=[
        Partial() if i in batch_dims else Replicate() for i in range(n)])


def _compute_layout(params, batch_dims):
    """Each DTensor parameter gathered over the mesh dimensions that split
    the batch (FSDP's all-gather before use), its other placements kept."""
    from torch.distributed.tensor import Replicate

    def one(w):
        pl = [Replicate() if i in batch_dims else p
              for i, p in enumerate(w.placements)]
        return w.redistribute(w.device_mesh, pl)

    return {k: ({kk: one(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else one(v))
            for k, v in params.items()}


def _moe_gates(cfg: TransformerConfig, ht, w_router):
    """ht: [T, D] -> (probs [T, E] f32, gates [T, K] f32 renormalised to
    sum 1, experts [T, K])."""
    probs = torch.softmax(ht.float() @ w_router.float(), dim=-1)
    gates, experts = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True), experts


def _moe_capacity(cfg: TransformerConfig, n_tokens: int) -> int:
    return int(math.ceil(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor
                         / cfg.moe_experts))


def _moe_slots(experts, E: int, cap: int):
    """experts [T, K] -> slots [T, K].  Slots are assigned choice by
    choice, j = 0 first, tokens in order: the pairs of choice j fill each
    expert after the pairs kept for earlier choices.  A pair's slot is
    `expert * cap + position`, or `E * cap` (the spare row) when position
    >= cap: the pair is dropped and its token's other gates are not
    renormalised."""
    filled = torch.zeros(E, dtype=torch.int64, device=experts.device)
    slots = []
    for j in range(experts.shape[1]):
        # [E, T]: the running count scans each expert's row (a scan over
        # the first axis of [T, E] parallelises over E columns only).
        onehot = F.one_hot(experts[:, j], E).t().contiguous()
        pos = (onehot.cumsum(1) - onehot + filled[:, None]).gather(
            0, experts[None, :, j])[0]
        keep = pos < cap
        slots.append(torch.where(keep, experts[:, j] * cap + pos, E * cap))
        filled = filled + (onehot * keep).sum(1)
    return torch.stack(slots, 1)


def _moe_route(cfg: TransformerConfig, ht, w_router):
    """Routing of `_moe_block` on one device.  ht: [T, D] -> (probs,
    gates, experts, slots [T, K], cap); see `_moe_gates`, `_moe_slots`."""
    probs, gates, experts = _moe_gates(cfg, ht, w_router)
    cap = _moe_capacity(cfg, ht.shape[0])
    return probs, gates, experts, _moe_slots(experts, cfg.moe_experts,
                                             cap), cap


def _moe_dispatch(ht, slots, n):
    """Each kept pair's token row into its slot: [n, D] expert inputs.
    Dropped pairs all write the spare row n, which is cut off."""
    xin = ht.new_zeros(n + 1, ht.shape[1])
    for j in range(slots.shape[1]):
        xin = xin.index_put((slots[:, j],), ht)
    return xin[:n]


def _moe_combine(out_e, gates, slots, dtype):
    """Each token's sum of gate x its kept slots' outputs: gates rounded
    to `dtype` (JAX's combine.astype), products summed in f32, cast to
    `dtype`.  A dropped pair reads slot n - 1 with weight 0."""
    n = out_e.shape[0]
    w = gates.to(dtype).float() * (slots < n)
    idx = slots.clamp(max=n - 1)
    out = sum(w[:, j, None] * out_e[idx[:, j]].float()
              for j in range(slots.shape[1]))
    return out.to(dtype)


def _moe_block(cfg: TransformerConfig, h, p):
    """MoE FFN.  h: [B, S, D] (normed) -> (out [B, S, D], aux
    load-balancing loss, f32 scalar).  The experts compute
    silu(x W_gate) * (x W_up) then W_down, for every arch.  A DTensor h
    (a mesh of more than one device) takes `_moe_block_sharded`."""
    if is_dtensor(h):
        return _moe_block_sharded(cfg, h, p)
    B, S, D = h.shape
    E = cfg.moe_experts
    ht = h.reshape(B * S, D)
    probs, gates, experts, slots, cap = _moe_route(cfg, ht, p["w_router"])
    xin = _moe_dispatch(ht, slots, E * cap).view(E, cap, D)
    gate = torch.bmm(xin, p["w_gate"].to(cfg.dtype))
    up = torch.bmm(xin, p["w_up"].to(cfg.dtype))
    act = F.silu(gate.float()).to(cfg.dtype) * up
    out_e = torch.bmm(act, p["w_down"].to(cfg.dtype)).view(E * cap, D)
    out = _moe_combine(out_e, gates, slots, cfg.dtype)
    # Load balance (Switch/GShard): E * sum_e frac_tokens * mean_probs,
    # frac_tokens from the top-1 choice (no gradient through it).
    frac_tokens = F.one_hot(experts[:, 0], E).float().mean(0)
    aux = E * (frac_tokens * probs.mean(0)).sum()
    return out.reshape(B, S, D), aux


def _moe_routing_sharded(cfg: TransformerConfig, h, w_router):
    """Routing of this rank's tokens of a token-split DTensor h [B, S, D]
    as one device routes the whole batch: (ht [T_local, D], probs, gates,
    experts, slots [T_local, K], cap).  The [T_local, K] expert choices
    are gathered over the token-holding ranks in global order b * S + s
    (a few ints a token), the slots assigned on the whole list, and this
    rank's rows kept."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = h.device_mesh, h.placements
    B, S, D = h.shape
    hl = h.to_local()
    b, s = hl.shape[:2]
    ht = hl.reshape(b * s, D)
    probs, gates, experts = _moe_gates(
        cfg, ht, _gathered(w_router, _split_dims(h)))
    cap = _moe_capacity(cfg, B * S)
    K = experts.shape[1]
    every = DTensor.from_local(experts.reshape(b, s, K), mesh, pl,
                               run_check=False, shape=(B, S, K),
                               stride=(S * K, K, 1)).full_tensor()
    slots = _moe_slots(every.reshape(B * S, K), cfg.moe_experts, cap)
    mine = DTensor.from_local(slots.reshape(B, S, K), mesh,
                              [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, pl)
    return ht, probs, gates, experts, mine.to_local().reshape(b * s, K), cap


def _moe_block_sharded(cfg: TransformerConfig, h, p):
    """`_moe_block` of a token-split DTensor h on a mesh (see the module
    docstring): global routing, the expert inputs summed over the
    token-holding ranks onto each expert's owners, local expert products,
    outputs gathered over ep for each rank's combine; the aux loss from
    the global means."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = h.device_mesh
    E, (B, S, D) = cfg.moe_experts, h.shape
    tok = _split_dims(h)
    ht, probs, gates, experts, slots, cap = _moe_routing_sharded(
        cfg, h, p["w_router"])
    summed = [Partial() if i in tok else Replicate()
              for i in range(mesh.ndim)]
    xin = DTensor.from_local(_moe_dispatch(ht, slots, E * cap).view(
        E, cap, D), mesh, summed, run_check=False)
    owners = spec_for(("expert", None, None), mesh=mesh)
    # This rank's experts first (a slice, no traffic), then their sum over
    # the token-holding ranks.
    xin = xin.redistribute(mesh, [
        o if o.is_shard() and i not in tok else pl
        for i, (o, pl) in enumerate(zip(owners, summed))])
    xin = xin.redistribute(mesh, owners)
    gate = torch.bmm(xin, p["w_gate"].to(cfg.dtype))
    up = torch.bmm(xin, p["w_up"].to(cfg.dtype))
    act = constrain(F.silu(gate.float()).to(cfg.dtype) * up,
                    ("expert", None, "mlp"), mesh=mesh)
    out_e = _gathered(torch.bmm(act, p["w_down"].to(cfg.dtype)), tok)
    out = _moe_combine(out_e.reshape(E * cap, D), gates, slots, cfg.dtype)
    out = DTensor.from_local(out.reshape(h.to_local().shape), mesh,
                             h.placements, run_check=False)
    # The global means of the top-1 share and the router probabilities.
    local = torch.stack([F.one_hot(experts[:, 0], E).float().sum(0),
                         probs.sum(0)])
    means = DTensor.from_local(local, mesh, summed,
                               run_check=False).full_tensor() / (B * S)
    return out, E * (means[0] * means[1]).sum()


def _attn_in(cfg: TransformerConfig, x, p, positions):
    """Norm, q/k/v projections and rope: x [B,S,D] -> q, k, v [B,H,S,Dh]."""
    rms = cfg.arch == "llama"
    h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps, rms)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    if cfg.arch == "llama":
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    return (constrain(q.transpose(1, 2), ("batch", "heads", "seq", None)),
            constrain(k.transpose(1, 2), ("batch", "kv_heads", "seq", None)),
            constrain(v.transpose(1, 2), ("batch", "kv_heads", "seq", None)))


def _local_attention(cfg: TransformerConfig, q, k, v):
    # lse is a residual of the flash backward only; its cotangent is None.
    o, _ = attention_with_lse(q, k, v, causal=True, impl=cfg.attn_impl,
                              block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    return o


def _attention(cfg: TransformerConfig, q, k, v, remat: bool = False):
    """Causal attention; DTensor q, k, v run on each rank's batch rows and
    heads (kernel or plain, by `cfg.attn_impl`) through `local_map`, or,
    split on the sequence over sp, as ring attention (inside a
    non-reentrant checkpoint when `remat`: the ring's partials are
    recomputed in the backward, JAX's `save_residuals=False`)."""
    if not is_dtensor(q):
        return _local_attention(cfg, q, k, v)
    mesh = q.device_mesh
    if mesh_sizes(mesh).get("sp", 1) > 1:
        ring = functools.partial(ring_attention, mesh=mesh, axis_name="sp",
                                 causal=True, impl=cfg.attn_impl)
        if remat:
            return checkpoint(ring, q, k, v, use_reentrant=False)
        return ring(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    pq = spec_for(("batch", "heads", "seq", None), mesh=mesh)
    pk = spec_for(("batch", "kv_heads", "seq", None), mesh=mesh)
    return local_map(functools.partial(_local_attention, cfg),
                     out_placements=(pq,), in_placements=(pq, pk, pk),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _attn_out_mlp(cfg: TransformerConfig, x, o, p):
    """wo, residual, norm, MLP or MoE, residual: -> (x [B,S,D], aux)."""
    o = o.transpose(1, 2)                                  # [B,S,H,Dh]
    x = x + constrain(torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype)),
                      ("batch", "seq", "embed"))
    rms = cfg.arch == "llama"
    h = _norm(x, p["mlp_norm"], p.get("mlp_norm_b"), cfg.norm_eps, rms)
    if cfg.moe_experts > 0:
        out, aux = _moe_block(cfg, h, p)
        return x + out, aux
    if cfg.arch == "llama":
        gate = h @ p["w_gate"].to(h.dtype)
        up = h @ p["w_up"].to(h.dtype)
        act = F.silu(gate.float()).to(h.dtype) * up
    else:
        up = h @ p["w_up"].to(h.dtype) + p["b_up"].to(h.dtype)
        act = F.gelu(up.float(), approximate="tanh").to(h.dtype)
    act = constrain(act, ("batch", "seq", "mlp"))
    down = act @ p["w_down"].to(act.dtype)
    if cfg.arch == "gpt2":
        down = down + p["b_down"].to(down.dtype)
    return (x + constrain(down, ("batch", "seq", "embed")),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _layer_body(cfg: TransformerConfig, mesh, x, p, positions):
    """One decoder layer, no remat. x: [B, S, D] -> (x, MoE aux or 0)."""
    _check_supported(cfg, mesh)
    q, k, v = _attn_in(cfg, x, p, positions)
    return _attn_out_mlp(cfg, x, _attention(cfg, q, k, v), p)


_MATMUL_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
               torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the outputs of
    matrix products without a batch dimension (a `bmm` of batch 1 is an
    einsum's), recompute the rest, MoE's batched expert products too."""
    from torch.utils.checkpoint import CheckpointPolicy
    save = op in _MATMUL_OPS and (op is not torch.ops.aten.bmm.default
                                  or args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if save
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(cfg: TransformerConfig, x, p, positions):
    policy = cfg.remat_policy
    if policy == "nothing":
        return checkpoint(lambda x_: _layer_body(cfg, None, x_, p,
                                                 positions),
                          x, use_reentrant=False)
    if policy not in ("names", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    kw = {"use_reentrant": False}
    if policy == "dots":
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    q, k, v = checkpoint(functools.partial(_attn_in, cfg), x, p, positions,
                         **kw)
    o = _attention(cfg, q, k, v, remat=True)
    return checkpoint(functools.partial(_attn_out_mlp, cfg), x, o, p, **kw)


def _layers(params) -> list:
    """Per-layer parameter dicts.  One `unbind` per stacked tensor, so
    the backward stacks each weight's per-layer gradients once."""
    names = list(params["layers"])
    return [dict(zip(names, ts)) for ts in
            zip(*(params["layers"][n].unbind(0) for n in names))]


def _sharded_tokens(tokens, mesh):
    """Tokens as a DTensor split on the batch axis (`CompiledTrainStep.
    shard_batch` gives them so; a whole tensor is split here)."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(tokens):
        return tokens
    return distribute_tensor(tokens, mesh, spec_for(("batch", None),
                                                    mesh=mesh))


def _sharded_embed(params, tokens, cfg: TransformerConfig):
    """Embeddings and global positions of a batch-split DTensor of tokens,
    both constrained to ("batch", "seq") (split on the sequence over sp:
    rank r's positions start at its shard's offset): each rank gathers
    its tokens' rows from the whole table."""
    from torch.distributed.tensor import DTensor
    mesh = tokens.device_mesh
    positions = DTensor.from_local(torch.arange(
        tokens.shape[1], dtype=torch.int32,
        device=tokens.device).expand(tokens.to_local().shape), mesh,
        tokens.placements, run_check=False)
    tokens, positions = (constrain(t, ("batch", "seq"), mesh=mesh)
                         for t in (tokens, positions))
    table = _gathered(params["tok_embed"], _split_dims(tokens))
    x = DTensor.from_local(F.embedding(tokens.to_local().long(), table).to(
        cfg.dtype), mesh, tokens.placements, run_check=False)
    return x, positions


def forward_hidden_aux(params: Dict[str, Any], tokens: torch.Tensor,
                       cfg: TransformerConfig, mesh=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] int -> (final-norm hidden [B, S, D], MoE aux loss
    summed over the layers in f32 — zero for dense models).  On a mesh
    of more than one device `params` are DTensors (see the module
    docstring) and the hidden states a batch-split DTensor."""
    _check_supported(cfg, mesh)
    if not mesh_trivial(mesh):
        with use_mesh(mesh):
            tokens = _sharded_tokens(tokens, mesh)
            params = _compute_layout(params, _batch_dims(tokens))
            return _hidden(params, cfg, mesh,
                           *_sharded_embed(params, tokens, cfg))
    x = F.embedding(tokens.long(), params["tok_embed"]).to(cfg.dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device).expand(tokens.shape)
    return _hidden(params, cfg, mesh, x, positions)


def _hidden(params, cfg: TransformerConfig, mesh, x, positions):
    """`forward_hidden_aux` from the token embeddings x [B, S, D] on."""
    S = x.shape[1]
    if cfg.arch == "gpt2":
        x = x + params["pos_embed"][:S][None].to(cfg.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(params):
        if cfg.remat:
            x, a = _remat_layer(cfg, x, p, positions)
        else:
            x, a = _layer_body(cfg, mesh, x, p, positions)
        aux = aux + a
    rms = cfg.arch == "llama"
    return _norm(x, params["final_norm"], params.get("final_norm_b"),
                 cfg.norm_eps, rms), aux


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens: [B, S] int -> final-norm hidden states [B, S, D]."""
    return forward_hidden_aux(params, tokens, cfg, mesh)[0]


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens: [B, S] int -> logits [B, S, vocab] (f32; operands in
    cfg.dtype, f32 accumulation)."""
    x = forward_hidden(params, tokens, cfg, mesh)
    B, S, D = x.shape
    logits = _matmul_f32(x.reshape(B * S, D).to(cfg.dtype),
                         _w_out(params, cfg).to(cfg.dtype))
    return logits.reshape(B, S, -1)


def _xent_chunk(xc, tc, wd):
    """Summed next-token nll of one chunk; targets < 0 are padding."""
    logits = _matmul_f32(xc, wd)                           # [chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, tc.clamp(min=0)[:, None].long())[:, 0]
    return torch.where(tc >= 0, lse - tgt, 0.0).sum()


def _xent_sum(x, w_out, targets, cfg: TransformerConfig) -> torch.Tensor:
    """The summed nll of `fused_cross_entropy`, before the division."""
    B, S, D = x.shape
    N = B * S
    chunk = min(cfg.xent_chunk or N, N)
    xf = x.reshape(N, D)
    tf = targets.reshape(N)
    n = -(-N // chunk)
    pad = n * chunk - N
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        tf = F.pad(tf, (0, pad), value=-1)
    wd = w_out.to(cfg.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_xent_chunk, xf[sl], tf[sl], wd,
                                   use_reentrant=False)
    return total


def _sharded_cross_entropy(x, w_out, targets, cfg: TransformerConfig):
    """`fused_cross_entropy` of token-split DTensors: the targets are
    constrained to ("batch", "seq") like the hidden states, each rank's
    tokens go against the whole output matrix, and the sums are added over
    the mesh axes that split the tokens (a Partial DTensor made whole)
    and divided by the global count.  Sequence shards stay where they
    are: no rank gathers another's hidden states."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = targets.device_mesh
    targets = constrain(targets, ("batch", "seq"), mesh=mesh)
    dims = _split_dims(targets)
    local = _xent_sum(x.redistribute(mesh, targets.placements).to_local(),
                      _gathered(w_out, dims), targets.to_local(), cfg)
    total = DTensor.from_local(local, mesh, [
        Partial() if i in dims else Replicate() for i in range(mesh.ndim)],
        run_check=False).full_tensor()
    return total / targets.numel()


def fused_cross_entropy(x: torch.Tensor, w_out: torch.Tensor,
                        targets: torch.Tensor,
                        cfg: TransformerConfig) -> torch.Tensor:
    """Chunked softmax cross-entropy that never builds the [B, S, V]
    logits: one [chunk, V] f32 block at a time, recomputed in the backward
    pass (`torch.utils.checkpoint` per chunk), so peak memory is one
    block.  Targets are padded with -1 to whole chunks; the sum is
    divided by the true token count."""
    if is_dtensor(targets):
        return _sharded_cross_entropy(x, w_out, targets, cfg)
    return _xent_sum(x, w_out, targets, cfg) / targets.numel()


def loss_fn(params, tokens, cfg: TransformerConfig, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy, plus `moe_aux_weight` x the MoE
    load-balancing loss for MoE models.  tokens: [B, S]; predicts
    tokens[:,1:].  Returns (loss, {"loss", "ppl"} and, for MoE,
    {"moe_aux", "total_loss"}); "loss" is the cross-entropy alone.  On a
    mesh of more than one device the loss is a plain tensor, the same on
    every rank, always from the chunked cross-entropy (one chunk for
    `xent_chunk=None`)."""
    _check_supported(cfg, mesh)
    if not mesh_trivial(mesh):
        tokens = _sharded_tokens(tokens, mesh)
    targets = tokens[:, 1:]
    x, aux = forward_hidden_aux(params, tokens[:, :-1], cfg, mesh)
    if cfg.xent_chunk is None and not is_dtensor(targets):
        B, S, D = x.shape
        logits = _matmul_f32(x.reshape(B * S, D).to(cfg.dtype),
                             _w_out(params, cfg).to(cfg.dtype))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, targets.reshape(-1, 1).long())[:, 0]
        loss = nll.mean()
    else:
        loss = fused_cross_entropy(x, _w_out(params, cfg), targets, cfg)
    metrics = {"loss": loss, "ppl": torch.exp(loss)}
    if cfg.moe_experts > 0:
        metrics["moe_aux"] = aux
        loss = loss + cfg.moe_aux_weight * aux
        metrics["total_loss"] = loss
    return loss, metrics


def num_params(params) -> int:
    return sum(num_params(v) if isinstance(v, dict) else int(v.numel())
               for v in params.values())

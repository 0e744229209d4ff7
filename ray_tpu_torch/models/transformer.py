"""Decoder-only transformer family (Llama-style and GPT-2-style), PyTorch.

Counterpart of `ray_tpu/models/transformer.py`.  Parameters keep the
JAX pytree's layout and key names — a plain dict, per-layer weights
stacked on axis 0 under "layers" (`wq [L,d,h,dh]`, `wo [L,h,dh,d]`, ...)
— so one set of weights means the same thing in both packages
(`models/convert.py` moves them across).  Parameters are f32; compute
runs in `cfg.dtype` with f32 norms, softmax and logits, as in the JAX
package.

Ported so far: the config, presets, init, and the helpers the serving
path uses (`_norm`, `_rope`, `_w_out`).  `forward` / `loss_fn` come with
the training slice, which needs the flash-attention kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device


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
    angles = positions[..., None].float() * freqs          # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _w_out(params, cfg: TransformerConfig):
    return (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])


def num_params(params) -> int:
    return sum(num_params(v) if isinstance(v, dict) else int(v.numel())
               for v in params.values())

"""Weight-only int8 quantization for serving, PyTorch.

Counterpart of `ray_tpu/models/quantize.py`.  llama-8b's bf16 weights
take 16 GB; int8 with per-output-channel scales halves that, and the
serving engine keeps the int8 tree resident on the card.

`QuantizedArray` holds int8 `q` and an f32 scale `s` of the same rank
with size 1 on the contracted axes, so `q * s` broadcasts to the
dequantized tensor.  It offers the accesses the decode path makes of a
weight, with the JAX package's semantics:

  * `.to(dtype)` and `.float()` (JAX's `astype`): dequantize — an f32
    multiply, then the cast.  The decode path calls it on every layer
    matrix at every use and on the output projection, so each use
    dequantizes, as in JAX (where XLA fuses it into the matmul's operand
    read; a fused dequant-matmul kernel is later speed work);
  * `[idx]`: gather, then dequantize, in f32 (embedding lookups);
  * `.T`: the transpose of `q` and `s` (the tied `lm_head`);
  * `.layer(i)`: layer `i` of a stacked weight, still int8 — what JAX's
    `lax.scan` does when it slices `q` and `s` together.

Scales sit on the non-contracted (output) axes and keep the stacked
layer axis.  `init_quantized_params` draws random int8 directly on the
device (no f32 stage), so an 8B engine stands up without the 32 GB f32
tree.  `serving_memory_report` is shape arithmetic: it allocates nothing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, param_specs


class QuantizedArray:
    """int8 tensor + f32 per-output-channel scale, in place of a weight."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        self.q, self.s = q, s

    # -- the accesses model code makes ------------------------------------
    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize: f32 multiply, then cast."""
        if not isinstance(dtype, torch.dtype):
            raise TypeError("QuantizedArray.to takes a dtype (it "
                            f"dequantizes); got {dtype!r}")
        return (self.q.float() * self.s).to(dtype)

    def float(self) -> torch.Tensor:
        return self.to(torch.float32)

    def __getitem__(self, idx) -> torch.Tensor:
        """Gather-then-dequantize (embedding lookups): a plain f32 tensor
        that callers cast like any other weight."""
        return self.q[idx].float() * self.s[idx]

    @property
    def T(self) -> "QuantizedArray":
        axes = tuple(range(self.q.ndim - 1, -1, -1))
        return QuantizedArray(self.q.permute(axes), self.s.permute(axes))

    def layer(self, i: int) -> "QuantizedArray":
        """Index the leading (stacked-layer) axis of q and s together."""
        return QuantizedArray(self.q[i], self.s[i])

    # -- introspection ------------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def size(self) -> int:
        """Element count (JAX's `size`)."""
        return self.q.numel()

    def numel(self) -> int:
        return self.q.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    def nbytes_total(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.s.numel() * self.s.element_size())

    def __repr__(self) -> str:
        return (f"QuantizedArray(q={tuple(self.q.shape)}, "
                f"s={tuple(self.s.shape)})")


def quantize(w: torch.Tensor, contract_axes: Tuple[int, ...]
             ) -> QuantizedArray:
    """Symmetric per-output-channel int8: scale = absmax / 127 over the
    contracted axes (never the stacked layer axis), q = round(w / s)
    (half to even, as `jnp.round`) clipped to [-127, 127]."""
    wf = w.float()
    absmax = wf.abs().amax(dim=contract_axes, keepdim=True)
    s = absmax.clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantizedArray(q, s)


# Per-weight contracted axes, EXCLUDING the leading stacked-layer axis
# (offset below).  Matches the einsums in transformer.py / decoding.py:
# e.g. wq [d,h,dh] contracts d; wo [h,dh,d] contracts h,dh.
_LAYER_CONTRACT = {
    "wq": (0,), "wk": (0,), "wv": (0,),
    "wo": (0, 1),
    "w_gate": (0,), "w_up": (0,),
    "w_down": (0,),
}
# MoE variants carry a leading expert axis [E, ...]:
_MOE_CONTRACT = {"w_gate": (1,), "w_up": (1,), "w_down": (1,)}


def quantize_params(params: Dict[str, Any], cfg: TransformerConfig
                    ) -> Dict[str, Any]:
    """Quantize a full-precision parameter tree for serving: matmul
    weights (attention and MLP projections, embeddings, lm_head) become
    QuantizedArray; norms, biases and the router stay as they are."""
    moe = cfg.moe_experts > 0
    layers = dict(params["layers"])
    for name in _LAYER_CONTRACT:
        if name not in layers:
            continue
        axes = (_MOE_CONTRACT[name] if moe and name in _MOE_CONTRACT
                else _LAYER_CONTRACT[name])
        # +1: the stacked [L, ...] layer axis keeps its own scales.
        layers[name] = quantize(layers[name], tuple(a + 1 for a in axes))
    out = dict(params, layers=layers)
    # tok_embed [V, D]: per-row (vocab) scales — right for the gather
    # and, transposed, per output channel for the tied lm_head.
    out["tok_embed"] = quantize(params["tok_embed"], (1,))
    if "lm_head" in params:          # [D, V] contracts D
        out["lm_head"] = quantize(params["lm_head"], (0,))
    return out


def _quantized_layout(cfg: TransformerConfig) -> Dict[str, Any]:
    """The tree `init_quantized_params` builds, as leaves
    ("q", shape, contract_axes, dequantized std) for QuantizedArray and
    (shape, init) as in `param_specs` for the rest."""
    if cfg.moe_experts > 0:
        raise NotImplementedError("quantized serving is dense-only")
    d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.ff_dim)
    L = cfg.n_layers
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(d) / math.sqrt(2 * L)
    layer: Dict[str, Any] = {
        "attn_norm": ((L, d), "ones"),
        "wq": ("q", (L, d, h, dh), (1,), scale_in),
        "wk": ("q", (L, d, hkv, dh), (1,), scale_in),
        "wv": ("q", (L, d, hkv, dh), (1,), scale_in),
        "wo": ("q", (L, h, dh, d), (1, 2), scale_out),
        "mlp_norm": ((L, d), "ones"),
        "w_down": ("q", (L, f, d), (1,), scale_out),
    }
    if cfg.arch == "llama":
        layer["w_gate"] = ("q", (L, d, f), (1,), scale_in)
        layer["w_up"] = ("q", (L, d, f), (1,), scale_in)
    else:
        layer["w_up"] = ("q", (L, d, f), (1,), scale_in)
        layer["b_up"] = ((L, f), "zeros")
        layer["b_down"] = ((L, d), "zeros")
        layer["attn_norm_b"] = ((L, d), "zeros")
        layer["mlp_norm_b"] = ((L, d), "zeros")
    out: Dict[str, Any] = {
        "tok_embed": ("q", (cfg.vocab_size, d), (1,), 1.0),
        "layers": layer,
        "final_norm": ((d,), "ones"),
    }
    if cfg.arch == "gpt2":
        out["pos_embed"] = ((cfg.max_seq, d), 0.01)
        out["final_norm_b"] = ((d,), "zeros")
    if not cfg.tie_embeddings:
        out["lm_head"] = ("q", (d, cfg.vocab_size), (0,), scale_in)
    return out


def _scale_shape(shape, contract_axes) -> Tuple[int, ...]:
    return tuple(1 if i in contract_axes else n for i, n in enumerate(shape))


def init_quantized_params(cfg: TransformerConfig, seed: int = 0,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """Random int8-quantized parameters drawn directly on `device` from a
    `torch.Generator` seeded with `seed`, with no f32 stage: q uniform in
    [-127, 127], s chosen so the dequantized std matches the init's
    (uniform / 127 has std ~0.58).  MoE shapes raise (dense only)."""
    layout = _quantized_layout(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(spec):
        if spec[0] == "q":
            _, shape, axes, std = spec
            q = torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8, device=dev)
            s = torch.full(_scale_shape(shape, axes), std / 0.58 / 127.0,
                           dtype=torch.float32, device=dev)
            return QuantizedArray(q, s)
        shape, init = spec
        if init in ("ones", "zeros"):
            return getattr(torch, init)(shape, dtype=cfg.param_dtype,
                                        device=dev)
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * init).to(cfg.param_dtype)

    return _map_layout(make, layout)


def _map_layout(fn, layout):
    return {k: (_map_layout(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in layout.items()}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def param_bytes(params) -> int:
    """Total bytes of a parameter tree (q + s for QuantizedArray)."""
    total = 0
    for v in params.values():
        if isinstance(v, dict):
            total += param_bytes(v)
        elif isinstance(v, QuantizedArray):
            total += v.nbytes_total()
        else:
            total += v.numel() * v.element_size()
    return total


def kv_cache_bytes(cfg: TransformerConfig, num_slots: int,
                   max_len: int) -> int:
    return (2 * cfg.n_layers * num_slots * max_len * cfg.kv_heads
            * cfg.head_dim * _itemsize(cfg.dtype))


def serving_memory_report(cfg: TransformerConfig, num_slots: int,
                          max_len: int,
                          quantized: bool = True) -> Dict[str, Any]:
    """Shape-only memory budget of a serving config (allocates nothing):
    the int8 tree of `init_quantized_params`, or the full-precision tree
    cast to `cfg.dtype` once, plus the KV cache."""
    if quantized:
        def nbytes(spec):
            if spec[0] == "q":
                _, shape, axes, _ = spec
                return math.prod(shape) + 4 * math.prod(
                    _scale_shape(shape, axes))
            return math.prod(spec[0]) * _itemsize(cfg.param_dtype)
        sizes = _map_layout(nbytes, _quantized_layout(cfg))
    else:
        sizes = _map_layout(
            lambda spec: math.prod(spec[0]) * _itemsize(cfg.dtype),
            param_specs(cfg))
    pb = _tree_sum(sizes)
    kb = kv_cache_bytes(cfg, num_slots, max_len)
    return {"param_gb": round(pb / 2**30, 2),
            "kv_cache_gb": round(kb / 2**30, 2),
            "total_gb": round((pb + kb) / 2**30, 2),
            "quantized": quantized,
            "num_slots": num_slots, "max_len": max_len}


def _tree_sum(tree) -> int:
    return sum(_tree_sum(v) if isinstance(v, dict) else v
               for v in tree.values())

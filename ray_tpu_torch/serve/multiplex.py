"""Model multiplexing: the parts the paged LLM engine needs.

Counterpart of `ray_tpu/serve/multiplex.py`: the request-scoped model id
(`get_multiplexed_model_id` / `_set_current_model_id`) and the adapter
merge (`merge_adapter`) the engine's hot-swap runs, in torch.  The
per-replica `_ModelCache` and the `serve.multiplexed` decorator belong
to the Serve runtime and wait for it (ROADMAP Queue A, A3).
"""

from __future__ import annotations

import contextvars

import torch

from ray_tpu_torch.models.quantize import QuantizedArray

_current_model_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "rtt_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller routed with."""
    return _current_model_id.get()


def _set_current_model_id(model_id: str):
    return _current_model_id.set(model_id)


def merge_adapter(base_params: dict, adapter: dict) -> dict:
    """Merge a LoRA adapter (or raw weight deltas) into a COPY of the
    base parameter dict; leaves the adapter does not touch are shared,
    and merged leaves keep the base shapes and dtypes.

    Adapter spec (plain dict; factors may be numpy arrays or tensors):

      {"lora":  {name: (A, B), ...},   # delta = scale * A @ B
       "delta": {name: D, ...},        # delta added verbatim
       "scale": float (default 1.0)}

    `name` resolves inside base_params["layers"] first (the stacked
    per-layer weights: A [L, d, r] @ B [L, r, k...]), then at the top
    level (A [d, r] @ B [r, k]).  Products are taken in f32 and reshaped
    to the target weight's shape, so a fused head like wq [L, d, H, Dh]
    takes a B of [L, r, H * Dh].
    """
    scale = float(adapter.get("scale", 1.0))
    layers = dict(base_params.get("layers", {}))
    top = {k: v for k, v in base_params.items() if k != "layers"}

    def _apply(tree: dict, name: str, delta: torch.Tensor) -> None:
        w = tree[name]
        if isinstance(w, QuantizedArray):
            raise TypeError(
                f"cannot merge an adapter into quantized weight {name!r}: "
                "merge into the full-precision weights, then quantize")
        tree[name] = w + delta.reshape(w.shape).to(w.device, w.dtype)

    def _f32(x, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x).to(like.device, torch.float32)

    for name, (a, b) in (adapter.get("lora") or {}).items():
        if name in layers:
            a, b = _f32(a, layers[name]), _f32(b, layers[name])
            if a.ndim != 3:
                raise ValueError(
                    f"lora factor for stacked layer weight {name!r} "
                    f"must be [L, d, r] (got {tuple(a.shape)})")
            d = torch.bmm(a, b.reshape(b.shape[0], b.shape[1], -1)) * scale
            _apply(layers, name, d)
        elif name in top:
            a, b = _f32(a, top[name]), _f32(b, top[name])
            d = (a @ b.reshape(b.shape[0], -1)) * scale
            _apply(top, name, d)
        else:
            raise KeyError(f"adapter weight {name!r} not in base params")
    # `scale` applies to the LoRA factorization only; raw deltas are
    # added verbatim.
    for name, d in (adapter.get("delta") or {}).items():
        if name in layers:
            _apply(layers, name, torch.as_tensor(d))
        elif name in top:
            _apply(top, name, torch.as_tensor(d))
        else:
            raise KeyError(f"adapter delta {name!r} not in base params")
    out = dict(top)
    if "layers" in base_params:
        out["layers"] = layers
    return out

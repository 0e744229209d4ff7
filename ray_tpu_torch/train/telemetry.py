"""The parts of `ray_tpu/train/telemetry.py` the training slice needs.

`transformer_flops_per_token` is a copy of the JAX package's formula;
`PEAK_FLOPS`/`peak_flops_for` are the MFU denominator for the cards the
port runs on, keyed by `torch.cuda.get_device_name`.  A card it does not
know raises: an MFU against a guessed peak would be a wrong number.
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak FLOP/s (NVIDIA data sheets, SXM parts, no
# sparsity).  Matched as a prefix of the device name.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,     # H100 SXM
}


def peak_flops_for(device_name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the named card (default: CUDA device 0).
    Raises for a card the table does not know."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    for name, peak in PEAK_FLOPS.items():
        if device_name.startswith(name):
            return peak
    raise KeyError(f"no peak FLOP/s known for {device_name!r}; add it to "
                   "ray_tpu_torch/train/telemetry.py PEAK_FLOPS from the "
                   "card's data sheet")


def transformer_flops_per_token(n_params: int, n_layers: int,
                                seq: int, d_model: int) -> float:
    """Model FLOPs per trained token: 6N + attention 12·L·s·d (PaLM
    appendix B) — the JAX package's formula."""
    return 6.0 * n_params + 12.0 * n_layers * seq * d_model

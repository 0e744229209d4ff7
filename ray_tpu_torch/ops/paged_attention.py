"""Ragged paged attention: decode-time attention over a paged KV cache.

Counterpart of `ray_tpu/ops/paged_attention.py`.  Two implementations
behind one dispatcher:

* `paged_attention_reference` — plain PyTorch, a copy of the JAX
  reference math (gather through the block table, f32 masked softmax,
  zeros for ctx == 0).  It runs on any device; the CPU tests hold it
  against the JAX kernel and reference.
* `paged_attention_kernel` — the hand-written CUDA kernel
  (`csrc/paged_attention.cu`, which replaces the Pallas `_paged_kernel`),
  built with nvcc on first use.  CUDA tensors only; it raises on a
  shape, dtype or layout the kernel does not take and never substitutes
  the reference.  `launches` counts its launches.

Shapes (decode: ONE query token per sequence):
  q:            [B, H, D]
  k_pool/v_pool [NB, bs, Hkv, D]   (one layer's pool)
  block_tables  [B, W] int32        (physical block per logical block)
  context_lens  [B]    int32        (valid positions, INCLUSIVE of the
                                     token scattered this step)
  -> out        [B, H, D]
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

# Launches of the CUDA kernel in this process (incremented only where
# the wrapper launches it).
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_MAX_BLOCK = 64
_lib: Optional[ctypes.CDLL] = None


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              block_tables: torch.Tensor,
                              context_lens: torch.Tensor,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Gather-based paged attention: the dense decode attention math
    (f32 scores, -inf beyond context_lens, softmax, f32 weighted sum)
    addressed through the block table."""
    B, H, D = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    W = block_tables.shape[1]
    M = W * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, M, hkv, D)                 # [B,M,Hkv,D]
    v = v_pool[bt].reshape(B, M, hkv, D)
    groups = H // hkv
    qg = q.reshape(B, hkv, groups, D)
    s = torch.einsum("bhgk,bmhk->bhgm", qg.float(),
                     k.float()).reshape(B, H, M) * scale
    mask = (torch.arange(M, device=q.device)[None, :]
            < context_lens[:, None])                     # [B, M]
    s = s.masked_fill(~mask[:, None, :], -math.inf)
    w = torch.softmax(s, dim=-1)
    # A zero-length row's softmax is all-NaN; the kernel's l == 0 guard
    # returns zeros there, and so does this.
    w = torch.where(mask[:, None, :], w, 0.0)
    wg = w.reshape(B, hkv, groups, M)
    o = torch.einsum("bhgm,bmhk->bhgk", wg, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens):
    tensors = (q, k_pool, v_pool, block_tables, context_lens)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(
            "paged_attention_kernel takes CUDA tensors only (got "
            f"{[str(t.device) for t in tensors]}); use "
            "impl='reference' for the plain version")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention_kernel: tensors on different "
                         "devices")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention_kernel: bad shapes q "
                         f"{tuple(q.shape)}, k_pool {tuple(k_pool.shape)},"
                         f" v_pool {tuple(v_pool.shape)}")
    B, H, D = q.shape
    _, bs, hkv, Dk = k_pool.shape
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention_kernel: dtypes q {q.dtype}, "
                         f"pools {k_pool.dtype}/{v_pool.dtype}; the kernel"
                         " takes float32 or bfloat16, all alike")
    if D not in _HEAD_DIMS or Dk != D:
        raise ValueError(f"paged_attention_kernel: head dim {D} (pool "
                         f"{Dk}); the kernel takes {_HEAD_DIMS}")
    if H % hkv or not 1 <= H // hkv <= _MAX_GROUP:
        raise ValueError(f"paged_attention_kernel: {H} query heads over "
                         f"{hkv} kv heads; groups of 1..{_MAX_GROUP}")
    if not 1 <= bs <= _MAX_BLOCK:
        raise ValueError(f"paged_attention_kernel: block size {bs}; the "
                         f"kernel takes 1..{_MAX_BLOCK}")
    if block_tables.dtype != torch.int32 or context_lens.dtype \
            != torch.int32:
        raise ValueError("paged_attention_kernel: block_tables and "
                         "context_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(context_lens.shape) != (B,):
        raise ValueError(
            f"paged_attention_kernel: block_tables "
            f"{tuple(block_tables.shape)} / context_lens "
            f"{tuple(context_lens.shape)} do not match batch {B}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_kernel: {name} must be "
                             "contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention_kernel: {name} must be "
                             "16-byte aligned")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ray_tpu_torch.ops import _build
        lib = _build.load("paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rtt_paged_attention.argtypes = [
            vp, vp, vp, vp, vp, vp,            # q k v tables lens out
            ci, ci, ci, ci, ci, ci,            # B Hkv G D bs W
            ctypes.c_float, ci, vp]            # scale dtype stream
        lib.rtt_paged_attention.restype = ci
        lib.rtt_cuda_error_string.argtypes = [ci]
        lib.rtt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel on PyTorch's current stream (no sync)."""
    global launches
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens)
    B, H, D = q.shape
    _, bs, hkv, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            out.data_ptr(), B, hkv, H // hkv, D, bs,
            block_tables.shape[1], scale, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed: CUDA error "
            f"{err} ({lib.rtt_cuda_error_string(err).decode()})")
    launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor,
                    scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Dispatcher.  "auto": the kernel for CUDA tensors, the plain
    version for CPU tensors; "kernel" / "reference" force one (the
    kernel still takes CUDA tensors only)."""
    if impl == "reference" or (impl == "auto" and q.device.type == "cpu"):
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         context_lens, scale)
    if impl in ("kernel", "auto"):
        return paged_attention_kernel(q, k_pool, v_pool, block_tables,
                                      context_lens, scale)
    raise ValueError(f"unknown paged attention impl {impl!r}")

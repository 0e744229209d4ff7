"""Ragged paged attention: decode-time attention over a paged KV cache.

Counterpart of `ray_tpu/ops/paged_attention.py`.  Two implementations
behind one dispatcher:

* `paged_attention_reference` — plain PyTorch, a copy of the JAX
  reference math (gather through the block table, f32 masked softmax,
  zeros for ctx == 0).  It runs on any device; the CPU tests hold it
  against the JAX kernel and reference.
* `paged_attention_split_reference` — plain PyTorch too: the arithmetic
  of the CUDA kernel, the context cut into the partitions of
  `split_plan`, per-partition partials (m, l, unnormalised acc) merged
  by the logsumexp rule.  The CPU tests hold it against the plain
  version and the JAX kernel.
* `paged_attention_kernel` — the hand-written CUDA kernel
  (`csrc/paged_attention.cu`, which replaces the Pallas `_paged_kernel`),
  built with nvcc on first use.  CUDA tensors only; it raises on a
  shape, dtype or layout the kernel does not take and never substitutes
  the reference.  `launches` counts its launches: one per call, whether
  the partition kernel ran alone (one partition) or with the merge
  kernel after it.

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
from typing import NamedTuple, Optional

import torch

from ray_tpu_torch.ops import _build

# Launches of the CUDA kernel in this process (incremented only where
# the wrapper launches it).
launches = 0

NEG_INF = -1e30                # the kernels' masked-score value

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_MAX_BLOCK = 64
# Tokens per partition of the CUDA kernel (a whole number of KV blocks,
# at most this many; the kernel's shared memory holds 64).
PART_TOKENS = 64
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


class SplitPlan(NamedTuple):
    part_blocks: int     # KV blocks per partition
    n_parts: int         # P, partitions per sequence


def split_plan(W: int, bs: int, part_tokens: int = PART_TOKENS
               ) -> SplitPlan:
    """How the kernel cuts a table of W blocks of bs tokens: partitions
    of `part_blocks` whole blocks (at most `part_tokens` tokens, at least
    one block), P = ceil(W / part_blocks).  Shapes only: nothing here
    depends on context_lens, so the host never waits on the device."""
    if W < 1 or bs < 1 or part_tokens < 1:
        raise ValueError(f"split_plan: W={W}, bs={bs}, part_tokens="
                         f"{part_tokens} must be positive")
    part_blocks = max(1, part_tokens // bs)
    return SplitPlan(part_blocks, -(-W // part_blocks))


def paged_attention_split_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    context_lens: torch.Tensor,
                                    scale: Optional[float] = None,
                                    part_tokens: int = PART_TOKENS
                                    ) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch (f32): each partition
    of `split_plan` gives (m, l, acc) over its valid positions (an empty
    one m = NEG_INF, l = 0), and the partitions merge by the logsumexp
    rule, skipping empty ones; l == 0 (ctx 0) normalises by 1."""
    B, H, D = q.shape
    bs, hkv = k_pool.shape[1], k_pool.shape[2]
    W = block_tables.shape[1]
    part_blocks, P = split_plan(W, bs, part_tokens)
    T = part_blocks * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bt = torch.zeros(B, P * part_blocks, dtype=torch.long,
                     device=q.device)
    bt[:, :W] = block_tables.long()                  # pad the last part
    k = k_pool[bt].reshape(B, P, T, hkv, D).float()
    v = v_pool[bt].reshape(B, P, T, hkv, D).float()
    groups = H // hkv
    qg = q.reshape(B, hkv, groups, D).float()
    s = torch.einsum("bhgd,bpthd->bhgpt", qg, k) * scale
    ctx = context_lens.long().clamp(0, W * bs)
    pos = torch.arange(P * T, device=q.device).reshape(P, T)
    valid = (pos[None] < ctx[:, None, None])[:, None, None]  # [B,1,1,P,T]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                   # [B,Hkv,G,P]
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgpt,bpthd->bhgpd", p, v)
    full = l > 0
    m_max = torch.where(full, m, NEG_INF).amax(-1, keepdim=True)
    w = torch.where(full, torch.exp(m - m_max), 0.0)
    l_sum = (w * l).sum(-1)
    o = (w[..., None] * acc).sum(-2)
    o = o / torch.where(l_sum == 0, 1.0, l_sum)[..., None]
    return o.reshape(B, H, D).to(q.dtype)


def _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens):
    tensors = (q, k_pool, v_pool, block_tables, context_lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            "paged_attention_kernel takes CUDA tensors only (got "
            f"{[str(t.device) for t in tensors]}); use "
            "impl='reference' for the plain version")
    if len({t.get_device() for t in tensors}) != 1:
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
        lib = _build.load("paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rtt_paged_attention.argtypes = [
            vp, vp, vp, vp, vp, vp,            # q k v tables lens out
            vp,                                # f32 partials (P > 1)
            ci, ci, ci, ci, ci, ci,            # B Hkv G D bs W
            ci, ci,                            # part_blocks P
            ctypes.c_float, ci, vp]            # scale dtype stream
        lib.rtt_paged_attention.restype = ci
        lib.rtt_paged_smem_bytes.argtypes = [ci, ci]
        lib.rtt_paged_smem_bytes.restype = ci
        lib.rtt_cuda_error_string.argtypes = [ci]
        lib.rtt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           context_lens: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel on PyTorch's current stream (no sync).  The
    partition count comes from the shapes (`split_plan`); context_lens is
    read only on the device."""
    global launches
    _check_kernel_inputs(q, k_pool, v_pool, block_tables, context_lens)
    B, H, D = q.shape
    _, bs, hkv, _ = k_pool.shape
    W = block_tables.shape[1]
    part_blocks, P = split_plan(W, bs)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _library()
    # f32 partials of the P > 1 path: m and l [B, H, P], acc [B, H, P, D];
    # the kernels write every entry the merge reads.
    partials = torch.empty(B * H * P * (D + 2), dtype=torch.float32,
                           device=q.device) if P > 1 else None
    dev = q.get_device()
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        err = lib.rtt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            out.data_ptr(), partials.data_ptr() if P > 1 else None, B, hkv,
            H // hkv, D, bs, W, part_blocks, P, scale,
            _DTYPE_CODES[q.dtype], stream)
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

"""Fused attention for training: flash forward/backward kernels + reference.

Counterpart of `ray_tpu/ops/attention.py`.  Public layout [B, H, S, D],
GQA when Hq > Hkv (q heads grouped `hkv x group`), causal masks aligned
bottom-right (`tril(k=sk-sq)`), masked scores `NEG_INF = -1e30`, softmax
and logsumexp in f32 — all as in the JAX package.

* Plain PyTorch: `attention_reference`, `attention_reference_with_lse`
  (autograd differentiates them) and `flash_attention_bwd_reference`, the
  flash backward written out (p rebuilt from lse, delta with dlse folded
  in, dk/dv summed over the GQA group).  They run on any device; the CPU
  tests hold them against the JAX package and `chip_smoke.py` holds the
  kernels against them on the card.
* Kernels (`csrc/flash_attention.cu`, replacing the Pallas kernels B1-B3):
  `flash_attention_fwd_kernel` and `flash_attention_bwd_kernel` take the
  flat layout [B*H, S, D] of the JAX `_flash_fwd`/`_flash_bwd`, CUDA
  tensors only, and raise on anything the kernels do not take; they never
  substitute the plain versions.  `launches` counts each kernel's launches.
* `FlashAttention`, the autograd Function of the JAX custom VJP
  `_flash_flat_with_lse`: forward (o, lse) saving (q, k, v, o, lse),
  backward from (dO, dlse).  On CUDA tensors it runs B1 and B2+B3 (and
  raises on what they do not take); on CPU tensors their plain versions,
  `_flash_fwd_reference` and `flash_attention_bwd_reference`.
* `flash_attention[_with_lse]` and the dispatchers `attention[_with_lse]`
  (`impl="auto" | "flash" | "reference"`).  "auto" chooses by device, as
  `ops/paged_attention.py` does: CUDA tensors go to the kernels, which
  raise on shapes, head dims (other than 64 and 128) and dtypes they do
  not take; CPU tensors go through the Function's plain path, so the CPU
  tests run the same Function, remat and custom backward as the card.
  "flash" takes CUDA tensors only; "reference" is autograd of
  `attention_reference_with_lse` on any device.

`block_q`/`block_k` keep their role in validation (`_pick_block`); the
CUDA tiles are the kernels' own, chosen for the H100 (64 to 192 rows;
the bf16 kernels are TMA + wgmma designs, see the source).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
NEG_INF = -1e30

# Launches of each CUDA kernel in this process (incremented only where a
# wrapper launches its kernel).
launches = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib: Optional[ctypes.CDLL] = None


# ---------------------------------------------------------------------------
# Reference implementation (any device; the numerics oracle)
# ---------------------------------------------------------------------------
def _scores(q, k, causal, scale):
    """f32 scores [B, Hkv, G, Sq, Sk], masked with NEG_INF."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D]; GQA when Hq > Hkv."""
    b, hq, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def attention_reference_with_lse(q, k, v, causal: bool = True,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (o [B,Hq,Sq,D], lse [B,Hq,Sq] f32); autograd handles
    gradients."""
    b, hq, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l[..., None]
    lse = m + torch.log(l)
    return (o.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq))


def _delta(o, do, dlse):
    """delta = rowsum(dO * O) - dlse, f32 [B*Hq, Sq] (dlse None = 0).
    `o` is promoted inside the product (exactly, as `.float()` would),
    which saves a pass over an f32 copy of it."""
    delta = (do.float() * o).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def _probs(q, k, lse, scale, causal):
    """p = exp(s - lse) in f32, [B*Hkv, G, Sq, Sk], from the flat inputs."""
    s = _scores(q[None], k[None], causal, scale)[0]
    return torch.exp(s - lse.float().reshape(s.shape[:3] + (1,)))


def _dscores(q, k, v, do, lse, delta, scale, causal):
    """(p, ds = p * (dp - delta) * scale), f32 [B*Hkv, G, Sq, Sk]."""
    bhq, sq, d = q.shape
    bhkv = k.shape[0]
    p = _probs(q, k, lse, scale, causal)
    dog = do.float().reshape(bhkv, bhq // bhkv, sq, d)
    dp = torch.einsum("hgqd,hkd->hgqk", dog, v.float())
    ds = p * (dp - delta.float().reshape(bhkv, bhq // bhkv, sq, 1)) * scale
    return p, ds


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale: float,
                             causal: bool):
    """Plain B2: (dk, dv) summed over the G query heads of each kv head,
    in k's and v's dtypes.  Flat layout, delta from `_delta`."""
    bhq, sq, d = q.shape
    bhkv = k.shape[0]
    p, ds = _dscores(q, k, v, do, lse, delta, scale, causal)
    g = bhq // bhkv
    dv = torch.einsum("hgqk,hgqd->hkd", p,
                      do.float().reshape(bhkv, g, sq, d))
    dk = torch.einsum("hgqk,hgqd->hkd", ds,
                      q.float().reshape(bhkv, g, sq, d))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale: float,
                           causal: bool):
    """Plain B3: dq in q's dtype.  Flat layout, delta from `_delta`."""
    _, ds = _dscores(q, k, v, do, lse, delta, scale, causal)
    dq = torch.einsum("hgqk,hkd->hgqd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, dlse, scale: float,
                                  causal: bool):
    """The flash backward (B2 + B3) written out in plain PyTorch, f32.

    Flat layout: q/o/do [B*Hq, Sq, D], k/v [B*Hkv, Sk, D], lse and dlse
    [B*Hq, Sq] (dlse may be None = zero).  p = exp(s - lse);
    delta = rowsum(dO * O) - dlse; ds = p * (dp - delta) * scale;
    dk/dv summed over the G query heads of each kv head.  Returns
    (dq, dk, dv) in q's, k's and v's dtypes."""
    delta = _delta(o, do, dlse)
    dk, dv = flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale,
                                      causal)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def _flash_fwd_reference(q, k, v, scale, causal):
    """Plain forward in the flat layout: (o [BHq,Sq,D], lse [BHq,Sq])."""
    o, lse = attention_reference_with_lse(q[None], k[None], v[None], causal,
                                          scale)
    return o[0], lse[0]


# ---------------------------------------------------------------------------
# CUDA kernels (B1, B2, B3)
# ---------------------------------------------------------------------------
def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rtt_flash_fwd.argtypes = [vp] * 5 + [ci] * 5 + [cf, ci, ci, vp]
        lib.rtt_flash_bwd_dkdv.argtypes = ([vp] * 8 + [ci] * 5
                                           + [cf, ci, ci, vp])
        lib.rtt_flash_bwd_dq.argtypes = ([vp] * 7 + [ci] * 5
                                         + [cf, ci, ci, vp])
        for fn in (lib.rtt_flash_fwd, lib.rtt_flash_bwd_dkdv,
                   lib.rtt_flash_bwd_dq):
            fn.restype = ci
        for fn in (lib.rtt_flash_fwd_smem_bytes,
                   lib.rtt_flash_bwd_smem_bytes):
            fn.argtypes = [ci, ci]
            fn.restype = ci
        lib.rtt_flash_error_string.argtypes = [ci]
        lib.rtt_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_flat(name, q, k, v, causal, extra=()):
    """Raise unless the flat tensors are what the kernels take."""
    tensors = (q, k, v) + tuple(x[1] for x in extra)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(
            f"{name} takes CUDA tensors only (got "
            f"{[str(t.device) for t in tensors]}); use impl='reference' "
            "for the plain version")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; the kernels "
                         "take [B*H, S, D]")
    bhq, sq, d = q.shape
    bhkv, sk, dk = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype}; the kernels take float32 or bfloat16,"
                         " all alike")
    if d not in _HEAD_DIMS or dk != d:
        raise ValueError(f"{name}: head dim {d} (k {dk}); the kernels take "
                         f"{_HEAD_DIMS}")
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"{name}: {bhq} query heads over {bhkv} kv heads")
    if sq % 128 or sk % 128 or sq == 0 or sk == 0:
        raise ValueError(f"{name}: seq lengths sq={sq}, sk={sk} must be "
                         "nonzero multiples of 128")
    if causal and sq > sk:
        raise ValueError(f"{name}: causal needs sq <= sk (sq={sq}, "
                         f"sk={sk})")
    for tname, t, shape, dtype in extra:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
    for tname, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (n, t) for n, t, _, _ in extra):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({_library().rtt_flash_error_string(err).decode()})")


def flash_attention_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float, causal: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 on PyTorch's current stream (no sync).  Flat layout; returns
    (o [BHq,Sq,D] in q's dtype, lse [BHq,Sq] f32)."""
    _check_flat("flash_attention_fwd_kernel", q, k, v, causal)
    bhq, sq, d = q.shape
    bhkv, sk = k.shape[0], k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty(bhq, sq, dtype=torch.float32, device=q.device)
    lib = _library()
    dev = q.get_device()
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bhq, bhq // bhkv, sq, sk, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return o, lse


def _bwd_checks(name, q, k, v, do, lse, delta, causal):
    bhq, sq, d = q.shape
    _check_flat(name, q, k, v, causal,
                [("do", do, (bhq, sq, d), q.dtype),
                 ("lse", lse, (bhq, sq), torch.float32),
                 ("delta", delta, (bhq, sq), torch.float32)])


def flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, scale: float,
                          causal: bool):
    """B2 on PyTorch's current stream (no sync): (dk, dv) summed over the
    GQA group, in k's dtype.  Flat layout, delta from `_delta`."""
    _bwd_checks("flash_bwd_dkdv_kernel", q, k, v, do, lse, delta, causal)
    bhq, sq, d = q.shape
    bhkv, sk = k.shape[0], k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library()
    dev = q.get_device()
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        err = lib.rtt_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bhkv, bhq // bhkv, sq, sk, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_bwd_dkdv")
    launches["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale: float,
                        causal: bool):
    """B3 on PyTorch's current stream (no sync): dq in q's dtype.  Flat
    layout, delta from `_delta`."""
    _bwd_checks("flash_bwd_dq_kernel", q, k, v, do, lse, delta, causal)
    bhq, sq, d = q.shape
    bhkv, sk = k.shape[0], k.shape[1]
    dq = torch.empty_like(q)
    lib = _library()
    dev = q.get_device()
    with _build.on_device(dev):
        stream = _build.raw_stream(dev)
        err = lib.rtt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bhq,
            bhq // bhkv, sq, sk, d, scale, int(causal),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_attention_bwd_kernel(q, k, v, o, lse, do, dlse, scale: float,
                               causal: bool):
    """B2 then B3 (no sync).  Flat layout; `dlse` may be None (zero).
    delta = rowsum(dO * O) - dlse is computed here in PyTorch, as the JAX
    package computes it outside its kernels.  Returns (dq, dk, dv)."""
    bhq, sq, d = q.shape
    extra = [("o", o, (bhq, sq, d), q.dtype)]
    if dlse is not None:
        extra.append(("dlse", dlse, (bhq, sq), torch.float32))
    _check_flat("flash_attention_bwd_kernel", q, k, v, causal, extra)
    delta = _delta(o, do, dlse)
    dk, dv = flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, scale, causal)
    dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(o, lse) = flash(q, k, v) in the flat layout, differentiable in
    both outputs: the JAX custom VJP `_flash_flat_with_lse`.  CUDA
    tensors run the kernels; CPU tensors run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        if q.device.type == "cpu":
            o, lse = _flash_fwd_reference(q, k, v, scale, causal)
        else:
            o, lse = flash_attention_fwd_kernel(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        else:
            do = do.contiguous()
        if dlse is not None:
            dlse = dlse.contiguous()
        bwd = (flash_attention_bwd_reference if q.device.type == "cpu"
               else flash_attention_bwd_kernel)
        dq, dk, dv = bwd(q, k, v, o, lse, do, dlse, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# Shape gates and public entry points
# ---------------------------------------------------------------------------
def _pick_block(s: int, b: int) -> int:
    """Largest block <= b that divides s (halving); s<=128 is one block."""
    b0, b = b, min(b, s)
    while s % b and b > 128:
        b //= 2
    if s % b:
        raise ValueError(
            f"flash_attention block size {b0} is incompatible with seq "
            f"length {s}: no halving of it >= 128 divides the length")
    return b


def _validate_flash(q, k, causal, block_q, block_k):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if (sq > 128 and sq % 128) or (sk > 128 and sk % 128):
        raise ValueError(
            f"flash_attention requires seq lengths divisible by the "
            f"128-lane tile: sq={sq}, sk={sk} "
            f"(pad inputs or use attention_reference)")
    if d % 64:
        raise ValueError(f"head_dim {d} must be a multiple of 64")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if causal and sq > sk:
        raise ValueError(
            "causal flash attention requires sq <= sk (rows with no "
            "visible keys are ill-defined); use attention_reference")


def _flash_ok(q, k, causal: bool) -> bool:
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    return (sq % 128 == 0 and sk % 128 == 0 and d % 64 == 0
            and q.shape[1] % k.shape[1] == 0
            and not (causal and sq > sk))


def _flash_apply(q, k, v, causal: bool, scale: Optional[float]):
    """[B,H,S,D] -> flat -> `FlashAttention` -> (o [B,Hq,Sq,D],
    lse [B,Hq,Sq])."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o, lse = FlashAttention.apply(
        q.reshape(b * hq, sq, d).contiguous(),
        k.reshape(b * hkv, sk, d).contiguous(),
        v.reshape(b * hkv, sk, d).contiguous(), scale, causal)
    return o.reshape(b, hq, sq, d), lse.reshape(b, hq, sq)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             block_q: int = DEFAULT_BLOCK_Q,
                             block_k: int = DEFAULT_BLOCK_K,
                             save_residuals: bool = True):
    """The CUDA flash kernels, (o [B,Hq,Sq,D], lse [B,Hq,Sq]),
    differentiable in both.  CUDA tensors only.

    `save_residuals` is accepted for parity with the JAX signature and
    changes nothing: JAX uses it to tag (o, lse) saveable under its remat
    policies, and the port has no tags.  The Function keeps (q, k, v, o,
    lse) for its backward either way; what remat recomputes is decided by
    the checkpoint region the caller runs the call in (`ring_attention`'s
    docstring).  A value that is not a bool raises."""
    if not isinstance(save_residuals, bool):
        raise TypeError("save_residuals is True or False, got "
                        f"{save_residuals!r}")
    _validate_flash(q, k, causal, block_q, block_k)
    _pick_block(q.shape[2], block_q)
    _pick_block(k.shape[2], block_k)
    if q.device.type != "cuda":
        raise ValueError("flash attention runs the CUDA kernels and takes "
                         f"CUDA tensors only (got {q.device}); use "
                         "impl='reference' for the plain version")
    return _flash_apply(q, k, v, causal, scale)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """The CUDA flash kernels. q: [B,Hq,Sq,D], k/v: [B,Hkv,Sk,D]."""
    return flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                    block_k)[0]


def _route(q, impl: str) -> str:
    """"flash" (the kernels), "plain" (the Function's plain path) or
    "reference" (autograd of the reference)."""
    if impl not in ("auto", "flash", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        return "flash" if q.device.type == "cuda" else "plain"
    return impl


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None,
              impl: str = "auto", block_q: int = DEFAULT_BLOCK_Q,
              block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Dispatcher: the flash kernels for CUDA tensors, their plain
    versions for CPU tensors ("auto"), or the reference."""
    if _route(q, impl) == "reference":
        return attention_reference(q, k, v, causal, scale)
    return attention_with_lse(q, k, v, causal, scale, impl, block_q,
                              block_k)[0]


def attention_with_lse(q, k, v, causal: bool = True,
                       scale: Optional[float] = None, impl: str = "auto",
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K):
    """(o, lse) dispatcher, same choice as `attention`."""
    route = _route(q, impl)
    if route == "flash":
        return flash_attention_with_lse(q, k, v, causal, scale, block_q,
                                        block_k)
    if route == "plain":
        return _flash_apply(q, k, v, causal, scale)
    return attention_reference_with_lse(q, k, v, causal, scale)

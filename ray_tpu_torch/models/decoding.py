"""KV-cache autoregressive decoding for serving, PyTorch.

Counterpart of `ray_tpu/models/decoding.py`, with the same functions,
cache layouts and packed wire formats:

* the dense per-slot cache [L, B, M, Hkv, Dh] (`DecodeCaches`);
* the PAGED cache (`PagedDecodeCaches`): a [L, NB, bs, Hkv, Dh] block
  pool addressed through per-slot block tables, decode attention through
  `ops/paged_attention.py` (the CUDA kernel on the card, the plain
  version on the CPU).

Where the JAX functions are jitted with `donate_argnums` on the caches,
the port updates the cache tensors IN PLACE and returns a caches tuple
holding the same pools (plus new small per-slot tensors).  `lax.scan`
over layers and decode steps becomes a Python loop.  Everything stays
on the device: argmax and the last-token feedback are tensor ops, and
nothing in a dispatch reads a value back to the host.

Parameters are f32 as in the JAX package, which casts each matrix to
`cfg.dtype` at every use; `serving_params` makes those casts once (the
result is identical), while embeddings, norms and the output projection
stay f32 and the logits stay f32 x f32.

A quantized tree (`models/quantize.py`) runs the same functions: its
`QuantizedArray` leaves pass through `serving_params` unchanged (int8
stays resident), `_per_layer` slices q and s together (`layer`), and each
`.to(dtype)` / `.float()` / gather of a weight dequantizes at its use,
as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import DeviceLike, resolve_device
from ray_tpu_torch.models.quantize import QuantizedArray
from ray_tpu_torch.models.transformer import (TransformerConfig, _norm, _rope,
                                              _w_out)
from ray_tpu_torch.ops import paged_attention as _pa

# Layer weights the JAX code always casts to cfg.dtype before use.
_COMPUTE_DTYPE_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                       "b_up", "b_down")


def serving_params(params: Dict[str, Any],
                   cfg: TransformerConfig) -> Dict[str, Any]:
    """`params` with the layer matrices cast to `cfg.dtype` once (the
    decode path would otherwise recast all of them at every step).
    Quantized matrices stay int8: they dequantize at each use."""
    layers = {k: (v.to(cfg.dtype) if k in _COMPUTE_DTYPE_KEYS
                  and not isinstance(v, QuantizedArray) else v)
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def _per_layer(params: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked weights (a QuantizedArray stays
    quantized: `v[i]` would gather and dequantize it)."""
    stacked = params["layers"]
    n = next(iter(stacked.values())).shape[0]
    return [{k: (v.layer(i) if isinstance(v, QuantizedArray) else v[i])
             for k, v in stacked.items()} for i in range(n)]


class DecodeCaches(NamedTuple):
    """Per-layer KV caches + per-slot bookkeeping (all fixed-shape)."""

    k: torch.Tensor           # [L, B, M, Hkv, Dh]
    v: torch.Tensor           # [L, B, M, Hkv, Dh]
    lengths: torch.Tensor     # [B] int32 — tokens currently cached per slot
    last_token: torch.Tensor  # [B] int32 — input to the next decode step


def init_caches(cfg: TransformerConfig, num_slots: int, max_len: int,
                device: DeviceLike = None) -> DecodeCaches:
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_slots, max_len, cfg.kv_heads,
             cfg.head_dim)
    return DecodeCaches(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        last_token=torch.zeros((num_slots,), dtype=torch.int32,
                               device=dev))


def _qkv(p, h, cfg: TransformerConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    if cfg.arch == "llama":
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(p, x, cfg: TransformerConfig):
    rms = cfg.arch == "llama"
    h = _norm(x, p["mlp_norm"], p.get("mlp_norm_b"), cfg.norm_eps, rms)
    if cfg.arch == "llama":
        gate = torch.einsum("bsd,df->bsf", h, p["w_gate"].to(h.dtype))
        up = torch.einsum("bsd,df->bsf", h, p["w_up"].to(h.dtype))
        act = F.silu(gate.float()).to(h.dtype) * up
    else:
        up = torch.einsum("bsd,df->bsf", h, p["w_up"].to(h.dtype))
        up = up + p["b_up"].to(h.dtype)
        # jax.nn.gelu defaults to the tanh approximation.
        act = F.gelu(up.float(), approximate="tanh").to(h.dtype)
    down = torch.einsum("bsf,fd->bsd", act, p["w_down"].to(act.dtype))
    if cfg.arch == "gpt2":
        down = down + p["b_down"].to(down.dtype)
    return x + down


def _embed(params, tokens, positions, cfg: TransformerConfig):
    """Token (+ learned position, clipped like the JAX gather) embeddings
    in cfg.dtype; tokens/positions [N, S]."""
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    if cfg.arch == "gpt2":
        x = x + params["pos_embed"][
            positions.clamp(0, cfg.max_seq - 1).long()].to(cfg.dtype)
    return x


def _logits(params, last, cfg: TransformerConfig):
    """f32 x f32 output projection of the last hidden state [N, D]."""
    return last.float() @ _w_out(params, cfg).float()


def _masked_attention(q, k, v, mask, cfg: TransformerConfig):
    """q [N,P,H,Dh], k/v [N,S,Hkv,Dh], mask [N,P,S] -> [N,P,H,Dh] in
    cfg.dtype.  f32 scores and softmax; a fully masked row is NaN, as in
    the JAX package (only gated values leave the callers)."""
    N, P = q.shape[:2]
    groups = cfg.n_heads // cfg.kv_heads
    qg = q.reshape(N, P, cfg.kv_heads, groups, cfg.head_dim)
    s = torch.einsum("bqhgk,bmhk->bhgqm", qg.float(),
                     k.float()) / (cfg.head_dim ** 0.5)
    s = s.masked_fill(~mask[:, None, None], -math.inf)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqm,bmhk->bqhgk", w, v.float())
    return o.reshape(N, P, cfg.n_heads, cfg.head_dim).to(cfg.dtype)


def _attn_out(p, o, cfg: TransformerConfig):
    return torch.einsum("bshk,hkd->bsd", o.to(cfg.dtype),
                        p["wo"].to(cfg.dtype))


def _decode_loop(step, caches, num_steps: int, B: int, device):
    """Run `step` num_steps times; returns (caches', tokens [steps, B])."""
    toks = []
    for _ in range(num_steps):
        caches, tok = step(caches)
        toks.append(tok)
    if not toks:
        return caches, torch.zeros((0, B), dtype=torch.int32,
                                   device=device)
    return caches, torch.stack(toks)


def _gqa_scores(q, k_cache, cfg: TransformerConfig):
    """q: [B,1,H,Dh], k_cache: [B,M,Hkv,Dh] -> scores [B,H,M] (f32)."""
    groups = cfg.n_heads // cfg.kv_heads
    B, M = k_cache.shape[0], k_cache.shape[1]
    qg = q[:, 0].reshape(B, cfg.kv_heads, groups, cfg.head_dim)
    s = torch.einsum("bhgk,bmhk->bhgm", qg.float(), k_cache.float())
    return s.reshape(B, cfg.n_heads, M) / (cfg.head_dim ** 0.5)


def _decode_core(params, caches: DecodeCaches, active, cfg, layers
                 ) -> Tuple[DecodeCaches, torch.Tensor]:
    """One dense decode step (in place on caches.k/v).  Safe to run
    extra steps on retired slots: every cache position is overwritten by
    its owner before it is first attended."""
    B = caches.lengths.shape[0]
    dev = caches.lengths.device
    pos = caches.lengths[:, None]                            # [B,1]
    x = _embed(params, caches.last_token[:, None], pos, cfg)  # [B,1,D]
    rms = cfg.arch == "llama"
    batch_ix = torch.arange(B, device=dev)
    M = caches.k.shape[2]
    mask = torch.arange(M, device=dev)[None, :] <= pos       # [B,M]
    # JAX drops a scatter at an out-of-range position; gate it the same.
    write = (active & (caches.lengths < M))[:, None, None]
    idx = caches.lengths.clamp(max=M - 1).long()
    for li, p in enumerate(layers):
        k_cache, v_cache = caches.k[li], caches.v[li]
        h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps,
                  rms)
        q, k_new, v_new = _qkv(p, h, cfg, pos)
        # Inactive slots keep their cache untouched (gate-then-scatter).
        k_cache[batch_ix, idx] = torch.where(
            write, k_new[:, 0].to(k_cache.dtype), k_cache[batch_ix, idx])
        v_cache[batch_ix, idx] = torch.where(
            write, v_new[:, 0].to(v_cache.dtype), v_cache[batch_ix, idx])
        s = _gqa_scores(q, k_cache, cfg)                     # [B,H,M]
        s = s.masked_fill(~mask[:, None, :], -math.inf)
        w = torch.softmax(s, dim=-1)
        groups = cfg.n_heads // cfg.kv_heads
        wg = w.reshape(B, cfg.kv_heads, groups, M)
        o = torch.einsum("bhgm,bmhk->bhgk", wg, v_cache.float())
        o = o.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        x = x + _attn_out(p, o, cfg)
        x = _mlp(p, x, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_eps, rms)
    next_tok = torch.argmax(_logits(params, x[:, 0], cfg),
                            dim=-1).to(torch.int32)
    new_last = torch.where(active, next_tok, caches.last_token)
    new_len = torch.where(active, caches.lengths + 1, caches.lengths)
    return caches._replace(lengths=new_len, last_token=new_last), next_tok


def decode_step(params, caches: DecodeCaches, active, cfg
                ) -> Tuple[DecodeCaches, torch.Tensor]:
    """One token for every slot; returns (caches', next_tokens [B])."""
    return _decode_core(params, caches, active, cfg, _per_layer(params))


def decode_steps(params, caches: DecodeCaches, active, cfg,
                 num_steps: int) -> Tuple[DecodeCaches, torch.Tensor]:
    """num_steps tokens per slot in one dispatch: (caches', [steps, B])."""
    layers = _per_layer(params)
    return _decode_loop(
        lambda c: _decode_core(params, c, active, cfg, layers), caches,
        num_steps, caches.lengths.shape[0], caches.lengths.device)


def prefill(params, tokens, length, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prompt pass.  tokens: [1, P] int32 (padded), length: true length.
    Returns (k [L,P,Hkv,Dh], v [L,P,Hkv,Dh], last_logits [vocab])."""
    dev = tokens.device
    P = tokens.shape[1]
    length = torch.as_tensor(length, dtype=torch.int32, device=dev)
    positions = torch.arange(P, dtype=torch.int32, device=dev)[None]
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)     # [1,P,D]
    if cfg.arch == "gpt2":
        x = x + params["pos_embed"][:P][None].to(cfg.dtype)
    rms = cfg.arch == "llama"
    ar = torch.arange(P, device=dev)
    causal = ar[:, None] >= ar[None, :]
    padmask = ar[None, :] < length                           # [1,P]
    mask = causal[None] & padmask[:, None, :]                # [1,P,P]
    ks, vs = [], []
    for p in _per_layer(params):
        h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps,
                  rms)
        q, k, v = _qkv(p, h, cfg, positions)
        x = x + _attn_out(p, _masked_attention(q, k, v, mask, cfg), cfg)
        x = _mlp(p, x, cfg)
        ks.append(k[0])
        vs.append(v[0])
    x = _norm(x, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_eps, rms)
    last = x[0, (length - 1).clamp(0, P - 1).long()]
    return torch.stack(ks), torch.stack(vs), _logits(params, last, cfg)


def _prefill_insert_core(params, caches: DecodeCaches, tokens, lengths,
                         slots, valid, cfg, layers
                         ) -> Tuple[DecodeCaches, torch.Tensor]:
    """Batched prompt pass + gated insertion into the dense cache (in
    place); shared by prefill_insert and the fused admission+decode."""
    dev = tokens.device
    N, P = tokens.shape
    positions = torch.arange(P, dtype=torch.int32,
                             device=dev).expand(N, P)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)     # [N,P,D]
    if cfg.arch == "gpt2":
        x = x + params["pos_embed"][:P][None].to(cfg.dtype)
    rms = cfg.arch == "llama"
    ar = torch.arange(P, device=dev)
    causal = ar[:, None] >= ar[None, :]
    padmask = ar[None, :] < lengths[:, None]                 # [N,P]
    mask = causal[None] & padmask[:, None, :]                # [N,P,P]
    ks, vs = [], []
    for p in layers:
        h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps,
                  rms)
        q, k, v = _qkv(p, h, cfg, positions)
        x = x + _attn_out(p, _masked_attention(q, k, v, mask, cfg), cfg)
        x = _mlp(p, x, cfg)
        ks.append(k)
        vs.append(v)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_eps, rms)
    last_ix = (lengths - 1).clamp(0, P - 1).long()
    last = x[torch.arange(N, device=dev), last_ix]           # [N,D]
    first_tok = torch.argmax(_logits(params, last, cfg),
                             dim=-1).to(torch.int32)
    # Scatter [L,N,P,...] -> positions [:, slot, :P]; invalid rows write
    # back what is there (their slots are distinct).
    gate = valid[None, :, None, None, None]
    for cache, new in ((caches.k, ks), (caches.v, vs)):
        old = cache[:, slots, :P]
        cache[:, slots, :P] = torch.where(
            gate, torch.stack(new).to(cache.dtype), old)
    new_len = caches.lengths.clone()
    new_len[slots] = torch.where(valid, lengths, caches.lengths[slots])
    new_last = caches.last_token.clone()
    new_last[slots] = torch.where(valid, first_tok,
                                  caches.last_token[slots])
    return caches._replace(lengths=new_len, last_token=new_last), first_tok


def prefill_insert(params, caches: DecodeCaches, tokens, lengths, slots,
                   valid, cfg) -> Tuple[DecodeCaches, torch.Tensor]:
    """Batched prefill of up to N prompts + cache insertion in ONE
    dispatch.  tokens: [N, P] int32 (padded), lengths/slots/valid: [N].
    Returns (caches', first_tokens [N])."""
    return _prefill_insert_core(params, caches, tokens, lengths,
                                slots.long(), valid, cfg,
                                _per_layer(params))


def prefill_decode_packed(params, caches: DecodeCaches, packed,
                          cfg: TransformerConfig, num_steps: int,
                          prompt_pad: int
                          ) -> Tuple[DecodeCaches, torch.Tensor,
                                     torch.Tensor]:
    """Fused admission + chunked decode with ALL host inputs in ONE
    int32 upload.

    packed: [N+1, W] int32 with W = max(prompt_pad + 3, num_slots);
      rows 0..N-1: [tokens[0:P] | length | slot | valid]
      row  N:      active mask for the B decode slots in cols 0..B-1.
    Returns (caches', first [N], tokens [num_steps, B]).
    """
    P = prompt_pad
    B = caches.lengths.shape[0]
    tokens = packed[:-1, :P]
    lengths = packed[:-1, P]
    slots = packed[:-1, P + 1].long()
    valid = packed[:-1, P + 2] > 0
    active = packed[-1, :B] > 0
    layers = _per_layer(params)
    caches, first = _prefill_insert_core(params, caches, tokens, lengths,
                                         slots, valid, cfg, layers)
    active[slots] = torch.where(valid, True, active[slots])
    caches, toks = _decode_loop(
        lambda c: _decode_core(params, c, active, cfg, layers), caches,
        num_steps, B, packed.device)
    return caches, first, toks


def insert_slot(caches: DecodeCaches, slot, k, v, length, first_token
                ) -> DecodeCaches:
    """Install a prefilled request into a decode slot (in place).
    k/v: [L,P,...]; P <= M — positions beyond `length` are masked by the
    per-slot length at attention time."""
    P = k.shape[1]
    caches.k[:, slot, :P] = k.to(caches.k.dtype)
    caches.v[:, slot, :P] = v.to(caches.v.dtype)
    lengths = caches.lengths.clone()
    lengths[slot] = length
    last = caches.last_token.clone()
    last[slot] = first_token
    return caches._replace(lengths=lengths, last_token=last)


def set_last_tokens(caches: DecodeCaches,
                    tokens: torch.Tensor) -> DecodeCaches:
    return caches._replace(last_token=tokens)


# ===========================================================================
# Paged KV cache (block pool + per-slot block tables)
# ===========================================================================
# Invariants the engine (serve/llm.py) maintains, which these functions
# rely on (as in the JAX package):
#   * pool block 0 is a reserved scratch block: never allocated, table
#     padding points at it, and gated/over-capacity writes are
#     redirected to it — so duplicate scatter targets always carry the
#     same value and garbage positions are always masked by length;
#   * a request's prefix_len is a multiple of the block size (only
#     FULL blocks are shared), so every suffix/decode write lands in a
#     block owned exclusively by that slot;
#   * admission pre-allocates blocks for prompt + max_new tokens, so
#     decode never needs to allocate (and never runs out mid-decode).


class PagedDecodeCaches(NamedTuple):
    """Block-pool KV + per-slot tables (all fixed-shape)."""

    kp: torch.Tensor            # [L, NB, bs, Hkv, Dh] block pool
    vp: torch.Tensor            # [L, NB, bs, Hkv, Dh]
    block_tables: torch.Tensor  # [B, W] int32 — physical block per logical
    lengths: torch.Tensor       # [B] int32 — tokens currently cached
    last_token: torch.Tensor    # [B] int32 — input to the next decode step


def paged_table_width(max_len: int, block_size: int) -> int:
    """Logical blocks per slot (ceil)."""
    return -(-max_len // block_size)


def init_paged_caches(cfg: TransformerConfig, num_slots: int,
                      num_blocks: int, block_size: int, max_len: int,
                      device: DeviceLike = None) -> PagedDecodeCaches:
    """`num_blocks` USABLE blocks; one extra scratch block (id 0) is
    added, so pool ids run 0..num_blocks inclusive."""
    dev = resolve_device(device)
    w = paged_table_width(max_len, block_size)
    shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.kv_heads,
             cfg.head_dim)
    return PagedDecodeCaches(
        kp=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        vp=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        block_tables=torch.zeros((num_slots, w), dtype=torch.int32,
                                 device=dev),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        last_token=torch.zeros((num_slots,), dtype=torch.int32,
                               device=dev))


def _paged_decode_core(params, caches: PagedDecodeCaches, active, cfg,
                       attn_impl: str, layers
                       ) -> Tuple[PagedDecodeCaches, torch.Tensor]:
    """One decode step over the block pool (in place on the pools).
    Mirrors _decode_core with the scatter routed through the block
    table and attention through ops.paged_attention.  Safe to run extra
    steps on retired/drained slots: their writes are clamped into their
    own private tail blocks or redirected to scratch block 0."""
    B = caches.lengths.shape[0]
    dev = caches.lengths.device
    bs = caches.kp.shape[2]
    M = caches.block_tables.shape[1] * bs
    pos = caches.lengths[:, None]                            # [B,1]
    x = _embed(params, caches.last_token[:, None], pos, cfg)  # [B,1,D]
    rms = cfg.arch == "llama"
    batch_ix = torch.arange(B, device=dev)
    # Clamp the write position for slots decoding past their
    # allocation; the active gate redirects inactive slots to block 0.
    pos_c = caches.lengths.clamp(max=M - 1)
    blk_w = torch.where(active,
                        caches.block_tables[batch_ix, (pos_c // bs).long()],
                        0).long()
    off_w = (pos_c % bs).long()
    # Valid positions INCLUDE the token scattered this step.
    ctx_lens = (caches.lengths + 1).clamp(max=M)
    gate = active[:, None, None]
    for li, p in enumerate(layers):
        k_pool, v_pool = caches.kp[li], caches.vp[li]
        h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps,
                  rms)
        q, k_new, v_new = _qkv(p, h, cfg, pos)
        k_pool[blk_w, off_w] = torch.where(
            gate, k_new[:, 0].to(k_pool.dtype), k_pool[blk_w, off_w])
        v_pool[blk_w, off_w] = torch.where(
            gate, v_new[:, 0].to(v_pool.dtype), v_pool[blk_w, off_w])
        o = _pa.paged_attention(q[:, 0], k_pool, v_pool,
                                caches.block_tables, ctx_lens,
                                impl=attn_impl)              # [B,H,Dh]
        x = x + _attn_out(p, o[:, None], cfg)
        x = _mlp(p, x, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_eps, rms)
    next_tok = torch.argmax(_logits(params, x[:, 0], cfg),
                            dim=-1).to(torch.int32)
    new_last = torch.where(active, next_tok, caches.last_token)
    new_len = torch.where(active, caches.lengths + 1, caches.lengths)
    return caches._replace(lengths=new_len, last_token=new_last), next_tok


def paged_decode_step(params, caches: PagedDecodeCaches, active, cfg,
                      attn_impl: str = "auto"
                      ) -> Tuple[PagedDecodeCaches, torch.Tensor]:
    """One token for every slot; returns (caches', next_tokens [B])."""
    return _paged_decode_core(params, caches, active, cfg, attn_impl,
                              _per_layer(params))


def paged_decode_steps(params, caches: PagedDecodeCaches, active, cfg,
                       num_steps: int, attn_impl: str = "auto"
                       ) -> Tuple[PagedDecodeCaches, torch.Tensor]:
    """num_steps tokens per slot in one dispatch: (caches', [steps, B])."""
    layers = _per_layer(params)
    return _decode_loop(
        lambda c: _paged_decode_core(params, c, active, cfg, attn_impl,
                                     layers),
        caches, num_steps, caches.lengths.shape[0], caches.lengths.device)


def _paged_prefill_core(params, caches: PagedDecodeCaches, tokens,
                        suffix_lens, prefix_lens, slots, valid, new_bt,
                        cfg, layers
                        ) -> Tuple[PagedDecodeCaches, torch.Tensor]:
    """Suffix prefill against a paged prefix (in place on the pools).

    tokens [N, P] hold only each prompt's UNCACHED suffix; the cached
    prefix (prefix_lens tokens, whole blocks already in the pool) is
    attended by gather, never recomputed.  Suffix queries sit at
    absolute positions prefix_len + i, attend all prefix positions plus
    causally within the suffix, and their K/V are scattered into the
    slot's private blocks.  Invalid rows rewrite existing state."""
    dev = tokens.device
    N, P = tokens.shape
    bs = caches.kp.shape[2]
    W = caches.block_tables.shape[1]
    M = W * bs
    bt = caches.block_tables.clone()
    bt[slots] = torch.where(valid[:, None], new_bt,
                            caches.block_tables[slots])
    bt_rows = bt[slots]                                      # [N, W]
    positions = prefix_lens[:, None] + torch.arange(
        P, dtype=torch.int32, device=dev)                    # [N, P]
    x = _embed(params, tokens, positions, cfg)               # [N,P,D]
    rms = cfg.arch == "llama"
    ar = torch.arange(P, device=dev)
    causal = ar[:, None] >= ar[None, :]
    padmask = ar[None, :] < suffix_lens[:, None]             # [N,P]
    ctx_mask = (torch.arange(M, device=dev)[None, :]
                < prefix_lens[:, None])                      # [N,M]
    # keys: [0..M) gathered pool window, [M..M+P) in-flight suffix.
    mask_full = torch.cat([ctx_mask[:, None, :].expand(N, P, M),
                           causal[None] & padmask[:, None, :]], dim=-1)
    # Scatter targets for the suffix K/V (clamped + gated to scratch).
    abs_pos = positions.clamp(max=M - 1)
    blkidx = torch.gather(bt_rows, 1, (abs_pos // bs).long())
    offidx = (abs_pos % bs).long()
    wgate = valid[:, None] & padmask                         # [N,P]
    blk_w = torch.where(wgate, blkidx, 0).long()
    wgate4 = wgate[..., None, None]
    bt_long = bt_rows.long()
    for li, p in enumerate(layers):
        k_pool, v_pool = caches.kp[li], caches.vp[li]
        h = _norm(x, p["attn_norm"], p.get("attn_norm_b"), cfg.norm_eps,
                  rms)
        q, k, v = _qkv(p, h, cfg, positions)
        k_pool[blk_w, offidx] = torch.where(
            wgate4, k.to(k_pool.dtype), k_pool[blk_w, offidx])
        v_pool[blk_w, offidx] = torch.where(
            wgate4, v.to(v_pool.dtype), v_pool[blk_w, offidx])
        # Prefix window gather (suffix positions in it are masked off).
        k_ctx = k_pool[bt_long].reshape(N, M, cfg.kv_heads, cfg.head_dim)
        v_ctx = v_pool[bt_long].reshape(N, M, cfg.kv_heads, cfg.head_dim)
        k_all = torch.cat([k_ctx.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_ctx.to(v.dtype), v], dim=1)
        o = _masked_attention(q, k_all, v_all, mask_full, cfg)
        x = x + _attn_out(p, o, cfg)
        x = _mlp(p, x, cfg)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"),
              cfg.norm_eps, rms)
    last_ix = (suffix_lens - 1).clamp(0, P - 1).long()
    last = x[torch.arange(N, device=dev), last_ix]           # [N,D]
    first_tok = torch.argmax(_logits(params, last, cfg),
                             dim=-1).to(torch.int32)
    new_len = caches.lengths.clone()
    new_len[slots] = torch.where(valid, prefix_lens + suffix_lens,
                                 caches.lengths[slots])
    new_last = caches.last_token.clone()
    new_last[slots] = torch.where(valid, first_tok,
                                  caches.last_token[slots])
    return caches._replace(block_tables=bt, lengths=new_len,
                           last_token=new_last), first_tok


def paged_prefill_decode_packed(params, caches: PagedDecodeCaches, packed,
                                cfg: TransformerConfig, num_steps: int,
                                prompt_pad: int, attn_impl: str = "auto"
                                ) -> Tuple[PagedDecodeCaches, torch.Tensor,
                                           torch.Tensor]:
    """Fused suffix-prefill + chunked decode with ALL host inputs in
    ONE int32 upload (the paged analog of prefill_decode_packed).

    packed: [N+1, Wp] int32 with W = table width and
    Wp = max(prompt_pad + 4 + W, num_slots);
      rows 0..N-1: [suffix_tokens[0:P] | suffix_len | prefix_len |
                    slot | valid | block_table[0:W]]
      row  N:      active mask for the B decode slots in cols 0..B-1.
    Returns (caches', first [N], tokens [num_steps, B]).
    """
    P = prompt_pad
    B = caches.lengths.shape[0]
    W = caches.block_tables.shape[1]
    tokens = packed[:-1, :P]
    suffix_lens = packed[:-1, P]
    prefix_lens = packed[:-1, P + 1]
    slots = packed[:-1, P + 2].long()
    valid = packed[:-1, P + 3] > 0
    new_bt = packed[:-1, P + 4:P + 4 + W]
    active = packed[-1, :B] > 0
    layers = _per_layer(params)
    caches, first = _paged_prefill_core(params, caches, tokens,
                                        suffix_lens, prefix_lens, slots,
                                        valid, new_bt, cfg, layers)
    active[slots] = torch.where(valid, True, active[slots])
    caches, toks = _decode_loop(
        lambda c: _paged_decode_core(params, c, active, cfg, attn_impl,
                                     layers),
        caches, num_steps, B, packed.device)
    return caches, first, toks

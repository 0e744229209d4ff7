"""Serving-engine parity: the port's PagedBatcher / LLMDeployment
(ray_tpu_torch/serve/llm.py) on the CPU against one JAX
paged_prefill_decode_packed call (ray_tpu/models/decoding.py, reference
attention) over the same prompts and weights; prefix-cache hits; and
BlockAllocator / RadixCache invariants of the port's classes.

Tokens are held exactly (greedy, f32)."""

import asyncio

import numpy as np
import pytest
import torch

from ray_tpu_torch.devtools import leaksan
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.serve._admission import RequestRejectedError
from ray_tpu_torch.serve.llm import (BlockAllocator, ContinuousBatcher,
                                     LLMDeployment, PagedBatcher,
                                     RadixCache)
from test_torch_transformer import numpy_params

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=128)
BS, MAX_NEW = 4, 8
PROMPTS = ([5, 17, 3, 88, 41],
           [9, 9, 2, 60, 33, 71, 14, 8, 50],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13])
ENGINE = dict(num_slots=4, max_len=48, prompt_pad=16, decode_chunk=4,
              pipeline_depth=2, kv_block_size=BS)


@pytest.fixture(scope="module")
def reference():
    """(port params, greedy tokens per prompt from ONE JAX call)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import decoding as jdec
    from ray_tpu.models.transformer import TransformerConfig
    jcfg = TransformerConfig(dtype=jnp.float32, remat=False, **CFG)
    tcfg = ttr.TransformerConfig(dtype=torch.float32, **CFG)
    weights = numpy_params(tcfg, 7)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = convert.params_from_jax(weights, tcfg, device="cpu")
    P, N = 16, len(PROMPTS)
    W = jdec.paged_table_width(48, BS)
    caches = jdec.init_paged_caches(jcfg, N, N * W, BS, 48)
    packed = np.zeros((N + 1, P + 4 + W), np.int32)
    for row, prompt in enumerate(PROMPTS):
        packed[row, :len(prompt)] = prompt
        packed[row, P] = len(prompt)
        packed[row, P + 2] = row
        packed[row, P + 3] = 1
        packed[row, P + 4:] = 1 + row * W + np.arange(W)
    _, first, toks = jdec.paged_prefill_decode_packed(
        jp, caches, jnp.asarray(packed), jcfg, MAX_NEW - 1, P,
        attn_impl="reference")
    first, toks = np.asarray(first), np.asarray(toks)
    want = [[int(first[r])] + toks[:, r].tolist() for r in range(N)]
    return tp, want


def _cfg_kwargs():
    return dict(CFG, dtype=torch.float32)


def test_paged_engine_matches_jax_and_prefix_hit_reruns(reference):
    tp, want = reference
    tcfg = ttr.TransformerConfig(**_cfg_kwargs())
    bat = PagedBatcher(tp, tcfg, **ENGINE)
    try:
        reqs = [bat.submit(p, MAX_NEW) for p in PROMPTS]
        for req, exp in zip(reqs, want):
            assert req.done.wait(60)
            assert req.error is None
            assert req.tokens == exp
            assert req.finish_reason == "length"
            assert not req.cache_hit
        # Re-send: the full prompt blocks are cached, so the hit covers
        # floor((len - 1) / bs) blocks and only the suffix is prefilled.
        for prompt, exp in zip(PROMPTS, want):
            out = bat.generate(prompt, MAX_NEW, timeout=60)
            assert out["tokens"] == exp
            assert out["cache_hit"]
            assert out["cached_tokens"] == (len(prompt) - 1) // BS * BS
        stats = bat.kv_stats()
        assert stats["prefix_cache"]["hits"] == len(PROMPTS)
        assert stats["blocks"]["used"] == 0
    finally:
        bat.stop()
    assert bat.kv_stats()["blocks"]["cached"] == 0


def test_deployment_entry_points_on_cpu(reference):
    tp, want = reference
    dep = LLMDeployment(_cfg_kwargs(), params=tp, device="cpu", **ENGINE)
    try:
        out = asyncio.run(dep.generate(PROMPTS[0], MAX_NEW))
        assert out["tokens"] == want[0]
        assert set(out["ttft_breakdown"]) >= {"queue_s", "prefill_s"}
        assert list(dep.generate_stream(PROMPTS[1], MAX_NEW)) == want[1]
        assert dep(PROMPTS[2])["tokens"][:MAX_NEW] == want[2]
        assert dep.stats()["steps"] > 0
    finally:
        dep.stop()
    dense = LLMDeployment(_cfg_kwargs(), params=tp, device="cpu",
                          paged_kv=False, num_slots=2, max_len=48,
                          prompt_pad=16, decode_chunk=4)
    try:
        assert dense.batcher.generate(PROMPTS[2], MAX_NEW,
                                      timeout=60)["tokens"] == want[2]
    finally:
        dense.stop()


def test_engine_rejects_what_it_cannot_serve(reference):
    tp, _ = reference
    tcfg = ttr.TransformerConfig(**_cfg_kwargs())
    with pytest.raises(ValueError, match="paged_kv"):
        LLMDeployment(_cfg_kwargs(), params=tp, device="cpu",
                      paged_kv=False, adapters={"a": {}})
    dense = ContinuousBatcher(tp, tcfg, num_slots=2, max_len=48,
                              prompt_pad=16, decode_chunk=4)
    try:
        with pytest.raises(ValueError, match="multiplexing"):
            dense.submit(PROMPTS[0], 4, model_id="lora-a")
    finally:
        dense.stop()
    # A spec that is not a dict (an object-store ref in the JAX engine)
    # fails its request, naming the runtime it waits for.
    bat = PagedBatcher(tp, tcfg, max_queue=1, adapters={"ref": object()},
                       **ENGINE)
    try:
        with pytest.raises(NotImplementedError, match="A3"):
            bat.generate(PROMPTS[0], 4, timeout=60, model_id="ref")
        with pytest.raises(ValueError, match="prompt budget"):
            bat.submit(list(range(17)), 4)
        bat.queue_depth = lambda: 1            # one request queued ahead
        with pytest.raises(RequestRejectedError) as ei:
            bat.submit(PROMPTS[0], 4)
        assert ei.value.reason == "queue_full"
        assert bat.kv_stats()["prefix_cache"]["queries"] == 0
    finally:
        bat.stop()


def test_stopped_engine_leaks_no_blocks(reference):
    tp, _ = reference
    tcfg = ttr.TransformerConfig(**_cfg_kwargs())
    leaksan.enable_for_testing()
    leaksan.reset()
    try:
        bat = PagedBatcher(tp, tcfg, **ENGINE)
        assert bat.generate(PROMPTS[1], 6, timeout=60)["tokens"]
        bat.stop()
        assert "kv_block" not in leaksan.live_counts()
        assert "thread" not in leaksan.live_counts()
    finally:
        leaksan.disable_for_testing()
        leaksan.reset()


# ---------------------------------------------------------------------------
# BlockAllocator / RadixCache invariants
# ---------------------------------------------------------------------------
def test_allocator_refcount_cache_and_free_states():
    a = BlockAllocator(4)
    blocks = a.alloc(3)
    assert sorted(blocks) == [1, 2, 3]         # block 0 is never issued
    assert a.alloc(2) is None and a.available() == 1   # never partial
    a.incref(blocks[0])
    a.mark_cached(blocks[0])
    a.decref(blocks[0])
    a.decref(blocks[0])                        # refcount 0, retained
    assert a.counts() == {"used": 2, "cached": 1, "free": 1}
    a.release_cached(blocks[0])
    assert a.counts() == {"used": 2, "cached": 0, "free": 2}
    for b in blocks[1:]:
        a.decref(b)
    with pytest.raises(RuntimeError, match="double-free"):
        a.decref(blocks[1])
    assert a.counts() == {"used": 0, "cached": 0, "free": 4}


def test_radix_match_insert_and_leaf_eviction():
    a = BlockAllocator(8)
    tree = RadixCache(BS)
    prompt = list(range(10))                   # 2 full blocks + tail
    blocks = a.alloc(3)
    assert tree.insert(prompt, blocks, a) == 2
    assert tree.match(prompt) == blocks[:2]
    assert tree.match(prompt[:8]) == blocks[:1]   # keeps >= 1 suffix token
    assert tree.match([99] + prompt[1:]) == []
    for b in blocks:
        a.decref(b)
    assert a.counts()["cached"] == 2
    leaves = tree.evictable()
    assert [n.block for _, n in leaves] == [blocks[1]]  # leaf only
    tree.remove_leaf(leaves[0][1], a)
    assert tree.match(prompt) == blocks[:1]
    assert a.counts() == {"used": 0, "cached": 1, "free": 7}

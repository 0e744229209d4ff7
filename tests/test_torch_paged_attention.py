"""Paged-attention parity: the port's plain `paged_attention_reference`
(ray_tpu_torch/ops/paged_attention.py) against the JAX Pallas kernel in
interpret mode and the JAX reference (ray_tpu/ops/paged_attention.py),
on the same numpy inputs; the CUDA kernel's split arithmetic
(`split_plan`, `paged_attention_split_reference`: partitions of whole
KV blocks merged by the logsumexp rule) against both; plus the
dispatcher's no-fallback contract.

Tolerance: f32 atol/rtol 1e-5 — the implementations differ only in
summation order (online vs one-shot vs per-partition softmax, einsum
order)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import paged_attention as tpa

B, HKV, D, BS, W = 4, 2, 64, 4, 5
NB = B * W + 1
# Ragged: empty, one token, a non-multiple of bs, a full table.
CTX = np.array([0, 1, 7, W * BS], np.int32)
GROUPS = (1, 2, 4)


def _inputs(groups, seed=0):
    rng = np.random.RandomState(seed + groups)
    H = HKV * groups
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(NB, BS, HKV, D).astype(np.float32)
    vp = rng.randn(NB, BS, HKV, D).astype(np.float32)
    # Permuted physical blocks (block 0 stays the scratch/padding id).
    bt = (rng.permutation(NB - 1)[:B * W] + 1).reshape(B, W)
    bt = bt.astype(np.int32)
    return q, kp, vp, bt, CTX.copy()


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX kernel (interpret mode) and reference outputs per group size,
    computed once."""
    import jax
    from ray_tpu.ops import paged_attention as jpa

    @jax.jit
    def both(*args):
        return (jpa.paged_attention_kernel(*args, interpret=True),
                jpa.paged_attention_reference(*args))

    return {g: jax.tree.map(np.asarray, both(*_inputs(g)))
            for g in GROUPS}


@pytest.mark.parametrize("groups", GROUPS)
def test_reference_matches_jax_kernel_and_reference(jax_outputs, groups):
    q, kp, vp, bt, ctx = (torch.from_numpy(a) for a in _inputs(groups))
    got = tpa.paged_attention(q, kp, vp, bt, ctx, impl="auto").numpy()
    want_kernel, want_ref = jax_outputs[groups]
    np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=1e-5)
    assert np.all(got[0] == 0.0)              # ctx == 0 -> zeros, no NaN
    assert np.isfinite(got).all()


def test_kernel_impl_on_cpu_raises_instead_of_falling_back():
    q, kp, vp, bt, ctx = (torch.from_numpy(a) for a in _inputs(1))
    before = tpa.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_attention(q, kp, vp, bt, ctx, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_attention_kernel(q, kp, vp, bt, ctx)
    assert tpa.launches == before
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        tpa.paged_attention(q, kp, vp, bt, ctx, impl="flash")


# Partition sizes for the split arithmetic: one block per partition (5
# partitions of 4 tokens), two (3 partitions of 8), and the kernel's own
# 64 tokens (the whole 20-token table in one partition).
PART_TOKENS = (4, 8, 64)


@pytest.mark.parametrize("part_tokens", PART_TOKENS)
@pytest.mark.parametrize("groups", GROUPS)
def test_split_reference_matches_jax_kernel_and_plain(jax_outputs, groups,
                                                      part_tokens):
    q, kp, vp, bt, ctx = (torch.from_numpy(a) for a in _inputs(groups))
    got = tpa.paged_attention_split_reference(q, kp, vp, bt, ctx,
                                              part_tokens=part_tokens)
    want_kernel, _ = jax_outputs[groups]
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5,
                               rtol=1e-5)
    plain = tpa.paged_attention_reference(q, kp, vp, bt, ctx)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert np.all(got[0].numpy() == 0.0)      # ctx == 0 -> zeros, no NaN


@pytest.mark.parametrize("part_tokens", PART_TOKENS)
def test_split_reference_at_partition_boundaries(part_tokens):
    """Contexts 0, 1, one partition exactly, one partition + 1, several
    partitions and the full table, on a longer table (W 12, bs 4)."""
    rng = np.random.RandomState(7)
    Bn, H, hkv, W_ = 6, 8, 2, 12
    nb = Bn * W_ + 1
    T = tpa.split_plan(W_, BS, part_tokens).part_blocks * BS
    ctx = np.array([0, 1, T, T + 1, min(3 * T - 1, W_ * BS), W_ * BS],
                   np.int32)
    q = torch.from_numpy(rng.randn(Bn, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(nb, BS, hkv, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(nb, BS, hkv, D).astype(np.float32))
    bt = torch.from_numpy((rng.permutation(nb - 1)[:Bn * W_] + 1)
                          .reshape(Bn, W_).astype(np.int32))
    lens = torch.from_numpy(ctx)
    got = tpa.paged_attention_split_reference(q, kp, vp, bt, lens,
                                              part_tokens=part_tokens)
    want = tpa.paged_attention_reference(q, kp, vp, bt, lens)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


@pytest.mark.parametrize("W_,bs,part_tokens", [
    (32, 16, 64), (256, 16, 64), (20, 5, 64), (8, 64, 64), (3, 48, 64),
    (1, 16, 64), (7, 4, 8), (5, 4, 4), (9, 3, 1)])
def test_split_plan_covers_every_block_once(W_, bs, part_tokens):
    """The partitions of whole blocks cover blocks 0..W-1 (positions below
    W*bs) exactly once, each holds at most max(part_tokens, bs) tokens,
    and the plan is a function of the shapes alone (ints in, ints out:
    nothing of context_lens reaches the host)."""
    part_blocks, n_parts = tpa.split_plan(W_, bs, part_tokens)
    assert isinstance(part_blocks, int) and isinstance(n_parts, int)
    assert part_blocks >= 1
    assert part_blocks * bs <= max(part_tokens, bs)
    assert n_parts == -(-W_ * bs // (part_blocks * bs))
    covered = [w for p in range(n_parts)
               for w in range(p * part_blocks,
                              min(W_, (p + 1) * part_blocks))]
    assert covered == list(range(W_))
    # No partition is empty of table blocks.
    assert (n_parts - 1) * part_blocks < W_


def test_split_plan_rejects_empty_shapes():
    for args in ((0, 16), (4, 0), (4, 16, 0)):
        with pytest.raises(ValueError, match="split_plan"):
            tpa.split_plan(*args)


def test_bf16_row_check_passes_split_and_rejects_a_dropped_partition():
    """chip_smoke.py's bf16 B4 check (largest relative error over
    (sequence, head) rows, B4_ROW_REL): the split arithmetic in bf16
    passes it against the plain version, and the plain result with the
    first 64-token partition left out fails it on every row that holds a
    position (W 12, bs 16: three partitions)."""
    from chip_smoke import B4_ROW_REL, row_rel_err
    rng = np.random.RandomState(11)
    Bn, H, hkv, bs, W_ = 5, 8, 2, 16, 12
    nb = Bn * W_ + 1
    part_blocks, n_parts = tpa.split_plan(W_, bs)
    assert n_parts == 3
    T = part_blocks * bs
    bf = torch.bfloat16
    q = torch.from_numpy(rng.randn(Bn, H, D).astype(np.float32)).to(bf)
    kp = torch.from_numpy(rng.randn(nb, bs, hkv, D).astype(np.float32)).to(bf)
    vp = torch.from_numpy(rng.randn(nb, bs, hkv, D).astype(np.float32)).to(bf)
    bt = torch.from_numpy((rng.permutation(nb - 1)[:Bn * W_] + 1)
                          .reshape(Bn, W_).astype(np.int32))
    lens = torch.tensor([0, 1, T + 1, 2 * T, W_ * bs], dtype=torch.int32)
    want = tpa.paged_attention_reference(q, kp, vp, bt, lens)
    got = tpa.paged_attention_split_reference(q, kp, vp, bt, lens)
    assert row_rel_err(torch, got, want).max().item() <= B4_ROW_REL
    dropped = tpa.paged_attention_reference(
        q, kp, vp, torch.roll(bt, -part_blocks, 1), (lens - T).clamp(min=0))
    assert row_rel_err(torch, dropped, want)[lens > 0].min().item() \
        > B4_ROW_REL

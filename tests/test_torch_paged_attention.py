"""Paged-attention parity: the port's plain `paged_attention_reference`
(ray_tpu_torch/ops/paged_attention.py) against the JAX Pallas kernel in
interpret mode and the JAX reference (ray_tpu/ops/paged_attention.py),
on the same numpy inputs; plus the dispatcher's no-fallback contract.

Tolerance: f32 atol/rtol 1e-5 — the three implementations differ only
in summation order (online vs one-shot softmax, einsum order)."""

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
    import jax.numpy as jnp
    from ray_tpu.ops import paged_attention as jpa
    out = {}
    for g in GROUPS:
        args = [jnp.asarray(a) for a in _inputs(g)]
        out[g] = (np.asarray(jpa.paged_attention_kernel(*args,
                                                        interpret=True)),
                  np.asarray(jpa.paged_attention_reference(*args)))
    return out


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

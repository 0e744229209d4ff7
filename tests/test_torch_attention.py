"""Flash-attention parity: the port's plain attention
(ray_tpu_torch/ops/attention.py) against the JAX package's
`flash_attention_with_lse` (Pallas kernels in interpret mode on the CPU)
and its `jax.vjp`, on the same numpy inputs; the autograd Function's plain
path against torch autograd of the reference; the shape gates against
JAX's.

Tolerance: f32, 1e-5 for o/lse and 1e-4 for gradients — the
implementations differ only in summation order (online vs one-shot
softmax, blocked vs whole products)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as ta
from test_torch_transformer import in_threads

# name -> (B, Hq, Hkv, Sq, Sk, D, causal)
CASES = {
    "causal": (1, 4, 2, 256, 256, 64, True),
    "noncausal": (1, 4, 2, 256, 256, 64, False),
    "cross_causal": (1, 4, 2, 128, 256, 64, True),
    # Where the bf16 kernels branch: head dim 128 with a group of 4 (a
    # 64-query tile in B2, 64-key tiles in B3), and a group of 1.
    "d128_group4": (1, 4, 1, 128, 256, 128, True),
    "group1": (1, 2, 2, 256, 256, 64, True),
}
DLSE = ("zero", "nonzero")
BLOCK = 128


def _inputs(name, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal = CASES[name]
    rng = np.random.RandomState(seed + sum(map(ord, name)))
    q = rng.randn(B, Hq, Sq, D).astype(np.float32)
    k = rng.randn(B, Hkv, Sk, D).astype(np.float32)
    v = rng.randn(B, Hkv, Sk, D).astype(np.float32)
    do = rng.randn(B, Hq, Sq, D).astype(np.float32)
    dlse = rng.randn(B, Hq, Sq).astype(np.float32)
    return q, k, v, do, dlse, causal


@pytest.fixture(scope="module")
def jax_results():
    """JAX flash (interpret mode) outputs and vjp under (do, dlse) with
    dlse zero and nonzero, per case, computed once."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops import attention as ja

    def run(name):
        q, k, v, do, dlse, causal = _inputs(name)

        def f(q_, k_, v_, causal=causal):
            return ja.flash_attention_with_lse(q_, k_, v_, causal=causal,
                                               block_q=BLOCK, block_k=BLOCK)

        @jax.jit
        def both(q_, k_, v_, do_, dlse_, f=f):
            # Forward and the vjp under both dlse modes (DLSE order, one
            # vmapped backward) in one program: eager dispatch of the
            # interpreted kernels costs more than compiling them.
            (o, lse), vjp = jax.vjp(f, q_, k_, v_)
            return o, lse, jax.vmap(vjp)((
                jnp.stack([do_, do_]),
                jnp.stack([jnp.zeros_like(dlse_), dlse_])))

        o, lse, grads = jax.tree.map(np.asarray, both(q, k, v, do, dlse))
        return o, lse, {m: [g[i] for g in grads] for i, m in enumerate(DLSE)}

    return in_threads(run, CASES)


def _flat(x):
    return torch.from_numpy(np.array(x.reshape((-1,) + x.shape[2:])))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_forward_matches_jax_flash(jax_results, name):
    q, k, v, _, _, causal = _inputs(name)
    o_j, lse_j, _ = jax_results[name]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = ta.attention_reference_with_lse(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), o_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=1e-5)
    o2 = ta.attention(tq, tk, tv, causal, impl="auto")
    np.testing.assert_allclose(o2.numpy(), o_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", DLSE)
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_reference_matches_jax_vjp(jax_results, name, mode):
    q, k, v, do, dlse, causal = _inputs(name)
    o_j, lse_j, grads_j = jax_results[name]
    D = q.shape[-1]
    dl = _flat(dlse) if mode == "nonzero" else None
    got = ta.flash_attention_bwd_reference(
        _flat(q), _flat(k), _flat(v), _flat(o_j), _flat(lse_j), _flat(do),
        dl, 1.0 / np.sqrt(D), causal)
    for g, want in zip(got, grads_j[mode]):
        np.testing.assert_allclose(g.numpy(), want.reshape(g.shape),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", DLSE)
@pytest.mark.parametrize("name", sorted(CASES))
def test_function_plain_path_matches_autograd_of_reference(name, mode):
    q, k, v, do, dlse, causal = _inputs(name)
    D = q.shape[-1]
    scale = 1.0 / np.sqrt(D)
    dl = _flat(dlse) if mode == "nonzero" else torch.zeros(_flat(dlse).shape)

    def grads(fn):
        tq, tk, tv = (_flat(x).requires_grad_() for x in (q, k, v))
        o, lse = fn(tq, tk, tv)
        loss = (o * _flat(do)).sum() + (lse * dl).sum()
        return [o.detach(), lse.detach()] + list(
            torch.autograd.grad(loss, (tq, tk, tv)))

    got = grads(lambda a, b, c: ta.FlashAttention.apply(a, b, c, scale,
                                                        causal))
    want = grads(lambda a, b, c: ta._flash_fwd_reference(a, b, c, scale,
                                                         causal))
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol,
                                   rtol=tol)


def test_function_backward_with_unused_outputs():
    """Only o used (dlse None) and only lse used (do None)."""
    q, k, v, do, dlse, causal = _inputs("causal")
    scale = 1.0 / np.sqrt(q.shape[-1])
    for use in ("o", "lse"):
        res = []
        for fn in (ta.FlashAttention.apply, None):
            tq, tk, tv = (_flat(x).requires_grad_() for x in (q, k, v))
            if fn is None:
                o, lse = ta._flash_fwd_reference(tq, tk, tv, scale, causal)
            else:
                o, lse = fn(tq, tk, tv, scale, causal)
            loss = ((o * _flat(do)).sum() if use == "o"
                    else (lse * _flat(dlse)).sum())
            gs = torch.autograd.grad(loss, (tq, tk, tv), allow_unused=True)
            res.append([torch.zeros_like(t) if g is None else g
                        for g, t in zip(gs, (tq, tk, tv))])
        for g, w in zip(*res):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                       rtol=1e-4)


GATE_SHAPES = [  # (q shape, k shape, causal)
    ((1, 4, 256, 64), (1, 2, 256, 64), True),
    ((1, 4, 128, 64), (1, 2, 256, 64), True),
    ((1, 4, 256, 64), (1, 2, 128, 64), True),      # causal sq > sk
    ((1, 4, 256, 64), (1, 2, 128, 64), False),
    ((1, 4, 200, 64), (1, 2, 200, 64), True),      # ragged
    ((1, 4, 64, 64), (1, 4, 64, 64), False),       # one short block
    ((1, 4, 256, 96), (1, 2, 256, 96), True),      # head dim
    ((1, 6, 256, 64), (1, 4, 256, 64), True),      # Hq % Hkv
    ((1, 4, 256, 192), (1, 1, 384, 192), False),
]


@pytest.mark.parametrize("qs,ks,causal", GATE_SHAPES)
def test_gates_match_jax(qs, ks, causal):
    import jax.numpy as jnp
    from ray_tpu.ops import attention as ja
    jq, jk = jnp.zeros(qs), jnp.zeros(ks)
    tq, tk = torch.zeros(qs), torch.zeros(ks)
    assert ta._flash_ok(tq, tk, causal) == ja._flash_ok(jq, jk, causal)

    def outcome(fn, *args):
        try:
            fn(*args)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(ta._validate_flash, tq, tk, causal, 512, 512) == \
        outcome(ja._validate_flash, jq, jk, causal, 512, 512)
    for s in (qs[2], ks[2]):
        for b in (512, 256, 96):
            assert outcome(ta._pick_block, s, b) == \
                outcome(ja._pick_block, s, b)
            if outcome(ta._pick_block, s, b) is None:
                assert ta._pick_block(s, b) == ja._pick_block(s, b)


def test_flash_impl_on_cpu_raises_instead_of_falling_back():
    q, k, v, _, _, causal = _inputs("causal")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = dict(ta.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ta.attention(tq, tk, tv, causal, impl="flash")
    with pytest.raises(ValueError, match="CUDA"):
        ta.attention_with_lse(tq, tk, tv, causal, impl="flash")
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention_fwd_kernel(_flat(q), _flat(k), _flat(v), 0.125,
                                      causal)
    with pytest.raises(ValueError, match="impl"):
        ta.attention(tq, tk, tv, causal, impl="pallas")
    # "auto" on CPU tensors runs the Function's plain path.
    o, _ = ta.attention_with_lse(tq.requires_grad_(), tk, tv, causal)
    fn = o.grad_fn.next_functions[0][0]          # under the reshape
    assert type(fn).__name__ == "FlashAttentionBackward"
    assert ta.launches == before

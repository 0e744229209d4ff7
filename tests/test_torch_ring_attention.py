"""Ring attention parity: the port's per-rank body
(`ops/ring_attention.py` `_ring_attention_sharded`), run for every rank
of an n-rank ring in one process through its rotation seam
(`_virtual_ring`), against the JAX package's `ring_attention` on
conftest's CPU mesh: sp 2, 4 and 8, causal and not, and a GQA case (8
heads, 2 kv heads); the gradients of sum(o**2) in q, k and v against
`jax.grad` of the same; `_merge` on a fully masked pair; that a shard
routed to the kernels raises on a shape they cannot tile; and
`flash_attention_with_lse`'s `save_residuals` argument.  The ring on a
real sp mesh (gloo ranks), and the bytes one remat layer's ring saves,
are in tests/test_torch_moe_pp.py.

Tolerances are JAX's own ring test's (f32): output 2e-5, gradients
1e-4."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import ring_attention as rt
from test_torch_transformer import in_threads

SHAPE = dict(b=2, h=4, s=256, d=32)
# name -> (sp, causal, heads, kv heads, gradients too)
CASES = {f"sp{sp}_{'causal' if causal else 'full'}": (sp, causal, 4, 4, False)
         for sp in (2, 4, 8) for causal in (False, True)}
CASES["gqa_sp4"] = (4, True, 8, 2, True)        # and the gradients


def _inputs(h, hkv, seed=0):
    rng = np.random.RandomState(seed)
    b, s, d = SHAPE["b"], SHAPE["s"], SHAPE["d"]
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.fixture(scope="module")
def jax_side(cpu_mesh_devices):
    """Per case: JAX's ring output, and its gradients of sum(o**2)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops.ring_attention import ring_attention
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh

    def run(name):
        sp, causal, h, hkv, grads = CASES[name]
        mesh = make_mesh(MeshSpec(sp=sp))

        def ring(q, k, v):
            return ring_attention(q, k, v, mesh, axis_name="sp",
                                  causal=causal)

        inputs = _inputs(h, hkv)
        if not grads:
            return {"o": np.asarray(jax.jit(ring)(*inputs))}

        def loss(q, k, v):
            o = ring(q, k, v)
            return jnp.sum(o ** 2), o

        (_, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*inputs)
        return {"o": np.asarray(o), "grads": [np.asarray(x) for x in g]}

    return in_threads(run, CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_body_matches_jax_ring(jax_side, name):
    sp, causal, h, hkv, grads = CASES[name]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(h, hkv))
    o = rt._virtual_ring(q, k, v, sp, causal=causal)
    want = jax_side[name]
    np.testing.assert_allclose(o.detach().numpy(), want["o"], atol=2e-5,
                               rtol=2e-5)
    if grads:
        got = torch.autograd.grad((o ** 2).sum(), (q, k, v))
        for g, w, which in zip(got, want["grads"], "qkv"):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                       err_msg=f"d{which}")


def test_rotation_hands_each_rank_the_shard_of_rank_minus_t():
    """The body asks for shard (rank - t) mod n at step t, after issuing
    the next step's rotation before the current step's attention."""
    n, seen = 4, []
    q = torch.zeros(1, 1, 8, 4)
    shards = [torch.full((1, 1, 8, 4), float(r)) for r in range(n)]
    for rank in range(n):
        def rotate(t, k, v, rank=rank):
            seen.append((rank, t, int(k[0, 0, 0, 0])))
            src = (rank - t) % n
            return lambda: (shards[src], shards[src])
        rt._ring_attention_sharded(q, shards[rank], shards[rank], n=n,
                                   rank=rank, rotate=rotate, causal=True,
                                   scale=1.0)
    # Each rotation starts from the shard held at step t - 1.
    assert seen == [(r, t, (r - t + 1) % n) for r in range(n)
                    for t in range(1, n)]


def test_merge_of_fully_masked_pair_has_weight_zero_and_no_nan():
    o_a = torch.randn(2, 3, 4, requires_grad=True)
    o_b = torch.randn(2, 3, 4, requires_grad=True)
    lse_a = torch.full((2, 3), fa.NEG_INF, requires_grad=True)
    lse_b = torch.full((2, 3), fa.NEG_INF, requires_grad=True)
    o, lse = rt._merge(o_a, lse_a, o_b, lse_b)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(lse, torch.full_like(lse, fa.NEG_INF))
    grads = torch.autograd.grad((o * 3).sum() + lse.sum(),
                                (o_a, lse_a, o_b, lse_b))
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.equal(grads[0], torch.zeros_like(o_a))
    # One live side keeps its value exactly; the masked one has weight 0.
    lse_live = torch.randn(2, 3)
    o, lse = rt._merge(o_a, lse_live, o_b, lse_b)
    np.testing.assert_allclose(o.detach().numpy(), o_a.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(lse.detach(), lse_live)


def test_save_residuals_takes_a_bool_only():
    q = torch.zeros(1, 2, 128, 64)
    with pytest.raises(TypeError, match="save_residuals"):
        fa.flash_attention_with_lse(q, q, q, save_residuals="names")
    # A bool passes the check; the kernels then take CUDA tensors only.
    for value in (True, False):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fa.flash_attention_with_lse(q, q, q, save_residuals=value)


@pytest.mark.parametrize("seq, d, match", [(768, 64, "128-lane tile"),
                                           (512, 32, "head_dim 32")])
def test_kernel_routed_shard_that_does_not_tile_raises(seq, d, match,
                                                       monkeypatch):
    """A shard routed to the kernels (impl "flash", as every CUDA tensor
    is under "auto") raises on a shape they cannot tile (192-token shards
    of a 768-token sp 4 ring; head dim 32) and never falls back to the
    reference."""
    def no_reference(*a, **k):
        raise AssertionError("a kernel-routed shard reached the reference")

    monkeypatch.setattr(rt, "attention_reference_with_lse", no_reference)
    q = torch.zeros(1, 2, seq, d)
    with pytest.raises(ValueError, match=match):
        rt._virtual_ring(q, q, q, 4, causal=True, impl="flash")

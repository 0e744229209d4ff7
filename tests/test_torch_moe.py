"""MoE parity: the port's `models/transformer.py` `_moe_block` (index-based
dispatch) against the JAX package's dense one-hot block on the same
inputs, dropped pairs included; forward, loss (with the aux term) and
every gradient of tiny llama-MoE and gpt2-MoE models against JAX through
`convert.params_from_jax`; remat policies; identical experts equal the
dense model.

Tolerance: f32 on both sides, summation order only: 1e-5 on outputs and
loss, 1e-4 on gradients; remat against no remat 1e-6 (the recomputation
repeats the same operations)."""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt
from test_torch_transformer import in_threads, numpy_params

ARCHS = {
    # capacity 1.0 at T 32: cap 16 per expert, so a skewed router drops.
    "llama": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=48, max_seq=32, arch="llama",
                  moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
                  remat=False),
    "gpt2": dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                 d_ff=48, max_seq=32, arch="gpt2", rope_theta=0.0,
                 moe_experts=4, moe_top_k=2, remat=False),
}
B, S = 2, 17
# The block alone: T = 24 tokens, E 4, top-2 at capacity factor 0.5
# (cap 6 of the 48 pairs' 12 a balanced expert would get): pairs drop.
BLOCK = dict(ARCHS["llama"], moe_capacity_factor=0.5)
BLOCK_NO_DROP = dict(BLOCK, moe_capacity_factor=4.0)
BLOCK_SHAPE = (2, 12, 32)
MOE_KEYS = ("w_down", "w_gate", "w_router", "w_up")


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


def _tokens(arch):
    rng = np.random.RandomState(len(arch))
    return rng.randint(0, ARCHS[arch]["vocab_size"], (B, S)).astype(np.int32)


def _port_cfg(kw, **over):
    return tt.TransformerConfig(**{**kw, "dtype": torch.float32, **over})


@pytest.fixture(scope="module")
def jax_side():
    """The block (out, aux, vjp grads, and out without drops) and, per
    arch, params, logits, (loss, metrics, grads)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt

    def jcfg(kw):
        return jt.TransformerConfig(**{**kw, "dtype": jnp.float32})

    def arch_side(arch):
        cfg = jcfg(ARCHS[arch])
        params = numpy_params(_port_cfg(ARCHS[arch]), 0)
        tokens = jnp.asarray(_tokens(arch))

        def everything(p):
            logits = jt.forward(p, tokens[:, :-1], cfg)
            (loss, metrics), grads = jax.value_and_grad(
                lambda p_: jt.loss_fn(p_, tokens, cfg), has_aux=True)(p)
            return logits, loss, metrics, grads

        got = jax.tree.map(np.asarray, jax.jit(everything)(params))
        return {"params": params, "logits": got[0], "loss": float(got[1]),
                "metrics": {k: float(v) for k, v in got[2].items()},
                "grads": got[3]}

    return in_threads(lambda k: _jax_block(jcfg(BLOCK)) if k == "block"
                      else arch_side(k), ["block", *ARCHS])


def _jax_block(cfg):
    """The JAX block's out, aux and vjp on the BLOCK inputs, and its out
    at BLOCK_NO_DROP's capacity, where nothing drops."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    no_drop_cfg = dataclasses.replace(cfg, moe_capacity_factor=BLOCK_NO_DROP[
        "moe_capacity_factor"])
    params = numpy_params(_port_cfg(BLOCK), 3)
    p0 = {k: params["layers"][k][0] for k in MOE_KEYS}
    rng = np.random.RandomState(4)
    h = rng.randn(*BLOCK_SHAPE).astype(np.float32)
    cot = rng.randn(*BLOCK_SHAPE).astype(np.float32)
    aux_cot = np.float32(0.7)

    @jax.jit
    def block(h_, p_, cot_):
        (o_, aux_), vjp = jax.vjp(
            lambda a, b: jt._moe_block(cfg, None, a, b), h_, p_)
        no_drop_ = jt._moe_block(no_drop_cfg, None, h_, p_)[0]
        return o_, aux_, vjp((cot_, jnp.float32(aux_cot))), no_drop_

    o, aux, (gh, gp), no_drop = block(jnp.asarray(h), p0, jnp.asarray(cot))
    return {"h": h, "cot": cot, "aux_cot": aux_cot,
            "p": p0, "out": np.asarray(o),
            "aux": float(aux), "grad_h": np.asarray(gh),
            "grad_p": jax.tree.map(np.asarray, gp),
            "out_no_drop": np.asarray(no_drop)}


def test_moe_block_matches_jax_with_drops(jax_side):
    ref = jax_side["block"]
    cfg = _port_cfg(BLOCK)
    h = torch.tensor(ref["h"], requires_grad=True)
    p = {k: torch.tensor(ref["p"][k], requires_grad=True) for k in MOE_KEYS}
    out, aux = tt._moe_block(cfg, h, p)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux.item(), ref["aux"], atol=1e-5, rtol=1e-5)
    # Pairs drop on both sides: JAX's output moves on the tokens that
    # lost a pair when capacity is ample, and the port's slots mark the
    # same number of pairs dropped.
    changed = np.abs(ref["out"] - ref["out_no_drop"]).max(-1) > 1e-6
    _, _, _, slots, cap = tt._moe_route(cfg, h.detach().reshape(-1, 32),
                                        p["w_router"].detach())
    dropped = slots == cfg.moe_experts * cap
    assert changed.sum() >= 1
    assert dropped.any(-1).reshape(changed.shape).numpy().tolist() \
        == changed.tolist()
    grads = torch.autograd.grad(
        (out * torch.from_numpy(ref["cot"])).sum()
        + aux * float(ref["aux_cot"]), [h] + [p[k] for k in sorted(p)])
    np.testing.assert_allclose(grads[0].numpy(), ref["grad_h"], atol=1e-4,
                               rtol=1e-4)
    for name, g in zip(sorted(p), grads[1:]):
        np.testing.assert_allclose(g.numpy(), ref["grad_p"][name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def _port_params(jax_side, arch):
    params = convert.params_from_jax(jax_side[arch]["params"],
                                     _port_cfg(ARCHS[arch]), device="cpu")
    for _, p in _leaves(params):
        p.requires_grad_(True)
    return params


def _port_loss_grads(params, arch, **kw):
    loss, metrics = tt.loss_fn(params, torch.from_numpy(_tokens(arch)),
                               _port_cfg(ARCHS[arch], **kw))
    names, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_model_matches_jax(jax_side, arch):
    ref = jax_side[arch]
    params = _port_params(jax_side, arch)
    with torch.no_grad():
        logits = tt.forward(params, torch.from_numpy(_tokens(arch))[:, :-1],
                            _port_cfg(ARCHS[arch]))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=1e-5,
                               rtol=1e-5)
    loss, metrics, grads = _port_loss_grads(params, arch)
    assert sorted(metrics) == sorted(ref["metrics"])
    for key, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[key].item(), want, atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(loss, ref["loss"], atol=1e-5, rtol=1e-5)
    assert ref["metrics"]["moe_aux"] > 0
    want = dict(_leaves(ref["grads"]))
    assert sorted(grads) == sorted(want)
    assert "layers/w_router" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("policy", ["names", "dots", "nothing"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_remat_policies_keep_gradients(jax_side, arch, policy):
    params = _port_params(jax_side, arch)
    loss0, _, g0 = _port_loss_grads(params, arch)
    loss1, _, g1 = _port_loss_grads(params, arch, remat=True,
                                    remat_policy=policy)
    assert abs(loss0 - loss1) <= 1e-6
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_dots_policy_recomputes_batched_expert_products():
    """JAX's "dots" saves only products without batch dims: the einsums
    (a bmm of batch 1 here) and the router's mm, not the expert bmm."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    save = CheckpointPolicy.MUST_SAVE
    a1, a8 = torch.zeros(1, 2, 3), torch.zeros(8, 2, 3)
    assert tt._save_matmuls(None, aten.bmm.default, a1, a1) == save
    assert tt._save_matmuls(None, aten.mm.default, a1[0], a1[0]) == save
    assert tt._save_matmuls(None, aten.bmm.default, a8, a8) != save


@pytest.mark.parametrize("top_k", [1, 2])
def test_identical_experts_equal_dense(top_k):
    """MoE whose experts all equal the dense llama MLP == the dense
    model: the gates sum to 1 and ample capacity drops nothing (the
    port's counterpart of tests/test_moe_pp.py)."""
    dense_kw = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                    d_ff=64, max_seq=64, remat=False, xent_chunk=None)
    dense_cfg = _port_cfg(dense_kw)
    moe_cfg = _port_cfg(dense_kw, moe_experts=4, moe_top_k=top_k,
                        moe_capacity_factor=8.0)
    dense = tt.init_params(dense_cfg, seed=0, device="cpu")
    moe = tt.init_params(moe_cfg, seed=0, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        w = dense["layers"][name]
        moe["layers"][name] = w[:, None].expand(w.shape[0], 4,
                                                *w.shape[1:]).clone()
    for name, w in dense["layers"].items():
        if name not in ("w_gate", "w_up", "w_down"):
            moe["layers"][name] = w
    for name in ("tok_embed", "final_norm", "lm_head"):
        moe[name] = dense[name]
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 97, (8, 33)))
    with torch.no_grad():
        h_dense = tt.forward_hidden(dense, toks, dense_cfg)
        h_moe = tt.forward_hidden(moe, toks, moe_cfg)
    np.testing.assert_allclose(h_moe.numpy(), h_dense.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_param_layout_converts_from_jax():
    """`params_from_jax` takes the MoE layout (router, stacked experts)
    and rejects a dense tree for an MoE config."""
    cfg = _port_cfg(ARCHS["llama"])
    specs = dict(_leaves(tt.param_specs(cfg)))
    assert specs["layers/w_gate"][0] == (2, 4, 32, 48)
    assert specs["layers/w_router"][0] == (2, 32, 4)
    tree = {k: (np.zeros(v[0], np.float32) if not isinstance(v, dict) else
                {kk: np.zeros(vv[0], np.float32) for kk, vv in v.items()})
            for k, v in tt.param_specs(cfg).items()}
    params = convert.params_from_jax(tree, cfg, device="cpu")
    assert tuple(params["layers"]["w_down"].shape) == (2, 4, 48, 32)
    dense = dataclasses.replace(cfg, moe_experts=0)
    with pytest.raises(ValueError, match="differ"):
        convert.params_from_jax(tree, dense, device="cpu")

"""Training-forward parity: the port's `models/transformer.py` forward,
loss and gradients against the JAX package's on the same weights
(`convert.params_from_jax`) and tokens, for llama (GQA) and gpt2 at a tiny
f32 size on the CPU (attention through the reference path on both sides).

Tolerance: 1e-5 on logits and loss, 1e-4 on gradients — f32 on both
sides, differing only in summation order.  Remat policies must give the
same gradients as no remat (1e-6: the recomputation repeats the same
operations)."""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt

ARCHS = {
    "llama": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, max_seq=32, arch="llama", remat=False),
    "gpt2": dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 max_seq=32, arch="gpt2", rope_theta=0.0, remat=False),
}
B, S = 2, 17                      # loss over S - 1 = 16 positions
XENT = {"chunked_padded": 12, "single_chunk": 64, "none": None}
GRAD_XENT = ("chunked_padded", "none")


def _tokens(arch):
    rng = np.random.RandomState(len(arch))
    return rng.randint(0, ARCHS[arch]["vocab_size"], (B, S)).astype(np.int32)


def _port_cfg(arch, **kw):
    return tt.TransformerConfig(**{**ARCHS[arch], "dtype": torch.float32,
                                   **kw})


def numpy_params(cfg, seed):
    """Parameters of `cfg`'s layout (the JAX package's tree has the same
    keys and shapes) drawn with numpy: each init's normal std, ones and
    zeros, in f32.  Both packages take them as given, so no JAX random
    kernel is compiled for a test's weights."""
    rng = np.random.RandomState(seed)

    def make(spec):
        shape, init = spec
        if init in ("ones", "zeros"):
            return getattr(np, init)(shape, np.float32)
        return (rng.standard_normal(shape) * init).astype(np.float32)

    return tt._map_specs(make, tt.param_specs(cfg))


def in_threads(fn, items):
    """{item: fn(item)}, each call in a thread of its own: XLA compiles
    without holding the GIL, so a fixture's JAX programs compile side by
    side."""
    from concurrent.futures import ThreadPoolExecutor
    items = list(items)
    with ThreadPoolExecutor(len(items)) as pool:
        return dict(zip(items, pool.map(fn, items)))


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


@pytest.fixture(scope="module")
def jax_side():
    """Per arch: numpy params, logits, and (loss, grads) per xent mode."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt

    def run(arch):
        cfg = jt.TransformerConfig(**{**ARCHS[arch], "dtype": jnp.float32})
        params = numpy_params(_port_cfg(arch), 0)
        tokens = jnp.asarray(_tokens(arch))
        cfgs = {m: dataclasses.replace(cfg, xent_chunk=c)
                for m, c in XENT.items()}

        def everything(p, cfgs=cfgs, cfg=cfg, tokens=tokens):
            # One jit per arch: logits, and (loss, grads) per xent mode.
            out = {"logits": jt.forward(p, tokens[:, :-1], cfg)}
            for m, c in cfgs.items():
                fn = lambda p_, c=c: jt.loss_fn(p_, tokens, c)[0]
                out[m] = (jax.value_and_grad(fn)(p) if m in GRAD_XENT
                          else (fn(p), None))
            return out

        got = jax.tree.map(np.asarray, jax.jit(everything)(params))
        res = {"params": params,
               "logits": got["logits"]}
        for m in XENT:
            res[m] = (float(got[m][0]), got[m][1])
        return res

    return in_threads(run, ARCHS)


def _port_params(jax_side, arch):
    cfg = _port_cfg(arch)
    params = convert.params_from_jax(jax_side[arch]["params"], cfg,
                                     device="cpu")
    for _, p in _leaves(params):
        p.requires_grad_(True)
    return params


def _port_loss_grads(params, arch, **kw):
    cfg = _port_cfg(arch, **kw)
    tokens = torch.from_numpy(_tokens(arch))
    loss, metrics = tt.loss_fn(params, tokens, cfg)
    names, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad(loss, leaves)
    assert torch.allclose(metrics["ppl"], torch.exp(loss))
    return loss.item(), dict(zip(names, grads))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_match_jax(jax_side, arch):
    params = _port_params(jax_side, arch)
    tokens = torch.from_numpy(_tokens(arch))[:, :-1]
    with torch.no_grad():
        logits = tt.forward(params, tokens, _port_cfg(arch))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jax_side[arch]["logits"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", sorted(XENT))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(jax_side, arch, mode):
    params = _port_params(jax_side, arch)
    want_loss, want_grads = jax_side[arch][mode]
    if want_grads is None:
        with torch.no_grad():
            loss = tt.loss_fn(params, torch.from_numpy(_tokens(arch)),
                              _port_cfg(arch, xent_chunk=XENT[mode]))[0]
        np.testing.assert_allclose(loss.item(), want_loss, atol=1e-5,
                                   rtol=1e-5)
        return
    loss, grads = _port_loss_grads(params, arch, xent_chunk=XENT[mode])
    np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=1e-5)
    want = dict(_leaves(want_grads))
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("policy", ["names", "dots", "nothing"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_policies_keep_gradients(jax_side, arch, policy):
    params = _port_params(jax_side, arch)
    loss0, g0 = _port_loss_grads(params, arch, remat=False)
    loss1, g1 = _port_loss_grads(params, arch, remat=True,
                                 remat_policy=policy)
    assert abs(loss0 - loss1) <= 1e-6
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_unsupported_configs_raise():
    from test_torch_mesh import abstract_mesh
    params = tt.init_params(_port_cfg("llama"), device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    # Meshes run dp/fsdp/tp (tests/test_torch_mesh.py) and sp, ep, pp and
    # MoE (tests/test_torch_moe_pp.py); a head split that does not divide
    # n_kv_heads (2 here) raises, from the loss too.
    for axes in (dict(ep=2), dict(sp=2), dict(pp=2), dict(dp=2, tp=2)):
        tt._check_supported(_port_cfg("llama"), abstract_mesh(axes))
    moe = _port_cfg("llama", moe_experts=4)
    tt._check_supported(moe, abstract_mesh(dict(dp=2, ep=2)))
    moe_params = tt.init_params(moe, device="cpu")
    assert torch.isfinite(tt.forward(moe_params, tokens, moe)).all()
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        tt.loss_fn(params, tokens, _port_cfg("llama"),
                   mesh=abstract_mesh(dict(tp=4)))
    with pytest.raises(ValueError, match="remat_policy"):
        tt.loss_fn(params, tokens, _port_cfg("llama", remat=True,
                                             remat_policy="everything"))

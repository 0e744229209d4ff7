"""Train-step parity: the port's `train/train_step.py` (`make_optimizer`,
`CompiledTrainStep`) against the JAX package's on a one-device CPU mesh,
from the same parameters and tokens, at a tiny f32 llama (GQA) size.

Tolerances.  Loss and grad_norm at every step: 1e-5 (summation order
only).  Parameters: each leaf's change over the three steps, by relative
norm, ||change_port - change_jax|| / ||change_jax||; a norm, so the few
elements where Adam's g / (|g| + eps) turns a last-bit gradient
difference near eps into a large one do not decide it.  At lr 1e-3 the
change is ~1e-3 per element, far above f32 rounding, and weight decay
(0.1 x |p|, |p| >= 0.06 at this init) is >= 6e-3 of it, so a change
limit of 1e-3 also holds the decay.  The bf16 first moment gets the
same limit: both packages round mu to bf16 only where it is stored."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.train import telemetry
from ray_tpu_torch.train import train_step as ts

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, max_seq=32, arch="llama")
B, S, STEPS = 4, 17, 3
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
# name -> optimizer overrides (the gradient norm is ~2.3 here: the
# default clip at 1.0 is active, the clip at 10 is not).
CASES = {
    "mu_f32_unclipped": dict(mu_dtype="float32", grad_clip=10.0),
    "mu_bf16_clipped": dict(),
}
METRIC_TOL = 1e-5
CHANGE_TOL = 1e-3


def _tokens():
    rng = np.random.RandomState(3)
    return rng.randint(0, MODEL["vocab_size"], (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: initial params, per-step (loss, grad_norm), final params
    of the JAX CompiledTrainStep on a one-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts
    cfg = jt.TransformerConfig(**MODEL, dtype=jnp.float32)
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    out = {}
    for name, over in CASES.items():
        step = jts.CompiledTrainStep(
            cfg, mesh, optimizer=jts.make_optimizer(**OPT, **over),
            donate_state=False)
        state = step.init_state(seed=0)
        init = jax.tree.map(np.asarray, state.params)
        batch = step.shard_batch(_tokens())
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = (init, metrics, jax.tree.map(np.asarray, state.params))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax(jax_runs, name):
    over = CASES[name]
    init, want_metrics, want_params = jax_runs[name]
    cfg = tt.TransformerConfig(**MODEL, dtype=torch.float32)
    step = ts.CompiledTrainStep(cfg, optimizer=ts.make_optimizer(**OPT,
                                                                 **over),
                                device="cpu")
    state = step.init_state(params=convert.params_from_jax(init, cfg,
                                                           device="cpu"))
    batch = step.shard_batch(_tokens())
    got = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        got.append((m["loss"].item(), m["grad_norm"].item()))
        assert torch.allclose(m["ppl"], torch.exp(m["loss"]))
    assert state.step == STEPS and state.opt_state["count"] == STEPS
    np.testing.assert_allclose(got, want_metrics, atol=METRIC_TOL,
                               rtol=METRIC_TOL)
    clip = over.get("grad_clip", 1.0)
    if name.endswith("_clipped"):
        assert min(g for _, g in got) > clip
    else:
        assert max(g for _, g in got) < clip
    start, want = dict(_leaves(init)), dict(_leaves(want_params))
    errs = {}
    for key, p in _leaves(state.params):
        change = p.detach().numpy() - start[key]
        want_change = want[key] - start[key]
        errs[key] = (np.linalg.norm(change - want_change)
                     / np.linalg.norm(want_change))
    assert max(errs.values()) <= CHANGE_TOL, errs


def test_schedule_matches_optax():
    import optax
    for warmup, total in ((1, 100), (10, 1000), (2, 2)):
        opt = ts.make_optimizer(learning_rate=3e-4, warmup_steps=warmup,
                                total_steps=total)
        want = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1))
        for count in (0, 1, warmup, warmup + 1, total // 2, total,
                      2 * total):
            np.testing.assert_allclose(opt.lr(count), float(want(count)),
                                       rtol=1e-6, atol=0)
        assert opt.lr(0) == 0.0


def test_step_api_and_unported_options():
    cfg = tt.TransformerConfig(**MODEL, dtype=torch.float32)
    step = ts.CompiledTrainStep(cfg, device="cpu")
    assert step._cache_size() == ts.EAGER_CACHE_SIZE
    n = tt.num_params(tt.init_params(cfg, device="cpu"))
    assert step.flops_per_token(16) == 6.0 * n + 12.0 * 2 * 16 * 64
    assert step.shard_batch(_tokens()).dtype == torch.int64
    state = step.init_state(seed=1)
    assert all(p.requires_grad for _, p in _leaves(state.params))
    assert state.opt_state["mu"]["tok_embed"].dtype == torch.bfloat16
    assert state.opt_state["nu"]["tok_embed"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.make_optimizer(kind="adafactor")
    with pytest.raises(NotImplementedError, match="A6"):
        ts.CompiledTrainStep(cfg, mesh=object(), device="cpu")


def test_peak_flops_known_cards_only():
    assert telemetry.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no peak"):
        telemetry.peak_flops_for("NVIDIA H100 PCIe")

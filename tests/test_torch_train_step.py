"""Train-step parity: the port's `train/train_step.py` (`make_optimizer`,
`CompiledTrainStep`) against the JAX package's on a one-device CPU mesh,
from the same parameters and tokens, at tiny f32 llama (GQA) sizes: AdamW
on a dense model; Adafactor on an MoE model, whose leaves are factored
and unfactored (and on random leaves against optax itself).

Tolerances.  Loss and grad_norm at every step: 1e-5 (summation order
only).  Parameters: each leaf's change over the three steps, by relative
norm, ||change_port - change_jax|| / ||change_jax||; a norm, so the few
elements where Adam's g / (|g| + eps) turns a last-bit gradient
difference near eps into a large one do not decide it.  At lr 1e-3 the
change is ~1e-3 per element, far above f32 rounding, and weight decay
(0.1 x |p|, |p| >= 0.06 at this init) is >= 6e-3 of it, so a change
limit of 1e-3 also holds the decay.  The bf16 first moment gets the
same limit: both packages round mu to bf16 only where it is stored.
Adafactor's factored state (`v_row`, `v_col`) and full `v` against
optax's: 1e-4 by relative norm per leaf (running means of squared
gradients, which agree to 1e-4)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.train import telemetry
from ray_tpu_torch.train import train_step as ts
from test_torch_transformer import in_threads, numpy_params

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, max_seq=32, arch="llama")
# d_model 128: tok_embed, lm_head and the experts' w_gate/w_up/w_down
# have two axes >= 128 and are factored; wq..wo (largest axes 128 and
# 32), w_router and the norms are not.
MOE_MODEL = dict(MODEL, d_model=128, d_ff=128, moe_experts=4, moe_top_k=2)
B, S, STEPS = 4, 17, 3
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
# name -> (model, optimizer overrides).  AdamW: the gradient norm is
# ~2.3 here, so the default clip at 1.0 is active, the clip at 10 not.
CASES = {
    "mu_f32_unclipped": (MODEL, dict(mu_dtype="float32", grad_clip=10.0)),
    "mu_bf16_clipped": (MODEL, dict()),
    "adafactor_moe": (MOE_MODEL, dict(kind="adafactor")),
}
METRIC_TOL = 1e-5
CHANGE_TOL = 1e-3
STATE_TOL = 1e-4


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
    and, for Adafactor, the factored state of the JAX CompiledTrainStep on
    a one-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])

    def run(name):
        model, over = CASES[name]
        cfg = jt.TransformerConfig(**model, dtype=jnp.float32)
        step = jts.CompiledTrainStep(
            cfg, mesh, optimizer=jts.make_optimizer(**OPT, **over),
            donate_state=False)
        # The step's state from numpy weights (the jitted init_state
        # would compile JAX's random kernels for nothing compared here).
        init = numpy_params(tt.TransformerConfig(**model), 0)
        state = jax.jit(lambda p, step=step: jts.TrainState(
            jnp.zeros((), jnp.int32), p, step.optimizer.init(p)),
            out_shardings=step.state_shardings)(init)
        batch = step.shard_batch(_tokens())
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        factored = None
        if over.get("kind") == "adafactor":
            fs = state.opt_state[0]
            factored = {key: jax.tree.map(np.asarray, getattr(fs, key))
                        for key in ("v_row", "v_col", "v")}
        return (init, metrics, jax.tree.map(np.asarray, state.params),
                factored)

    return in_threads(run, CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax(jax_runs, name):
    model, over = CASES[name]
    init, want_metrics, want_params, want_state = jax_runs[name]
    cfg = tt.TransformerConfig(**model, dtype=torch.float32)
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
    elif name.endswith("_unclipped"):
        assert max(g for _, g in got) < clip
    start, want = dict(_leaves(init)), dict(_leaves(want_params))
    errs = {}
    for key, p in _leaves(state.params):
        change = p.detach().numpy() - start[key]
        want_change = want[key] - start[key]
        errs[key] = (np.linalg.norm(change - want_change)
                     / np.linalg.norm(want_change))
    assert max(errs.values()) <= CHANGE_TOL, errs
    if want_state is None:
        return
    factored = 0
    for key, tree in want_state.items():
        for leaf, want in _leaves(tree):
            have = dict(_leaves(state.opt_state[key]))[leaf].numpy()
            assert have.shape == want.shape, (key, leaf)
            factored += key == "v_row" and want.size > 1
            err = np.linalg.norm(have - want) / max(np.linalg.norm(want),
                                                    1e-30)
            assert err <= STATE_TOL, (key, leaf, err)
    assert factored >= 3


def test_adafactor_chunked_leaves_match_optax():
    """Adafactor against optax.adafactor on random leaves, with chunks
    small enough that the factored [2, 3, 130, 200] and [3, 200, 130]
    leaves are walked in 2 and 3 pieces along axis 0 (an unfactored
    axis); [256, 128] is factored over axis 0 and stays whole; [4, 64]
    and [7] are unfactored.  Updates and state to 1e-5 by relative norm
    (the sum of squares for the block RMS adds chunk by chunk)."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.train.train_step import make_optimizer as jax_optimizer
    shapes = {"a": (2, 3, 130, 200), "b": (256, 128), "c": (4, 64),
              "d": (7,), "e": (3, 200, 130)}
    rng = np.random.RandomState(0)
    start = {k: (rng.randn(*v) * 0.05).astype(np.float32)
             for k, v in shapes.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=100,
              kind="adafactor")
    jopt, topt = jax_optimizer(**kw), ts.make_optimizer(**kw)
    topt.chunk_elements = 130 * 200
    update = jax.jit(jopt.update)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    tp = {k: torch.tensor(v) for k, v in start.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(STEPS):
        g = {k: rng.randn(*v).astype(np.float32) for k, v in shapes.items()}
        upd, jstate = update({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jp)
        jp = optax.apply_updates(jp, upd)
        grads = [torch.tensor(g[k]) for k in sorted(g)]
        tstate, _ = topt.update_(grads, tstate, tp)
        assert grads == [None] * len(shapes)      # each dropped when used
    for k in shapes:
        want = np.asarray(jp[k]) - start[k]
        err = np.linalg.norm(tp[k].numpy() - start[k] - want)
        assert err <= 1e-5 * np.linalg.norm(want), k
        for key in ("v_row", "v_col", "v"):
            w = np.asarray(getattr(jstate[0], key)[k])
            h = tstate[key][k].numpy()
            assert h.shape == w.shape
            assert np.linalg.norm(h - w) <= 1e-5 * np.linalg.norm(w), (k,
                                                                      key)


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
    ada = ts.make_optimizer(kind="adafactor")
    assert isinstance(ada, ts.Adafactor)
    with pytest.raises(ValueError, match="optimizer kind"):
        ts.make_optimizer(kind="sgd")
    from test_torch_mesh import abstract_mesh
    # A pp axis is replicated, as in JAX (no rule maps to it); an sp axis
    # splits no parameter (tests/test_torch_moe_pp.py runs both).
    pp = ts.CompiledTrainStep(cfg, mesh=abstract_mesh(dict(pp=2, dp=2)),
                              device="cpu")
    assert repr(pp.param_placements["layers"]["wq"]) == \
        "(Replicate(), Replicate())"
    assert repr(pp.data_placements) == "(Replicate(), Shard(dim=0))"
    sp = ts.CompiledTrainStep(cfg, mesh=abstract_mesh(dict(sp=2)),
                              device="cpu")
    assert repr(sp.data_placements) == "(Replicate(),)"
    with pytest.raises(ValueError, match="does not divide"):
        ts.CompiledTrainStep(cfg, mesh=abstract_mesh(dict(tp=4)),
                             device="cpu")


def test_peak_flops_known_cards_only():
    assert telemetry.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no peak"):
        telemetry.peak_flops_for("NVIDIA H100 PCIe")

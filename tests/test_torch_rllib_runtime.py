"""The port's online RLlib (rollout workers and drivers on the port's
runtime) against the JAX package's.

(a) Each worker's `sample()` — PPO's `RolloutWorker`, `DQNWorker`,
    `SACWorker` (warm-up and stochastic), `VTraceRolloutWorker` (MLP and
    conv) and `MultiAgentWorker` — against the JAX worker class run in
    process, on the same parameters (`convert.py`) and with JAX's draws
    from the same keys given to the port's `draws=` seam: actions,
    rewards, dones and observations equal (SAC's squashed-Gaussian
    actions, and what follows from them, within 1e-5), logp and values
    within 1e-5 abs.
(b) One `train()` of PPO, DQN (prioritized, 3-step), SAC and
    MultiAgentPPO, and `train_async` of IMPALA and APPO, through the
    runtime with 2 CPU workers each, against a JAX reference built in
    process from the JAX worker classes and update functions on the
    same rollouts and draws: each parameter leaf within 1e-5 by relative
    norm, metrics within 1e-5 relative, the result dicts key for key
    (`sample_time_s` and `learn_time_s` are the port's own additions).
    IMPALA and APPO consume batches in arrival order, so the reference
    replays the batches the learner took, in its order.
(c) Save and restore for every algorithm, and tests/test_rllib.py's
    round trip (a restored PPO acts as the saved one and trains on; a
    checkpoint of another class is refused).
(d) IMPALA's counts as tests/test_rllib.py counts them, its report
    written under tmp_path (never into the repo).

One runtime serves the module; every algorithm is built in the module's
first fixture, so all workers start (and import torch) together while
the JAX programs compile in threads.  Sizes: T 8, 2 envs a worker,
hidden 16, 2 epochs x 2 minibatches, 2 grad steps of 8.
"""

import json
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, IMPALAConfig,
                                 MultiAgentPPOConfig, PPOConfig, SACConfig,
                                 convert, optim)
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import sac as tsac
from test_torch_rllib import (LR, PPO_HP, VT_HP, compile_jax, conv_params,
                              flat, mlp_params, rel_err)

T, ENVS, WORKERS, HIDDEN = 8, 2, 2, 16
A = 2
EPOCHS = MINIBATCHES = GRAD_STEPS = 2
BATCH = 8
LEAF_TOL, METRIC_RTOL, METRIC_ATOL, OBS_TOL = 1e-5, 1e-5, 1e-7, 1e-5
# APPO's pg_loss is the mean of a surrogate over normalized advantages: it
# cancels to ~1e-5 from terms of order 1, so f32 summation order shows
# at a few 1e-7 (the other metrics hold METRIC_ATOL).
CANCELLING_ATOL = 1e-6
MA_MAPPING = {"agent_0": "a", "agent_1": "b"}
MA_POLICIES = {"a": {"obs_size": 4, "num_actions": A},
               "b": {"obs_size": 4, "num_actions": A}}
# The keys of each JAX algorithm's result dict.
PPO_KEYS = {"training_iteration", "episode_reward_mean",
            "episodes_this_iter", "timesteps_this_iter", "time_this_iter_s",
            "pg_loss", "vf_loss", "entropy"}
DQN_KEYS = {"training_iteration", "episode_reward_mean",
            "episodes_this_iter", "timesteps_this_iter", "buffer_size",
            "epsilon", "loss", "time_this_iter_s"}
SAC_KEYS = {"training_iteration", "episode_reward_mean",
            "episodes_this_iter", "timesteps_this_iter", "buffer_size",
            "critic_loss", "actor_loss", "alpha", "entropy",
            "time_this_iter_s"}
MA_KEYS = {"training_iteration", "episode_reward_mean",
           "episodes_this_iter", "timesteps_this_iter", "per_policy",
           "time_this_iter_s"}
ASYNC_KEYS = {"num_updates", "episode_reward_mean", "env_steps",
              "learner_steps_per_s", "updates_per_s", "wall_s", "pg_loss",
              "vf_loss", "entropy", "mean_rho", "loss"}
PORT_KEYS = {"sample_time_s", "learn_time_s"}


# ---------------------------------------------------------------------------
# JAX's draws from the keys its workers and updates split
# ---------------------------------------------------------------------------
def key_draws(seed, n, fn):
    """fn(key) for n steps of a JAX worker's `rng, key = split(rng)`."""
    import jax
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(np.asarray(fn(key)))
    return np.stack(out)


def gumbels(seed, shape):
    import jax
    return key_draws(seed, T, lambda k: jax.random.gumbel(k, shape))


def dqn_worker_draws(index):
    """DQNWorker's RandomState(index + 1): a random action row, then a
    coin row, each step."""
    rs = np.random.RandomState(index + 1)
    random, uniform = [], []
    for _ in range(T):
        random.append(rs.randint(0, A, size=ENVS))
        uniform.append(rs.rand(ENVS))
    return {"random": np.stack(random), "uniform": np.stack(uniform)}


def ma_worker_draws(index, lanes):
    """MultiAgentWorker's key: each step, one split per policy in lane
    order."""
    import jax
    rng = jax.random.PRNGKey(index)
    out = {pid: [] for pid in lanes}
    for _ in range(T):
        for pid, n in lanes.items():
            rng, key = jax.random.split(rng)
            out[pid].append(np.asarray(jax.random.gumbel(key, (n, A))))
    return {"gumbel": {pid: np.stack(v) for pid, v in out.items()}}


def perms(key, n):
    import jax
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, EPOCHS)])


def dqn_ix(key, n):
    import jax
    return np.stack([np.asarray(jax.random.randint(k, (BATCH,), 0, n))
                     for k in jax.random.split(key, GRAD_STEPS)])


def sac_draws(key, n):
    import jax
    out = {"ix": [], "noise_next": [], "noise_pi": []}
    for kk in jax.random.split(key, GRAD_STEPS):
        k1, k2, k3 = jax.random.split(kk, 3)
        out["ix"].append(jax.random.randint(k1, (BATCH,), 0, n))
        out["noise_next"].append(jax.random.normal(k2, (BATCH, 1)))
        out["noise_pi"].append(jax.random.normal(k3, (BATCH, 1)))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
def to_jax(tree):
    """A copy of the port's tree as numpy in JAX's layout (the port's
    updates change its tensors in place; a view would follow them)."""
    return optim.tree_map(np.array, convert.params_to_jax(tree))


def assert_leaves(port_tree, jax_tree, tol=LEAF_TOL):
    """Each leaf of the port's tree against JAX's, by relative norm."""
    port = convert.params_to_jax(port_tree)
    for (path, p), (_, j) in zip(flat(port), flat(jax_tree)):
        assert rel_err(p, j) <= tol, (path, rel_err(p, j))


def assert_metric(got, want, name, atol=METRIC_ATOL):
    np.testing.assert_allclose(float(got), float(want), rtol=METRIC_RTOL,
                               atol=atol, err_msg=name)


def assert_keys(result, jax_keys):
    assert set(result) == jax_keys | PORT_KEYS, set(result) ^ (
        jax_keys | PORT_KEYS)


def assert_rollout(port, want, approx=()):
    """Every array of a rollout: equal, or within OBS_TOL for `approx`
    keys; logp and values within 1e-5."""
    assert set(port) == set(want)
    for k, w in want.items():
        g = port[k]
        if k == "episode_returns":
            np.testing.assert_allclose(g, w, atol=1e-3, err_msg=k)
        elif k in ("logp", "values") or k in approx:
            np.testing.assert_allclose(g, w, atol=OBS_TOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)
            assert np.asarray(g).dtype == np.asarray(w).dtype, k


def concat(samples, keys):
    return {k: np.concatenate([s[k] for s in samples], axis=1)
            for k in keys}


def adam_init(tree):
    import optax
    return optax.adam(LR).init(tree)


def host(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------
def _configs():
    ppo = PPOConfig().rollouts(num_rollout_workers=WORKERS,
                               num_envs_per_worker=ENVS, rollout_len=T)
    ppo.training(lr=LR, num_epochs=EPOCHS, num_minibatches=MINIBATCHES,
                 hidden=HIDDEN)
    dqn = DQNConfig().rollouts(
        num_rollout_workers=WORKERS, num_envs_per_worker=ENVS,
        rollout_len=T, lr=LR, hidden=HIDDEN, learning_starts=16,
        batch_size=BATCH, num_grad_steps=GRAD_STEPS, epsilon_start=0.5,
        prioritized_replay=True, n_step=3, buffer_capacity=256)
    sac = SACConfig().rollouts(
        num_rollout_workers=WORKERS, num_envs_per_worker=ENVS,
        rollout_len=T, actor_lr=LR, critic_lr=LR, alpha_lr=LR,
        hidden=HIDDEN, learning_starts=WORKERS * ENVS * T,
        batch_size=BATCH, num_grad_steps=GRAD_STEPS, buffer_capacity=256)
    impala = IMPALAConfig().rollouts(
        num_rollout_workers=WORKERS, num_envs_per_worker=ENVS,
        rollout_len=T, lr=LR, hidden=HIDDEN)
    appo = APPOConfig().rollouts(
        num_rollout_workers=WORKERS, num_envs_per_worker=ENVS,
        rollout_len=T, lr=LR, hidden=HIDDEN, target_update_freq=2)
    ma = MultiAgentPPOConfig().rollouts(
        num_rollout_workers=WORKERS, num_envs_per_worker=ENVS,
        rollout_len=T, lr=LR, hidden=HIDDEN, num_epochs=EPOCHS,
        num_minibatches=MINIBATCHES).multi_agent(
        policies=MA_POLICIES, policy_mapping=MA_MAPPING)
    # tests/test_rllib.py's save/restore setting
    ppo_one = PPOConfig().rollouts(num_rollout_workers=1,
                                   num_envs_per_worker=2, rollout_len=32)
    ppo_one.training(lr=1e-3, num_epochs=1, num_minibatches=2)
    return {"ppo": ppo, "dqn": dqn, "sac": sac, "impala": impala,
            "appo": appo, "ma": ma, "ppo_one": ppo_one}


def _jax_programs():
    """The JAX updates, compiled in threads for the shapes the tests
    feed them."""
    import jax
    import optax
    from ray_tpu.rllib import appo as ja
    from ray_tpu.rllib import dqn as jd
    from ray_tpu.rllib import impala as ji
    from ray_tpu.rllib import ppo as jp
    from ray_tpu.rllib import sac as js
    from test_torch_rllib import rollout as fake_rollout

    key = jax.random.PRNGKey(0)
    p = mlp_params(0, hidden=HIDDEN)
    roll = fake_rollout(0)                      # [8, 4]: both PPO cases
    vt = {k: v[:ENVS] if k == "last_obs" else v[:, :ENVS]
          for k, v in fake_rollout(0, values=False).items()}
    rs = np.random.RandomState(0)
    n = BATCH * GRAD_STEPS
    dslab = {"obs": rs.standard_normal((n, 4)).astype(np.float32),
             "actions": rs.randint(0, A, n).astype(np.int32),
             "rewards": rs.standard_normal(n).astype(np.float32),
             "next_obs": rs.standard_normal((n, 4)).astype(np.float32),
             "dones": np.zeros(n, np.float32),
             "discounts": np.full(n, 0.99, np.float32),
             "weights": np.ones(n, np.float32)}
    sslab = dict(dslab, obs=rs.standard_normal((n, 3)).astype(np.float32),
                 next_obs=rs.standard_normal((n, 3)).astype(np.float32),
                 actions=rs.standard_normal((n, 1)).astype(np.float32))
    sslab.pop("weights")
    sstate = _sac_state(_sac_tree(0))

    def build(name):
        if name == "ppo":
            f = jp.make_update_fn(optax.adam(LR), num_minibatches=MINIBATCHES,
                                  num_epochs=EPOCHS, **PPO_HP)
            return compile_jax(f, p, adam_init(p), roll, key)
        if name == "dqn":
            f, td = jd.make_update_fn(optax.adam(LR), 0.99, GRAD_STEPS, BATCH)
            return (compile_jax(f, p, p, adam_init(p), dslab, key),
                    jax.jit(td))
        if name == "sac":
            opts = [optax.adam(LR) for _ in range(3)]
            f = js.make_update_fn(*opts, gamma=0.99, tau=0.005,
                                  target_entropy=-1.0,
                                  num_grad_steps=GRAD_STEPS,
                                  batch_size=BATCH, action_scale=2.0)
            return compile_jax(f, sstate, sslab, key)
        if name == "impala":
            f = ji.make_vtrace_update(jp.policy_forward, optax.adam(LR),
                                      **VT_HP)
            return compile_jax(f, p, adam_init(p), vt)
        if name == "appo":
            f = ja.make_appo_update(jp.policy_forward, optax.adam(LR),
                                    clip_param=0.3, target_update_freq=2,
                                    **VT_HP)
            wrapped = (adam_init(p), p, np.int32(0))
            return compile_jax(f, p, wrapped, vt)
        raise KeyError(name)

    pool = ThreadPoolExecutor(5)
    futs = {n: pool.submit(build, n)
            for n in ("ppo", "dqn", "sac", "impala", "appo")}
    pool.shutdown(wait=False)
    return futs


def _sac_tree(seed):
    """SAC's tree at HIDDEN, drawn with numpy."""
    rs = np.random.RandomState(seed)

    def dense(n_in, n_out):
        return {"w": (rs.standard_normal((n_in, n_out))
                      * np.sqrt(2.0 / n_in)).astype(np.float32),
                "b": np.zeros(n_out, np.float32)}

    def mlp(n_in, head, n_out):
        return {"l1": dense(n_in, HIDDEN), "l2": dense(HIDDEN, HIDDEN),
                head: dense(HIDDEN, n_out)}

    actor = mlp(3, "mu", 1)
    actor["log_std"] = dense(HIDDEN, 1)
    return {"actor": actor, "q1": mlp(4, "q", 1), "q2": mlp(4, "q", 1),
            "log_alpha": np.zeros((), np.float32)}


def _sac_state(tree):
    """JAX SAC's learner state from a tree of numpy leaves."""
    import jax
    qs = {"q1": tree["q1"], "q2": tree["q2"]}
    return (tree["actor"], qs, jax.tree.map(np.copy, qs),
            np.asarray(tree["log_alpha"]), adam_init(tree["actor"]),
            adam_init(qs), adam_init(np.asarray(tree["log_alpha"])))


@pytest.fixture(scope="module")
def world():
    """The runtime, every algorithm (their workers start at once) and the
    JAX programs compiling in threads."""
    if ray_tpu_torch.is_initialized():  # a session another module left
        ray_tpu_torch.shutdown()
    jax_futs = _jax_programs()
    ray_tpu_torch.init(num_cpus=14,
                       _system_config={"worker_pool_prestart": 13})
    algos = {}
    try:
        for name, cfg in _configs().items():
            algos[name] = cfg.build(device="cpu")
        yield types.SimpleNamespace(algos=algos, jax=jax_futs)
    finally:
        for algo in algos.values():
            algo.stop()
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# (a) each worker's sample() against the JAX worker's
# ---------------------------------------------------------------------------
def _ppo_case(i):
    from ray_tpu.rllib import ppo as jp
    p = mlp_params(30 + i, hidden=HIDDEN)
    want = jp.RolloutWorker._cls(i, ENVS, T).sample(p)
    got = tppo.RolloutWorker._cls(i, ENVS, T).sample(
        convert.params_from_jax(p, "cpu"),
        draws={"gumbel": gumbels(i, (ENVS, A))})
    return got, want, ()


def _dqn_case(i):
    from ray_tpu.rllib import dqn as jd
    p = mlp_params(32 + i, hidden=HIDDEN)
    want = jd.DQNWorker._cls(i, ENVS, T).sample(p, 0.4)
    got = tdqn.DQNWorker._cls(i, ENVS, T).sample(
        convert.params_from_jax(p, "cpu"), 0.4, draws=dqn_worker_draws(i))
    return got, want, ()


def _sac_case(i, uniform):
    import jax
    from ray_tpu.rllib import sac as js
    actor = _sac_tree(34 + i)["actor"]
    want = js.SACWorker._cls(i, ENVS, T).sample(actor, uniform)
    if uniform:
        draws = {"uniform": key_draws(1234 + i, T, lambda k: (
            jax.random.uniform(k, (ENVS, 1), minval=-2.0, maxval=2.0)))}
    else:
        draws = {"noise": key_draws(1234 + i, T, lambda k: (
            jax.random.normal(k, (ENVS, 1))))}
    got = tsac.SACWorker._cls(i, ENVS, T).sample(
        convert.params_from_jax(actor, "cpu"), uniform, draws=draws)
    approx = () if uniform else ("actions", "obs", "next_obs", "rewards")
    return got, want, approx


def _vtrace_case(i, network):
    from ray_tpu.rllib import impala as ji
    p = (conv_params(36 + i, shape=(40, 60, 2), hidden=HIDDEN)
         if network == "conv" else mlp_params(36 + i, hidden=HIDDEN))
    want = ji.VTraceRolloutWorker(i, ENVS, T, p, network).stream_rollouts(1)
    got = timpala.VTraceRolloutWorker(
        i, ENVS, T, convert.params_from_jax(p, "cpu"), network).sample(
        draws={"gumbel": gumbels(i, (ENVS, A))})
    return got, next(want), ()


def _ma_case(i):
    from ray_tpu.rllib import multi_agent as jm
    p = {pid: mlp_params(38 + k, hidden=HIDDEN)
         for k, pid in enumerate(sorted(MA_POLICIES))}
    want = jm.MultiAgentWorker._cls(
        i, ENVS, T, lambda s: jm.MultiAgentCartPole(num_agents=2, seed=s),
        MA_MAPPING).sample(p)
    got = tma.MultiAgentWorker._cls(
        i, ENVS, T, lambda s: tma.MultiAgentCartPole(num_agents=2, seed=s),
        MA_MAPPING).sample(
        {pid: convert.params_from_jax(t, "cpu") for pid, t in p.items()},
        draws=ma_worker_draws(i, {"a": ENVS, "b": ENVS}))
    return got, want, ()


WORKER_CASES = {
    "ppo": lambda i: _ppo_case(i),
    "dqn": lambda i: _dqn_case(i),
    "sac_uniform": lambda i: _sac_case(i, True),
    "sac": lambda i: _sac_case(i, False),
    "vtrace_mlp": lambda i: _vtrace_case(i, "mlp"),
    "vtrace_conv": lambda i: _vtrace_case(i, "conv"),
    "multi_agent": lambda i: _ma_case(i),
}


@pytest.mark.parametrize("case", list(WORKER_CASES))
def test_worker_sample_matches_jax(world, case):
    got, want, approx = WORKER_CASES[case](1)
    if case == "multi_agent":
        assert got["episode_returns"] == pytest.approx(
            want["episode_returns"])
        assert set(got["per_policy"]) == set(want["per_policy"])
        for pid in want["per_policy"]:
            assert_rollout(got["per_policy"][pid], want["per_policy"][pid])
    else:
        assert_rollout(got, want, approx)


def test_worker_draws_its_own_noise_deterministically():
    """Without draws a worker samples from its own generator, seeded from
    its index: two workers of one index give one rollout."""
    p = convert.params_from_jax(mlp_params(3, hidden=HIDDEN), "cpu")
    a = tppo.RolloutWorker._cls(1, ENVS, T).sample(p)
    b = tppo.RolloutWorker._cls(1, ENVS, T).sample(p)
    c = tppo.RolloutWorker._cls(0, ENVS, T).sample(p)
    for k in ("actions", "logp", "obs"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["obs"], c["obs"])


# ---------------------------------------------------------------------------
# (b) one train() through the runtime against a JAX reference
# ---------------------------------------------------------------------------
def test_ppo_train_matches_jax(world):
    import jax
    from ray_tpu.rllib import ppo as jp
    algo = world.algos["ppo"]
    p0 = to_jax(algo.params)
    samples = [jp.RolloutWorker._cls(i, ENVS, T).sample(p0)
               for i in range(WORKERS)]
    key = jax.random.PRNGKey(5)
    rollout = concat(samples, tppo.ROLLOUT_KEYS)
    got = algo.train(draws={
        "workers": [{"gumbel": gumbels(i, (ENVS, A))}
                    for i in range(WORKERS)],
        "update": {"perms": perms(key, T * ENVS * WORKERS)}})
    p1, _, m = host(world.jax["ppo"].result(timeout=300)(
        p0, adam_init(p0), rollout, key))
    assert_keys(got, PPO_KEYS)
    assert_leaves(algo.params, p1)
    for k in m:
        assert_metric(got[k], m[k], k)
    returns = [r for s in samples for r in s["episode_returns"]]
    assert got["timesteps_this_iter"] == rollout["rewards"].size
    assert got["episodes_this_iter"] == len(returns)
    assert got["episode_reward_mean"] == pytest.approx(
        np.mean(returns) if returns else 0.0)


def test_dqn_prioritized_nstep_train_matches_jax(world):
    import jax
    from ray_tpu.rllib import dqn as jd
    algo = world.algos["dqn"]
    c = algo.config
    p0 = to_jax(algo.params)
    samples = [jd.DQNWorker._cls(i, ENVS, T).sample(p0, c.epsilon_start)
               for i in range(WORKERS)]
    buf = jd.PrioritizedReplayBuffer(c.buffer_capacity, 4,
                                     alpha=c.pr_alpha, beta=c.pr_beta)
    for s in samples:
        t = jd.nstep_transform(s, T, ENVS, c.n_step, c.gamma)
        buf.add_batch(t["obs"], t["actions"], t["rewards"], t["next_obs"],
                      t["dones"], discounts=t["discounts"])
    slab = buf.sample(np.random.RandomState(c.seed),
                      BATCH * GRAD_STEPS)
    ix = slab.pop("indices")
    key = jax.random.PRNGKey(6)
    got = algo.train(draws={
        "workers": [dqn_worker_draws(i) for i in range(WORKERS)],
        "update": {"ix": dqn_ix(key, BATCH * GRAD_STEPS)}})
    update, td_fn = world.jax["dqn"].result(timeout=300)
    p1, _, loss = host(update(p0, p0, adam_init(p0), slab, key))
    buf.update_priorities(ix, np.asarray(td_fn(p1, p0, slab)))
    assert_keys(got, DQN_KEYS)
    assert_leaves(algo.params, p1)
    assert_leaves(algo.target_params, p0, tol=0)    # refreshed every 4
    assert_metric(got["loss"], loss, "loss")
    assert got["buffer_size"] == buf.size
    assert got["epsilon"] == c.epsilon_start
    np.testing.assert_allclose(algo.buffer.priorities, buf.priorities,
                               rtol=1e-5, atol=1e-7)


def test_sac_train_matches_jax(world):
    import jax
    from ray_tpu.rllib import dqn as jd
    from ray_tpu.rllib import sac as js
    algo = world.algos["sac"]
    c = algo.config
    actor, qs, _, log_alpha = (to_jax(t) for t in algo._state[:4])
    samples = [js.SACWorker._cls(i, ENVS, T).sample(actor, True)
               for i in range(WORKERS)]
    buf = jd.ReplayBuffer(c.buffer_capacity, c.obs_size)
    buf.actions = np.zeros((c.buffer_capacity, c.action_size), np.float32)
    for s in samples:
        buf.add_batch(s["obs"], s["actions"], s["rewards"], s["next_obs"],
                      s["dones"])
    slab = buf.sample(np.random.RandomState(c.seed), BATCH * GRAD_STEPS)
    key = jax.random.PRNGKey(7)
    got = algo.train(draws={
        "workers": [{"uniform": key_draws(1234 + i, T, lambda k: (
            jax.random.uniform(k, (ENVS, 1), minval=-2.0, maxval=2.0)))}
            for i in range(WORKERS)],
        "update": sac_draws(key, BATCH * GRAD_STEPS)})
    state0 = _sac_state({"actor": actor, **qs, "log_alpha": log_alpha})
    state1, closs, aloss, ent = host(
        world.jax["sac"].result(timeout=300)(state0, slab, key))
    assert_keys(got, SAC_KEYS)
    for i, name in enumerate(("actor", "qs", "target_qs")):
        assert_leaves(algo._state[i], state1[i])
    assert rel_err(float(algo.log_alpha), float(state1[3])) <= LEAF_TOL
    for k, want in (("critic_loss", closs), ("actor_loss", aloss),
                    ("entropy", ent)):
        assert_metric(got[k], want, k)
    assert got["alpha"] == pytest.approx(float(np.exp(state1[3])),
                                         rel=METRIC_RTOL)


def test_multi_agent_ppo_train_matches_jax(world):
    import jax
    from ray_tpu.rllib import multi_agent as jm
    algo = world.algos["ma"]
    p0 = {pid: to_jax(t) for pid, t in algo.params.items()}
    samples = [jm.MultiAgentWorker._cls(
        i, ENVS, T, lambda s: jm.MultiAgentCartPole(num_agents=2, seed=s),
        MA_MAPPING).sample(p0) for i in range(WORKERS)]
    keys = dict(zip(sorted(MA_POLICIES),
                    jax.random.split(jax.random.PRNGKey(8), 2)))
    got = algo.train(draws={
        "workers": [ma_worker_draws(i, {"a": ENVS, "b": ENVS})
                    for i in range(WORKERS)],
        "update": {pid: {"perms": perms(k, T * ENVS * WORKERS)}
                   for pid, k in keys.items()}})
    assert_keys(got, MA_KEYS)
    update = world.jax["ppo"].result(timeout=300)
    for pid, k in keys.items():
        rollout = concat([s["per_policy"][pid] for s in samples],
                         tppo.ROLLOUT_KEYS)
        p1, _, m = host(update(p0[pid], adam_init(p0[pid]), rollout, k))
        assert_leaves(algo.params[pid], p1)
        for name in m:
            assert_metric(got["per_policy"][pid][name], m[name], name)


def _recording(algo):
    """Record the batches `learn` takes, in the order it takes them."""
    taken, learn = [], algo.learn

    def record(batch):
        taken.append({k: np.array(v) for k, v in batch.items()})
        return learn(batch)

    algo.learn = record
    return taken


@pytest.mark.parametrize("name", ["impala", "appo"])
def test_train_async_matches_jax(world, name):
    algo = world.algos[name]
    p0 = to_jax(algo.params)
    taken = _recording(algo)
    try:
        got = algo.train_async(num_updates=2)
    finally:
        del algo.learn               # the class's own again
    update = world.jax[name].result(timeout=300)
    p, state = p0, adam_init(p0)
    if name == "appo":
        state = (state, p0, np.int32(0))
    for batch in taken:
        p, state, m = host(update(p, state, batch))
    assert len(taken) == 2 and got["num_updates"] == 2
    assert set(got) == ASYNC_KEYS | {"learn_time_s"}
    assert got["env_steps"] == 2 * T * ENVS
    assert_leaves(algo.params, p)
    if name == "appo":          # the target refreshed at update 2
        assert_leaves(algo.opt_state[1], state[1])
        assert algo.opt_state[2] == 2
    for k in m:
        cancels = name == "appo" and k == "pg_loss"
        assert_metric(got[k], m[k], k,
                      CANCELLING_ATOL if cancels else METRIC_ATOL)


# ---------------------------------------------------------------------------
# (c) save and restore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ppo", "dqn", "sac", "impala", "appo",
                                  "ma"])
def test_save_restore_round_trips_learner_state(world, name, tmp_path):
    from ray_tpu_torch.rllib.checkpoint import map_tensors
    algo = world.algos[name]
    saved = {a: map_tensors(lambda t: t.clone(), getattr(algo, a))
             for a in algo._ckpt_attrs}
    path = algo.save(str(tmp_path / name))
    for a in algo._ckpt_attrs:     # scribble over the live state
        setattr(algo, a, map_tensors(torch.zeros_like, getattr(algo, a)))
    algo.restore(path)
    for a, want in saved.items():
        got = getattr(algo, a)
        leaves = []
        map_tensors(leaves.append, got)
        wants = []
        map_tensors(wants.append, want)
        assert len(leaves) == len(wants)
        assert all(torch.equal(g, w) for g, w in zip(leaves, wants)), a
        if not leaves:
            assert got == want, a
    if name == "sac":              # its views follow the restored state
        assert algo.actor is algo._state[0]


def test_algorithm_save_restore(world, tmp_path):
    """tests/test_rllib.py's round trip: a restored PPO acts as the saved
    one and keeps training; another class's restore refuses it."""
    algo = world.algos["ppo_one"]
    algo.train()
    path = algo.save(str(tmp_path / "ck"))
    assert path.endswith("algorithm_state.pkl")
    obs = np.zeros(4, np.float32)
    before = algo.compute_action(obs)
    iteration = algo.iteration
    with torch.no_grad():
        for t in optim.tree_leaves(algo.params):
            t.zero_()
    algo.restore(str(tmp_path / "ck"))
    assert algo.iteration == iteration
    assert algo.compute_action(obs) == before
    assert algo.train()["training_iteration"] == iteration + 1
    with pytest.raises(ValueError, match="written by PPO"):
        world.algos["dqn"].restore(str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# (d) IMPALA's counts
# ---------------------------------------------------------------------------
def test_impala_counts_and_report(world, tmp_path):
    """As tests/test_rllib.py counts: `num_updates` is a total over the
    algorithm's life, `env_steps` this call's consumed batches; the
    report goes under tmp_path."""
    algo = world.algos["impala"]
    done = algo.updates
    out = algo.train_async(num_updates=done + 6)
    assert out["num_updates"] == done + 6
    assert out["env_steps"] == 6 * T * ENVS
    assert all(np.isfinite(out[k]) for k in ASYNC_KEYS)
    again = algo.train_async(num_updates=done + 6)    # nothing left to do
    assert again["num_updates"] == done + 6 and again["env_steps"] == 0
    report = {"metric": "impala_cartpole",
              "learner_steps_per_s": out["learner_steps_per_s"],
              "updates_per_s": out["updates_per_s"],
              "episode_reward_mean": out["episode_reward_mean"],
              "num_updates": out["num_updates"]}
    path = tmp_path / "RLLIB_IMPALA.json"
    path.write_text(json.dumps(report, indent=1))
    assert json.loads(path.read_text())["num_updates"] == done + 6

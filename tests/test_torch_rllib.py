"""Learner parity for the port's on-policy and value learners
(`ray_tpu_torch/rllib/`): PPO with GAE, IMPALA's V-trace on the MLP and
conv policies, APPO, double DQN (plain, and prioritized 3-step batches
with importance weights), and PPO per policy for two policies.  Each
update runs from the same numpy parameters, Adam state and batch through
the JAX package's jitted function and the port's, with the JAX draws of
the same key handed to the port.  Also: the port's own draws, targets in
their own storage, `convert.py` round trips, and the numpy parts the port
copied (envs, connectors, replay buffers, n-step folding) against the
JAX package's.

Sizes are tiny: hidden 16, T 8 x N 4, 2 epochs x 2 minibatches, 2 grad
steps, pixel observations at 10 x 13 (odd SAME padding on both convs).
Tolerance: losses and metrics rel 1e-5 (abs 1e-7 where a value cancels
to near 0); each parameter leaf's change, and each Adam moment, within
1e-4 by relative norm (Adam's g / (|g| + eps) amplifies last-bit gradient
noise where |g| is near eps)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import appo, convert, dqn, impala, optim, ppo
from ray_tpu_torch.rllib.multi_agent import (MultiAgentLearner,
                                             MultiAgentPPOConfig)
from test_torch_transformer import in_threads

HIDDEN, T, N = 16, 8, 4
OBS, ACTS = 4, 2
PIX = (10, 13, 2)
EPOCHS = MINIBATCHES = GRAD_STEPS = 2
DQN_BATCH = 8
PPO_HP = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01, gamma=0.99, lam=0.95)
VT_HP = dict(gamma=0.99, rho_clip=1.0, c_clip=1.0, vf_coef=0.5,
             ent_coef=0.01)
LR = 3e-4
METRIC_RTOL, METRIC_ATOL, CHANGE_TOL = 1e-5, 1e-7, 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def compile_jax(fn, *args):
    """A jitted JAX function compiled for `args` at XLA's backend
    optimization level 0: the same program, in about half the compile
    time."""
    return fn.lower(*args).compile(compiler_options=FAST_COMPILE)


def dense(rs, n_in, n_out):
    return {"w": (rs.standard_normal((n_in, n_out))
                  * np.sqrt(2.0 / n_in)).astype(np.float32),
            "b": (0.1 * rs.standard_normal(n_out)).astype(np.float32)}


def mlp_params(seed, obs=OBS, acts=ACTS, hidden=HIDDEN):
    """The MLP policy's tree, drawn with numpy (biases nonzero)."""
    rs = np.random.RandomState(seed)
    return {"l1": dense(rs, obs, hidden), "l2": dense(rs, hidden, hidden),
            "pi": dense(rs, hidden, acts), "vf": dense(rs, hidden, 1)}


def conv_params(seed, shape=PIX, hidden=HIDDEN):
    """The conv policy's tree in JAX's layout (HWIO kernels)."""
    rs = np.random.RandomState(seed)
    H, W, C = shape

    def conv(cin, cout):
        return {"w": (rs.standard_normal((4, 4, cin, cout))
                      * np.sqrt(2.0 / (cin * 16))).astype(np.float32),
                "b": (0.1 * rs.standard_normal(cout)).astype(np.float32)}

    h4, w4 = ((H + 1) // 2 + 1) // 2, ((W + 1) // 2 + 1) // 2
    return {"c1": conv(C, 8), "c2": conv(8, 16),
            "fc": dense(rs, h4 * w4 * 16, hidden),
            "pi": dense(rs, hidden, ACTS), "vf": dense(rs, hidden, 1)}


def adam_state(tree, seed, count=5):
    """A resumed optax Adam state (mu, nu drawn with numpy), so the port
    continues from JAX's moments rather than from zeros."""
    import optax
    rs = np.random.RandomState(seed)

    def like(scale, positive):
        def leaf(a):
            x = rs.standard_normal(np.shape(a)).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return optim.tree_map(leaf, tree)

    return (optax.ScaleByAdamState(count=np.int32(count),
                                   mu=like(1e-2, False),
                                   nu=like(1e-4, True)),
            optax.EmptyState())


def flat(tree, prefix=""):
    """[(path, array)] of a numpy tree in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    out = []
    for k in sorted(tree):
        out += flat(tree[k], f"{prefix}/{k}")
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den else num


def assert_changes(port_new, jax_new, old, tol=CHANGE_TOL):
    """Each leaf's change (new - old), port against JAX, by relative
    norm; the port's tree given in either package's layout."""
    if not isinstance(next(iter(optim.tree_leaves(port_new))), np.ndarray):
        port_new = convert.params_to_jax(port_new)
    for (path, p), (_, j), (_, o) in zip(flat(port_new), flat(jax_new),
                                         flat(old)):
        err = rel_err(p - o, j - o)
        assert err <= tol, (path, err)


def assert_adam(port_state, jax_state):
    j = jax_state[0] if not hasattr(jax_state, "mu") else jax_state
    p = convert.adam_state_to_jax(port_state)
    assert int(p.count) == int(j.count)
    for mine, theirs in ((p.mu, j.mu), (p.nu, j.nu)):
        for (path, a), (_, b) in zip(flat(mine), flat(theirs)):
            assert rel_err(a, b) <= CHANGE_TOL, (path, rel_err(a, b))


def assert_metrics(port, jax_metrics):
    for k, want in jax_metrics.items():
        np.testing.assert_allclose(float(port[k]), float(want),
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)


def rollout(seed, obs_shape=(OBS,), values=True):
    rs = np.random.RandomState(seed)
    out = {"obs": rs.standard_normal((T, N) + obs_shape).astype(np.float32),
           "actions": rs.randint(0, ACTS, (T, N)).astype(np.int32),
           "logp": np.log(rs.uniform(0.2, 0.8, (T, N))).astype(np.float32),
           "rewards": rs.uniform(0, 1, (T, N)).astype(np.float32),
           "dones": rs.uniform(size=(T, N)) < 0.15}
    if values:
        out["values"] = rs.standard_normal((T + 1, N)).astype(np.float32)
    else:
        out["last_obs"] = rs.standard_normal(
            (N,) + obs_shape).astype(np.float32)
    return out


def pixel_batch(seed):
    b = rollout(seed, values=False)
    rs = np.random.RandomState(seed + 1)
    b["obs"] = rs.uniform(size=(T, N) + PIX).astype(np.float32)
    b["last_obs"] = rs.uniform(size=(N,) + PIX).astype(np.float32)
    return b


def transitions(seed, n):
    rs = np.random.RandomState(seed)
    return {"obs": rs.standard_normal((n, OBS)).astype(np.float32),
            "actions": rs.randint(0, ACTS, n).astype(np.int32),
            "rewards": rs.uniform(0, 1, n).astype(np.float32),
            "next_obs": rs.standard_normal((n, OBS)).astype(np.float32),
            "dones": rs.uniform(size=n) < 0.15}


def prioritized_slab(seed):
    """A prioritized 3-step slab from the port's copied buffer: weights
    from unequal priorities, per-row discounts gamma^k."""
    tr = transitions(seed, T * N)
    folded = dqn.nstep_transform(tr, T, N, 3, 0.99)
    buf = dqn.PrioritizedReplayBuffer(64, OBS)
    ix = buf.add_batch(folded["obs"], folded["actions"],
                       folded["rewards"], folded["next_obs"],
                       folded["dones"], discounts=folded["discounts"])
    buf.update_priorities(ix, np.random.RandomState(seed).standard_normal(
        len(ix)))
    slab = buf.sample(np.random.RandomState(seed + 1),
                      DQN_BATCH * GRAD_STEPS)
    slab.pop("indices")
    return slab


def plain_slab(seed):
    slab = transitions(seed, 24)
    slab["dones"] = slab["dones"].astype(np.float32)
    slab["discounts"] = np.full(24, 0.99, np.float32)
    return slab


MA_POLICIES = {"a": {"obs_size": OBS, "num_actions": ACTS},
               "b": {"obs_size": OBS, "num_actions": ACTS}}


def ma_config():
    return (MultiAgentPPOConfig()
            .training(hidden=HIDDEN, num_minibatches=MINIBATCHES,
                      num_epochs=EPOCHS, lr=LR)
            .multi_agent(policies=MA_POLICIES,
                         policy_mapping={"agent_0": "a", "agent_1": "b"}))


@pytest.fixture(scope="module")
def jax_side():
    """Per case: inputs, the JAX update's outputs and the draws of its
    key, as numpy.  The jitted programs compile in threads."""
    import jax
    import optax
    from ray_tpu.rllib import appo as ja
    from ray_tpu.rllib import dqn as jd
    from ray_tpu.rllib import impala as ji
    from ray_tpu.rllib import ppo as jp

    key = jax.random.PRNGKey(7)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    # One jitted program per shape: PPO's update and permutations serve
    # the single-policy case and both policies; the two DQN slabs share
    # the index draws (n is traced).
    ppo_update = jp.make_update_fn(optax.adam(LR), num_minibatches=2,
                                   num_epochs=2, **PPO_HP)
    perms = jax.jit(lambda k: jax.numpy.stack(
        [jax.random.permutation(kk, T * N)
         for kk in jax.random.split(k, EPOCHS)]))
    dqn_ix = jax.jit(lambda k, n: jax.numpy.stack(
        [jax.random.randint(kk, (DQN_BATCH,), 0, n)
         for kk in jax.random.split(k, GRAD_STEPS)]))

    exe = {}

    def ppo_case(params, opt_state, roll, k):
        if not exe:      # one compile each, for every call's shapes
            exe["update"] = compile_jax(ppo_update, params, opt_state,
                                        roll, k)
            exe["perms"] = compile_jax(perms, k)
        return (host(exe["update"](params, opt_state, roll, k)),
                {"perms": np.asarray(exe["perms"](k))})

    def run(case):
        if case == "ppo":
            p, roll = mlp_params(0), rollout(1)
            s = adam_state(p, 2)
            out, draws = ppo_case(p, s, roll, key)
            res = dict(params=p, opt=s, batch=roll, out=out, draws=draws)
            # two policies, each with its own key (MultiAgentPPO splits
            # its rng once per policy, in sorted order)
            res["multi_agent"] = {}
            k = key
            for i, pid in enumerate(sorted(MA_POLICIES)):
                p = mlp_params(10 + i)
                roll = rollout(20 + i)
                k, sub = jax.random.split(k)
                out, draws = ppo_case(p, optax.adam(LR).init(p), roll, sub)
                res["multi_agent"][pid] = dict(params=p, batch=roll,
                                               out=out, draws=draws)
            return res
        if case == "conv_forward":
            p = conv_params(40)
            obs = np.random.RandomState(41).uniform(
                size=(3, 2) + PIX).astype(np.float32)
            return dict(params=p, obs=obs, out=host(compile_jax(jax.jit(
                ji.conv_policy_forward), p, obs)(p, obs)))
        if case in ("impala", "impala_conv"):
            conv = case == "impala_conv"
            p = conv_params(3) if conv else mlp_params(3)
            s = adam_state(p, 4)
            b = pixel_batch(5) if conv else rollout(5, values=False)
            fwd = ji.conv_policy_forward if conv else jp.policy_forward
            update = ji.make_vtrace_update(fwd, optax.adam(LR), **VT_HP)
            return dict(params=p, opt=s, batch=b,
                        out=host(compile_jax(update, p, s, b)(p, s, b)))
        if case == "appo":
            p, tgt = mlp_params(6), mlp_params(7)
            s = adam_state(p, 8)
            b1, b2 = rollout(9, values=False), rollout(10, values=False)
            update = ja.make_appo_update(
                jp.policy_forward, optax.adam(LR), clip_param=0.3,
                target_update_freq=2, **VT_HP)
            # the update donates its inputs: read each output first
            wrapped = (s, tgt, np.int32(0))
            update = compile_jax(update, p, wrapped, b1)
            first = update(p, wrapped, b1)
            first_host = host(first)
            return dict(params=p, target=tgt, opt=s, batches=(b1, b2),
                        first=first_host, second=host(update(*first[:2],
                                                             b2)))
        if case in ("dqn", "dqn_prioritized"):
            p, tgt = mlp_params(11), mlp_params(12)
            s = adam_state(p, 13)
            slab = prioritized_slab(14) if case == "dqn_prioritized" \
                else plain_slab(14)
            update, td_fn = jd.make_update_fn(optax.adam(LR), 0.99,
                                              GRAD_STEPS, DQN_BATCH)
            n = np.int32(len(slab["obs"]))
            draws = {"ix": np.asarray(compile_jax(dqn_ix, key, n)(key, n))}
            out = host(compile_jax(update, p, tgt, s, slab, key)(
                p, tgt, s, slab, key))
            td = np.asarray(td_fn(out[0], tgt, slab))
            return dict(params=p, target=tgt, opt=s, batch=slab, out=out,
                        draws=draws, td=td)
        raise KeyError(case)

    return in_threads(run, ["ppo", "impala", "impala_conv", "appo", "dqn",
                            "dqn_prioritized", "conv_forward"])


def _port(tree):
    return convert.params_from_jax(tree, device="cpu")


def _adam(state):
    return convert.adam_state_from_jax(state, device="cpu")


def test_ppo_update_matches_jax(jax_side):
    c = jax_side["ppo"]
    update = ppo.make_update_fn(optim.Adam(LR), num_minibatches=2,
                                num_epochs=2, device="cpu", **PPO_HP)
    params, state, metrics = update(_port(c["params"]), _adam(c["opt"]),
                                    c["batch"], draws=c["draws"])
    jp, js, jm = c["out"]
    assert_metrics(metrics, jm)
    assert_changes(params, jp, c["params"])
    assert_adam(state, js)


def test_multi_agent_ppo_matches_jax(jax_side):
    learner = MultiAgentLearner(ma_config(), device="cpu")
    cases = jax_side["ppo"]["multi_agent"]
    for pid, c in cases.items():
        learner.params[pid] = _port(c["params"])
    metrics = learner.update({pid: c["batch"] for pid, c in cases.items()},
                             draws={pid: c["draws"]
                                    for pid, c in cases.items()})
    assert sorted(metrics) == ["a", "b"]
    for pid, c in cases.items():
        jp, js, jm = c["out"]
        assert_metrics(metrics[pid], jm)
        assert_changes(learner.params[pid], jp, c["params"])
        assert_adam(learner.opt_states[pid], js)


@pytest.mark.parametrize("case", ["impala", "impala_conv"])
def test_vtrace_update_matches_jax(jax_side, case):
    c = jax_side[case]
    fwd = impala.conv_policy_forward if case.endswith("conv") \
        else ppo.policy_forward
    update = impala.make_vtrace_update(fwd, optim.Adam(LR), device="cpu",
                                       **VT_HP)
    params, state, metrics = update(_port(c["params"]), _adam(c["opt"]),
                                    c["batch"])
    jp, js, jm = c["out"]
    assert_metrics(metrics, jm)
    assert_changes(params, jp, c["params"])
    assert_adam(state, js)


def test_conv_policy_forward_matches_jax_at_odd_sizes(jax_side):
    """SAME padding at 10 x 13 (uneven on both convs) and the NHWC
    flatten, against JAX's conv policy on the same weights."""
    c = jax_side["conv_forward"]
    got = impala.conv_policy_forward(_port(c["params"]),
                                     torch.from_numpy(c["obs"]))
    for g, w in zip(got, c["out"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    assert impala.same_pads(13, 4) == (1, 2)
    assert impala.same_pads(40, 4) == (1, 1)


def test_appo_update_and_target_refresh_match_jax(jax_side):
    c = jax_side["appo"]
    update = appo.make_appo_update(ppo.policy_forward, optim.Adam(LR),
                                   clip_param=0.3, target_update_freq=2,
                                   device="cpu", **VT_HP)
    target = _port(c["target"])
    params = _port(c["params"])
    params, wrapped, metrics = update(
        params, (_adam(c["opt"]), target, 0), c["batches"][0])
    jp1, (js1, jt1, jstep1), jm1 = c["first"]
    assert wrapped[2] == int(jstep1) == 1
    assert_metrics(metrics, jm1)
    assert_changes(params, jp1, c["params"])
    # no refresh at step 1: the target is as it was
    for (path, a), (_, b) in zip(flat(convert.params_to_jax(wrapped[1])),
                                 flat(c["target"])):
        np.testing.assert_array_equal(a, b, err_msg=path)
    params, wrapped, metrics = update(params, wrapped, c["batches"][1])
    jp2, (js2, jt2, jstep2), jm2 = c["second"]
    assert wrapped[2] == int(jstep2) == 2
    assert_metrics(metrics, jm2)
    assert_changes(params, jp2, c["params"])
    assert_changes(wrapped[1], jt2, c["params"])
    assert_adam(wrapped[0], js2)
    # refreshed at step 2: equal to the live parameters, in own storage
    for t, p in zip(optim.tree_leaves(wrapped[1]),
                    optim.tree_leaves(params)):
        assert torch.equal(t, p)
        assert t.untyped_storage().data_ptr() != \
            p.untyped_storage().data_ptr()


@pytest.mark.parametrize("case", ["dqn", "dqn_prioritized"])
def test_dqn_update_and_td_match_jax(jax_side, case):
    c = jax_side[case]
    update, td_fn = dqn.make_update_fn(optim.Adam(LR), 0.99, GRAD_STEPS,
                                       DQN_BATCH, device="cpu")
    target = _port(c["target"])
    params, state, loss = update(_port(c["params"]), target,
                                 _adam(c["opt"]), c["batch"],
                                 draws=c["draws"])
    jp, js, jloss = c["out"]
    assert ("weights" in c["batch"]) == case.endswith("prioritized")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=METRIC_RTOL)
    assert_changes(params, jp, c["params"])
    assert_adam(state, js)
    np.testing.assert_allclose(td_fn(params, target, c["batch"]).numpy(),
                               c["td"], rtol=1e-4, atol=1e-5)
    # the target is its own storage and the update left it alone
    for t, p, (_, t0) in zip(optim.tree_leaves(target),
                             optim.tree_leaves(params), flat(c["target"])):
        assert t.untyped_storage().data_ptr() != \
            p.untyped_storage().data_ptr()
        np.testing.assert_array_equal(t.numpy(), t0)


def test_port_draws_are_deterministic_and_in_range():
    """The port's own draw path: the same seed gives the same draws and
    the same update; indices lie in [0, n), PPO's rows are permutations."""
    slab = plain_slab(50)
    n = len(slab["obs"])
    dqn_update, _ = dqn.make_update_fn(optim.Adam(LR), 0.99, 3, 16,
                                       device="cpu")
    a = dqn_update.draw(optim.make_generator(3, "cpu"), slab)
    b = dqn_update.draw(optim.make_generator(3, "cpu"), slab)
    assert torch.equal(a["ix"], b["ix"]) and a["ix"].shape == (3, 16)
    assert int(a["ix"].min()) >= 0 and int(a["ix"].max()) < n
    c = dqn_update.draw(optim.make_generator(4, "cpu"), slab)
    assert not torch.equal(a["ix"], c["ix"])
    ppo_update = ppo.make_update_fn(optim.Adam(LR), num_minibatches=2,
                                    num_epochs=3, device="cpu", **PPO_HP)
    perms = ppo_update.draw(optim.make_generator(3, "cpu"),
                            rollout(51))["perms"]
    assert perms.shape == (3, T * N)
    for row in perms:
        assert sorted(row.tolist()) == list(range(T * N))
    runs = []
    for _ in range(2):
        p = _port(mlp_params(52))
        p, s, m = ppo_update(p, optim.Adam(LR).init(p), rollout(51),
                             optim.make_generator(9, "cpu"))
        runs.append((p, m))
    for x, y in zip(optim.tree_leaves(runs[0][0]),
                    optim.tree_leaves(runs[1][0])):
        assert torch.equal(x, y)


def test_convert_round_trips_conv_policy_and_optax_state():
    import optax
    p = conv_params(60)
    port = _port(p)
    assert tuple(port["c1"]["w"].shape) == (8, 2, 4, 4)      # OIHW
    for (path, a), (_, b) in zip(flat(convert.params_to_jax(port)),
                                 flat(p)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    s = adam_state(p, 61, count=17)
    back = convert.adam_state_to_jax(convert.adam_state_from_jax(s, "cpu"))
    assert back.count == 17 and back.count.dtype == np.int32
    for mine, theirs in ((back.mu, s[0].mu), (back.nu, s[0].nu)):
        for (path, a), (_, b) in zip(flat(mine), flat(theirs)):
            np.testing.assert_array_equal(a, b, err_msg=path)
    fresh = optax.adam(LR).init(p)
    st = convert.adam_state_from_jax(fresh, "cpu")
    assert st.count == 0
    assert all(float(t.abs().sum()) == 0
               for t in optim.tree_leaves(st.mu))


def test_copied_envs_match_jax():
    from ray_tpu.rllib import env as je
    from ray_tpu.rllib import multi_agent as jm
    from ray_tpu_torch.rllib import env as pe
    from ray_tpu_torch.rllib import multi_agent as pm

    def roll(mod, make, actions):
        env = make(mod)
        out = [env.reset()]
        for a in actions:
            o, r, d, _ = env.step(a)
            out += [o, np.float64(r), np.float64(d)]
        return out

    rs = np.random.RandomState(0)
    cases = [
        (lambda m: m.CartPoleEnv(max_steps=30, seed=3),
         list(rs.randint(0, 2, 40))),
        (lambda m: m.PendulumEnv(max_steps=20, seed=4),
         [rs.uniform(-2, 2, 1) for _ in range(25)]),
        (lambda m: m.PixelCartPoleEnv(max_steps=15, seed=5),
         list(rs.randint(0, 2, 20)))]
    for make, actions in cases:
        for a, b in zip(roll(je, make, actions), roll(pe, make, actions)):
            np.testing.assert_array_equal(a, b)
    vj = je.VectorEnv(lambda s: je.CartPoleEnv(max_steps=20, seed=s), 3, 8)
    vp = pe.VectorEnv(lambda s: pe.CartPoleEnv(max_steps=20, seed=s), 3, 8)
    np.testing.assert_array_equal(vj.reset(), vp.reset())
    for _ in range(30):
        act = rs.randint(0, 2, 3)
        for a, b in zip(vj.step(act), vp.step(act)):
            np.testing.assert_array_equal(a, b)
    assert vj.drain_episode_returns() == vp.drain_episode_returns()
    mj, mp = jm.MultiAgentCartPole(seed=2), pm.MultiAgentCartPole(seed=2)
    for a, b in zip(mj.reset().values(), mp.reset().values()):
        np.testing.assert_array_equal(a, b)
    for _ in range(30):
        act = {aid: int(rs.randint(2)) for aid in mj.agent_ids}
        oj, rj, dj, _ = mj.step(act)
        op, rp, dp, _ = mp.step(act)
        assert rj == rp and dj == dp
        for aid in oj:
            np.testing.assert_array_equal(oj[aid], op[aid])
    assert mj.drain_episode_returns() == mp.drain_episode_returns()


def test_copied_connectors_match_jax():
    from ray_tpu.rllib import connectors as jc
    from ray_tpu.rllib import env as je
    from ray_tpu_torch.rllib import connectors as pc
    from ray_tpu_torch.rllib import env as pe

    def pipeline(c, e):
        return c.ConnectedEnv(
            e.PendulumEnv(max_steps=12, seed=9),
            obs_connectors=[c.ClipObs(-5, 5), c.NormalizeObs(),
                            c.FrameStack(3), c.FlattenObs()],
            action_connectors=[c.UnsquashActions(-2.0, 2.0),
                               c.ClipActions(-1.5, 1.5)])

    ej, ep = pipeline(jc, je), pipeline(pc, pe)
    assert ej.observation_shape == ep.observation_shape == (9,)
    np.testing.assert_array_equal(ej.reset(), ep.reset())
    rs = np.random.RandomState(1)
    for _ in range(12):
        a = rs.uniform(-1.2, 1.2, 1)
        for x, y in zip(ej.step(a)[:3], ep.step(a)[:3]):
            np.testing.assert_array_equal(x, y)


def test_copied_replay_buffers_and_nstep_match_jax():
    from ray_tpu.rllib import dqn as jd
    tr = transitions(70, T * N)
    for n_step in (1, 3):
        a = jd.nstep_transform(tr, T, N, n_step, 0.9)
        b = dqn.nstep_transform(tr, T, N, n_step, 0.9)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    folded = dqn.nstep_transform(tr, T, N, 3, 0.9)
    for cls in ("ReplayBuffer", "PrioritizedReplayBuffer"):
        bj, bp = getattr(jd, cls)(20, OBS), getattr(dqn, cls)(20, OBS)
        for buf in (bj, bp):
            for lo in (0, 12, 24):   # the third insert wraps the ring
                ix = buf.add_batch(*(folded[k][lo:lo + 12] for k in (
                    "obs", "actions", "rewards", "next_obs", "dones")),
                    discounts=folded["discounts"][lo:lo + 12])
                if hasattr(buf, "update_priorities"):
                    buf.update_priorities(
                        ix, np.random.RandomState(lo).standard_normal(
                            len(ix)))
        sj = bj.sample(np.random.RandomState(5), 16)
        sp = bp.sample(np.random.RandomState(5), 16)
        assert sorted(sj) == sorted(sp)
        for k in sj:
            np.testing.assert_array_equal(sj[k], sp[k], err_msg=k)

"""Learner parity for the port's continuous-action and offline learners
(`ray_tpu_torch/rllib/`): SAC, CQL (SAC's step with the conservative
term), BC and MARWIL, each from the same numpy parameters, Adam state
and data as the JAX package's jitted function, with the JAX draws of the
same key (minibatch indices, Gaussian and uniform noise) handed to the
port.  Also the offline algorithms `CQL` and `MARWIL` on the CPU (train,
save/restore), targets in their own storage, and what still raises.

Sizes: hidden 16, batch 8, 2 grad steps, 2-d actions, 4 CQL proposals.
Tolerance as in tests/test_torch_rllib.py: metrics rel 1e-5, each leaf's
change and Adam moment 1e-4 by relative norm.

`tests/data/marwil_jax_seed0.npz` holds what the JAX package's
test_marwil_beats_bc_on_mixed_data trains from besides its data: the
initial parameters and the minibatch indices of MARWILConfig's seed 0
(4 train() calls x 512 grad steps x 256).  chip_smoke.py replays them on
the card; a test here checks the file against the JAX package.  Write it
anew with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_rllib_offline.py

and with the argument `seeds` the same command trains that test's MARWIL
(beta 0 and 2) at seeds 0-5 in both packages on the CPU and prints the
evaluation returns: how often the test's margin (beta 2 above beta 0 by
more than 30) holds at a seed other than its own.
"""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import cql, offline, optim, sac
from ray_tpu_torch.rllib.cql import CQLConfig
from ray_tpu_torch.rllib.env import PendulumEnv
from ray_tpu_torch.rllib.offline import MARWILConfig
from test_torch_rllib import (adam_state, assert_adam, assert_changes,
                              compile_jax, dense, flat, mlp_params,
                              rel_err, _port, _adam, METRIC_ATOL,
                              METRIC_RTOL)
from test_torch_transformer import in_threads

HIDDEN, OBS, ACT, BATCH, STEPS, K = 16, 3, 2, 8, 2, 4
N_DATA = 24
SAC_HP = dict(gamma=0.99, tau=0.05, target_entropy=-2.0,
              num_grad_steps=STEPS, batch_size=BATCH, action_scale=2.0)
CQL_HP = dict(SAC_HP, min_q_weight=5.0, num_cql_actions=K)
LR = 3e-4
REPLAY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "marwil_jax_seed0.npz")
REPLAY_TRAINS, REPLAY_STEPS, REPLAY_BATCH = 4, 512, 256


def marwil_mixed_data():
    """The JAX test's mixed CartPole data: 15 scripted-expert episodes and
    60 random ones."""
    from ray_tpu_torch.rllib import CartPoleEnv, collect_expert_episodes
    rng = np.random.RandomState(3)
    expert = collect_expert_episodes(
        lambda o: 1 if o[2] + 0.5 * o[3] > 0 else 0,
        lambda s: CartPoleEnv(max_steps=200, seed=s), 15, seed=0)
    rand = collect_expert_episodes(
        lambda o: int(rng.randint(2)),
        lambda s: CartPoleEnv(max_steps=200, seed=s), 60, seed=500)
    return {"obs": np.concatenate([expert["obs"], rand["obs"]]),
            "action": np.concatenate([expert["actions"], rand["actions"]]),
            "reward": np.concatenate([expert["rewards"], rand["rewards"]]),
            "done": np.concatenate([expert["dones"], rand["dones"]])}


def jax_marwil_seed0(data):
    """The initial parameters and minibatch indices of the JAX package's
    MARWIL at seed 0 on `data`: the parameters of its __init__, the
    indices of four train() calls (one key per train, one per step)."""
    import jax
    from ray_tpu.rllib.offline import MARWILConfig as JAXMARWILConfig
    algo = JAXMARWILConfig().offline_data(data=data).build()
    rng, keys = algo._rng, []
    for _ in range(REPLAY_TRAINS):
        rng, key = jax.random.split(rng)
        keys.append(key)
    keys = jax.numpy.stack(keys)
    n = len(data["obs"])
    draw = jax.jit(jax.vmap(lambda key: jax.vmap(
        lambda k: jax.random.randint(k, (REPLAY_BATCH,), 0, n))(
            jax.random.split(key, REPLAY_STEPS))))
    out = {f"params{path}": a for path, a in flat(
        jax.tree.map(np.asarray, algo.params))}
    out["ix"] = np.asarray(compile_jax(draw, keys)(keys)).astype(np.uint16)
    return out


def sac_params(seed):
    rs = np.random.RandomState(seed)

    def mlp(n_in, head, n_out):
        return {"l1": dense(rs, n_in, HIDDEN),
                "l2": dense(rs, HIDDEN, HIDDEN),
                head: dense(rs, HIDDEN, n_out)}

    actor = mlp(OBS, "mu", ACT)
    actor["log_std"] = dense(rs, HIDDEN, ACT)
    return {"actor": actor, "q1": mlp(OBS + ACT, "q", 1),
            "q2": mlp(OBS + ACT, "q", 1),
            "log_alpha": np.float32(-0.3)}


def continuous_data(seed, n=N_DATA):
    rs = np.random.RandomState(seed)
    return {"obs": rs.standard_normal((n, OBS)).astype(np.float32),
            "actions": rs.uniform(-2, 2, (n, ACT)).astype(np.float32),
            "rewards": rs.standard_normal(n).astype(np.float32),
            "next_obs": rs.standard_normal((n, OBS)).astype(np.float32),
            "dones": (rs.uniform(size=n) < 0.15).astype(np.float32)}


def discrete_data(seed, n=N_DATA):
    rs = np.random.RandomState(seed)
    return {"obs": rs.standard_normal((n, 4)).astype(np.float32),
            "action": rs.randint(0, 2, n).astype(np.int32),
            "returns": rs.uniform(0, 20, n).astype(np.float32)}


def sac_state_np(seed):
    """(actor, qs, target_qs, log_alpha, a_opt, c_opt, al_opt) as numpy,
    the target critics drawn apart from the critics and the critics'
    Adam state resumed."""
    import optax
    p, t = sac_params(seed), sac_params(seed + 1)
    qs = {"q1": p["q1"], "q2": p["q2"]}
    return (p["actor"], qs, {"q1": t["q1"], "q2": t["q2"]},
            p["log_alpha"], optax.adam(LR).init(p["actor"]),
            adam_state(qs, seed + 2), optax.adam(LR).init(p["log_alpha"]))


def port_state(s):
    return (_port(s[0]), _port(s[1]), _port(s[2]),
            torch.tensor(np.float32(s[3])), _adam(s[4]), _adam(s[5]),
            _adam(s[6]))


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.rllib import cql as jc
    from ray_tpu.rllib import offline as jo
    from ray_tpu.rllib import sac as js

    key = jax.random.PRNGKey(11)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731

    def sac_draws(k, n):
        out = {k: [] for k in ("ix", "noise_next", "noise_pi", "cql_next",
                               "unif", "noise_cql_pi", "noise_cql_next",
                               "bc_ix")}
        for kk in jax.random.split(k, STEPS):
            # BC and MARWIL draw from the step's key itself
            out["bc_ix"].append(jax.random.randint(kk, (BATCH,), 0, n))
            k1, k2, k3 = jax.random.split(kk, 3)
            out["ix"].append(jax.random.randint(k1, (BATCH,), 0, n))
            out["noise_pi"].append(jax.random.normal(k3, (BATCH, ACT)))
            out["noise_next"].append(jax.random.normal(k2, (BATCH, ACT)))
            # CQL's critic splits k2 again (cql.py critic_loss and
            # _conservative_term)
            k_t, k_c = jax.random.split(k2)
            k_unif, k_pi, k_pi2 = jax.random.split(k_c, 3)
            out["cql_next"].append(jax.random.normal(k_t, (BATCH, ACT)))
            out["unif"].append(jax.random.uniform(
                k_unif, (K, BATCH, ACT), minval=-2.0, maxval=2.0))
            out["noise_cql_pi"].append(jax.random.normal(k_pi,
                                                         (K, BATCH, ACT)))
            out["noise_cql_next"].append(jax.random.normal(
                k_pi2, (K, BATCH, ACT)))
        return {k: jnp.stack(v) for k, v in out.items()}

    def run(case):
        if case == "draws":
            d = host(compile_jax(jax.jit(sac_draws, static_argnums=1), key,
                                 N_DATA)(key))
            return {"sac": {k: d[k] for k in ("ix", "noise_next",
                                               "noise_pi")},
                    "cql": {"ix": d["ix"], "noise_next": d["cql_next"],
                            "unif": d["unif"],
                            "noise_cql_pi": d["noise_cql_pi"],
                            "noise_cql_next": d["noise_cql_next"],
                            "noise_pi": d["noise_pi"]},
                    "ix": {"ix": d["bc_ix"]}}
        if case == "marwil_replay":
            return jax_marwil_seed0(marwil_mixed_data())
        if case in ("sac", "cql"):
            # numpy: the update donates its state
            state, data = host(sac_state_np(1)), continuous_data(2)
            opts = [optax.adam(LR) for _ in range(3)]
            if case == "sac":
                update = js.make_update_fn(*opts, **SAC_HP)
            else:
                update = jc.make_cql_update_fn(*opts, **CQL_HP)
            return dict(state=state, data=data, out=host(compile_jax(
                update, state, data, key)(state, data, key)))
        p, s = mlp_params(3), adam_state(mlp_params(3), 4)
        data = discrete_data(5)
        if case == "bc":
            update = jo.make_bc_update_fn(optax.adam(LR), BATCH, STEPS)
            data = {k: data[k] for k in ("obs", "action")}
        else:
            update = jo.make_marwil_update_fn(optax.adam(LR), BATCH, STEPS,
                                              beta=1.0, vf_coef=0.5)
        return dict(params=p, opt=s, data=data, out=host(compile_jax(
            update, p, s, data, key)(p, s, data, key)))

    return in_threads(run, ["draws", "sac", "cql", "bc", "marwil",
                            "marwil_replay"])


def _check_sac_family(got, c, names):
    state, *metrics = got
    js, *jm = c["out"]
    for name, a, b in zip(names, metrics, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=name)
    for i in (0, 1, 2):          # actor, critics, target critics
        assert_changes(state[i], js[i], c["state"][i])
    assert rel_err(float(state[3]) - c["state"][3],
                   float(js[3]) - c["state"][3]) <= 1e-4
    for i in (4, 5, 6):
        assert_adam(state[i], js[i])
    # the target critics are their own storage after the step
    for t, q in zip(optim.tree_leaves(state[2]),
                    optim.tree_leaves(state[1])):
        assert t.untyped_storage().data_ptr() != \
            q.untyped_storage().data_ptr()


def test_sac_update_matches_jax(jax_side):
    c = jax_side["sac"]
    opts = [optim.Adam(LR) for _ in range(3)]
    update = sac.make_update_fn(*opts, device="cpu", **SAC_HP)
    got = update(port_state(c["state"]), c["data"],
                 draws=jax_side["draws"]["sac"])
    _check_sac_family(got, c, ("critic_loss", "actor_loss", "entropy"))


def test_cql_update_matches_jax(jax_side):
    c = jax_side["cql"]
    opts = [optim.Adam(LR) for _ in range(3)]
    update = cql.make_cql_update_fn(*opts, device="cpu", **CQL_HP)
    got = update(port_state(c["state"]), c["data"],
                 draws=jax_side["draws"]["cql"])
    _check_sac_family(got, c, ("critic_loss", "actor_loss",
                               "conservative_gap"))


@pytest.mark.parametrize("case", ["bc", "marwil"])
def test_bc_and_marwil_updates_match_jax(jax_side, case):
    c = jax_side[case]
    if case == "bc":
        update = offline.make_bc_update_fn(optim.Adam(LR), BATCH, STEPS,
                                           device="cpu")
    else:
        update = offline.make_marwil_update_fn(
            optim.Adam(LR), BATCH, STEPS, beta=1.0, vf_coef=0.5,
            device="cpu")
    params, state, *metrics = update(_port(c["params"]), _adam(c["opt"]),
                                     c["data"], draws=jax_side["draws"]["ix"])
    jp, js, *jm = c["out"]
    assert len(metrics) == len(jm) == (1 if case == "bc" else 3)
    for a, b in zip(metrics, jm):
        np.testing.assert_allclose(float(a), float(b), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL)
    assert_changes(params, jp, c["params"])
    assert_adam(state, js)


def test_sac_draws_are_deterministic_and_in_range():
    data = continuous_data(20)
    update = cql.make_cql_update_fn(*[optim.Adam(LR)] * 3, device="cpu",
                                    **CQL_HP)
    a = update.draw(optim.make_generator(1, "cpu"), data)
    b = update.draw(optim.make_generator(1, "cpu"), data)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["ix"].shape == (STEPS, BATCH)
    assert 0 <= int(a["ix"].min()) and int(a["ix"].max()) < N_DATA
    assert a["unif"].shape == (STEPS, K, BATCH, ACT)
    assert float(a["unif"].abs().max()) <= 2.0
    assert a["noise_cql_next"].shape == (STEPS, K, BATCH, ACT)


def _pendulum_data(n=64):
    rs = np.random.RandomState(30)
    th = rs.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), rs.uniform(-1, 1, n)], 1)
    return {"obs": obs.astype(np.float32),
            "actions": rs.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rs.standard_normal(n).astype(np.float32),
            "next_obs": obs[::-1].copy().astype(np.float32),
            "dones": np.zeros(n, np.float32)}


def test_cql_trains_saves_and_restores(tmp_path):
    cfg = CQLConfig().training(num_grad_steps=3, batch_size=16, hidden=16)
    algo = cfg.offline_data(data=_pendulum_data()).build(device="cpu")
    out = algo.train()
    assert out["iteration"] == 1 and np.isfinite(out["critic_loss"])
    assert {"actor_loss", "conservative_gap", "alpha"} <= set(out)
    obs = _pendulum_data()["obs"][:5]
    act = algo.compute_action(obs)
    assert act.shape == (5, 1) and np.all(np.abs(act) <= 2.0)
    q = algo.mean_q(obs, act)
    path = algo.save(str(tmp_path / "cql"))
    other = cfg.build(device="cpu")
    other.train()
    other.train()
    other.restore(path)
    assert other.iteration == 1
    np.testing.assert_array_equal(other.compute_action(obs), act)
    assert other.mean_q(obs, act) == q
    assert other._state[5].count == algo._state[5].count == 3
    ev = other.evaluate(env_maker=lambda s: PendulumEnv(max_steps=5,
                                                        seed=s),
                        num_episodes=1)
    assert np.isfinite(ev["evaluation_reward_mean"])


def test_marwil_trains_saves_and_restores(tmp_path):
    rs = np.random.RandomState(31)
    data = {"obs": rs.standard_normal((80, 4)).astype(np.float32),
            "action": rs.randint(0, 2, 80),
            "reward": np.ones(80, np.float32),
            "done": (np.arange(80) % 20) == 19}
    cfg = MARWILConfig().training(num_grad_steps=3, batch_size=16,
                                  hidden=16)
    algo = cfg.offline_data(data=data).build(device="cpu")
    out = algo.train()
    assert np.isfinite(out["loss"]) and out["training_iteration"] == 1
    path = algo.save(str(tmp_path / "marwil"))
    other = cfg.build(device="cpu")
    other.restore(path)
    for (p, a), (_, b) in zip(flat(_np(algo.params)),
                              flat(_np(other.params))):
        np.testing.assert_array_equal(a, b, err_msg=p)
    assert other.opt_state.count == 3
    assert other.compute_action(data["obs"][0]) == \
        algo.compute_action(data["obs"][0])
    with pytest.raises(ValueError, match="written by MARWIL"):
        CQLConfig().offline_data(data=_pendulum_data()).build(
            device="cpu").restore(path)
    # returns-to-go restart at each episode's end
    np.testing.assert_allclose(
        offline.compute_returns(data["reward"], data["done"], 0.5)[:20],
        [2 - 0.5 ** (19 - i) for i in range(20)], rtol=1e-6)


def _np(tree):
    return optim.tree_map(lambda t: t.numpy(), tree)


def test_paths_that_wait_raise_and_name_their_roadmap_item(monkeypatch):
    """Nothing waits on A8b any more: an online algorithm's learner
    defaults to the card, so on a host without CUDA `build()` raises
    `resolve_device`'s message before it spawns a worker; the configs'
    own checks still raise."""
    from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, IMPALAConfig,
                                     MultiAgentPPOConfig, PPOConfig,
                                     SACConfig)
    import ray_tpu_torch.rllib.workers as wk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(wk, "spawn", None)     # never reached
    for cfg in (PPOConfig(), DQNConfig(), SACConfig(), IMPALAConfig(),
                APPOConfig()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.build()
    with pytest.raises(ValueError, match="unknown DQN config option"):
        DQNConfig().training(no_such_option=1)
    ma = MultiAgentPPOConfig()
    with pytest.raises(ValueError, match="required"):
        ma.build()
    ma.multi_agent(policies={"p": {"obs_size": 4, "num_actions": 2}},
                   policy_mapping={"agent_0": "q"})
    with pytest.raises(ValueError, match="unknown policies"):
        ma.build()
    ma.multi_agent(policies={"p": {"obs_size": 4, "num_actions": 2}},
                   policy_mapping={"agent_0": "p"})
    with pytest.raises(RuntimeError, match="CUDA"):
        ma.build()
    for cfg in (CQLConfig(), MARWILConfig()):
        with pytest.raises(ValueError, match="input_path or data"):
            cfg.build(device="cpu")
    with pytest.raises(ValueError, match="input_path is required"):
        offline.BCConfig().build(device="cpu")


def test_marwil_replay_file_is_the_jax_tests_seed_0(jax_side):
    with np.load(REPLAY) as f:
        got = dict(f)
    want = jax_side["marwil_replay"]
    assert sorted(got) == sorted(want)
    assert got["ix"].shape == (REPLAY_TRAINS, REPLAY_STEPS, REPLAY_BATCH)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def seed_sweep(seeds=range(6)):
    """{package: {seed: {beta: evaluation return}}} of the JAX test's
    MARWIL runs (4 x 512 grad steps, batch 256, lr 2e-3)."""
    from ray_tpu.rllib import MARWILConfig as JAXMARWILConfig
    data = marwil_mixed_data()
    out = {"jax": {}, "port": {}}
    for seed in seeds:
        for name, cfg, kw in (("jax", JAXMARWILConfig, {}),
                              ("port", MARWILConfig, {"device": "cpu"})):
            out[name][seed] = {}
            for beta in (0.0, 2.0):
                algo = (cfg().offline_data(data=dict(data))
                        .training(beta=beta, num_grad_steps=512,
                                  batch_size=256, lr=2e-3, seed=seed)
                        .build(**kw))
                for _ in range(4):
                    algo.train()
                out[name][seed][beta] = algo.evaluate(num_episodes=5)
            print(name, seed, out[name][seed], flush=True)
    return out


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["seeds"]:
        seed_sweep()
    else:
        os.makedirs(os.path.dirname(REPLAY), exist_ok=True)
        np.savez_compressed(REPLAY, **jax_marwil_seed0(marwil_mixed_data()))
        print("wrote", REPLAY)

"""The port's Data (ray_tpu_torch/data/) and the trainer's input path
against the JAX package's, on the CPU.

Each scenario is one function of a data module and its runtime; the
parametrised test runs it through `ray_tpu.data` and
`ray_tpu_torch.data` (both runtimes alive in this process, started once
for the module) and requires the same rows: in order where the JAX
package keeps order, as sorted multisets where it does not (groupby and
join partitions).  Inputs are numpy from a seed; blocks stay numpy, so
no Data task imports torch.  Remote functions and classes are defined
inside the scenarios and travel by value.

Also: `iter_device_batches(device="cpu")` against JAX's arrays;
`GpuTrainer(datasets=..., use_gpu=False)` training the tiny f32 llama of
tests/test_torch_train.py for 4 steps from a Dataset, against JAX's
CompiledTrainStep on the same batches (rtol 1e-5, summation order); the
elastic branch's ValueError; no coordinator left by a worker that dies
mid-fit; CQL and MARWIL from `input_path=` bit-equal to their `data=`
runs; `log_transitions` -> `BC.train()` against JAX's BC on the same
parquet with JAX's draws.  The fit trains in a thread from the module's
outset (its worker takes seconds to import torch).
"""

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data
import ray_tpu_torch
import ray_tpu_torch.data
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.train import (FailureConfig, GpuTrainer, RunConfig,
                                 ScalingConfig)
from test_torch_rllib import (_port, assert_changes, compile_jax, flat,
                              METRIC_ATOL, METRIC_RTOL)
from test_torch_train import LOSS_RTOL, MODEL, OPT, TIMEOUT
from test_torch_transformer import numpy_params

B, S, STEPS = 4, 17, 4


def _start(rt):
    if rt.is_initialized():         # a session another module left open
        rt.shutdown()
    rt.init(num_cpus=4, _system_config={"worker_pool_prestart": 4})


@pytest.fixture(scope="module")
def jax_rt():
    _start(ray_tpu)
    try:
        yield ray_tpu
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def torch_rt():
    _start(ray_tpu_torch)
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# the training fit, started first
# ---------------------------------------------------------------------------
def _token_rows():
    rs = np.random.RandomState(5)
    return rs.randint(0, MODEL["vocab_size"], (STEPS * B, S)).astype(
        np.int64)


def _data_loop(config):
    from ray_tpu_torch.models import convert, transformer
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer)
    import torch
    cfg = transformer.TransformerConfig(**config["model"],
                                        dtype=torch.float32)
    step = CompiledTrainStep(
        cfg, optimizer=make_optimizer(**config["opt"]), device="cpu")
    state = step.init_state(params=convert.params_from_jax(
        config["params"], cfg, device="cpu"))
    for batch in session.get_dataset_shard("train").iter_batches(
            batch_size=config["batch"]):
        state, m = step(state, step.shard_batch(batch["tokens"]))
        session.report({"step": state.step, "loss": m["loss"].item(),
                        "first_token": int(batch["tokens"][0, 0])})


def _dataset_fit(params, storage_path):
    ds = ray_tpu_torch.data.from_numpy({"tokens": _token_rows()},
                                       block_rows=B)
    config = {"model": MODEL, "opt": OPT, "params": params, "batch": B}
    return GpuTrainer(
        _data_loop, train_loop_config=config, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="data", storage_path=storage_path)).fit()


def _jax_batch_losses(params):
    """The JAX package's CompiledTrainStep (AdamW, a one-device CPU mesh)
    over the Dataset's batches in turn: its per-step losses."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    cfg = jt.TransformerConfig(**MODEL, dtype=jnp.float32)
    step = jts.CompiledTrainStep(cfg, mesh,
                                 optimizer=jts.make_optimizer(**OPT),
                                 donate_state=False)
    state = jax.jit(lambda p: jts.TrainState(
        jnp.zeros((), jnp.int32), p, step.optimizer.init(p)),
        out_shardings=step.state_shardings)(params)
    rows = _token_rows().astype(np.int32)
    losses = []
    for i in range(STEPS):
        state, m = step(state, step.shard_batch(rows[i * B:(i + 1) * B]))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def params():
    return numpy_params(tt.TransformerConfig(**MODEL), 0)


@pytest.fixture(scope="module", autouse=True)
def fit(torch_rt, params, tmp_path_factory):
    """The Dataset-fed fit and JAX's losses, both in threads from the
    module's outset; their test comes last."""
    pool = ThreadPoolExecutor(2)
    futs = (pool.submit(_dataset_fit, params,
                        str(tmp_path_factory.mktemp("fit"))),
            pool.submit(_jax_batch_losses, params))
    yield futs
    pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# Dataset scenarios, through both packages
# ---------------------------------------------------------------------------
def _py(v):
    if isinstance(v, np.ndarray):
        return _py(v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_py(x) for x in v)
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, bytes):
        return v.decode()
    return v


def _rows(ds, ordered=True):
    rows = [tuple(sorted((k, _py(v)) for k, v in r.items()))
            for r in ds.take_all()]
    return rows if ordered else sorted(rows)


def _numbers(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return {"k": rs.randint(0, 4, n), "v": rs.standard_normal(n),
            "i": np.arange(n)}


def _fused(D, rt, tmp):
    return _rows(D.range(20, block_rows=6)
                 .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
                 .filter(lambda r: r["id"] % 3 != 0)
                 .map_batches(lambda b: {"id": b["id"], "z": b["sq"] + 1})
                 .add_column("neg", lambda b: -b["id"]))


def _actor_pool(D, rt, tmp):
    class AddOffset:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, batch):
            return {"id": batch["id"] + self.offset}

    return _rows(D.range(20, block_rows=5).map_batches(
        AddOffset, concurrency=2, fn_constructor_args=(100,)))


def _groupby(D, rt, tmp):
    ds = D.from_numpy(_numbers(), block_rows=5)
    return [_rows(ds.groupby("k").aggregate(
                n=("count", "k"), s=("sum", "v"), m=("mean", "v"),
                lo=("min", "v"), hi=("max", "v")), ordered=False),
            _rows(ds.groupby("k").count(), ordered=False)]


def _join(D, rt, tmp):
    left = D.from_numpy(_numbers(), block_rows=5)
    right = D.from_numpy({"k": np.arange(4), "v": np.arange(4) * 10.0},
                         block_rows=2)
    return _rows(left.join(right, on="k"), ordered=False)


def _zip_union_split_limit(D, rt, tmp):
    ds = D.range(13, block_rows=3)
    return {"zip": _rows(D.range(10, block_rows=5).zip(
                D.from_numpy({"x": np.arange(10) * 2}, block_rows=5))),
            "union": _rows(D.range(5, block_rows=2).union(ds)),
            "split": [_rows(p) for p in ds.split(3)],
            "limit": _rows(D.range(20, block_rows=6).limit(7))}


def _repartition(D, rt, tmp):
    ds = D.range(13, block_rows=5).repartition(3)
    return [ds.num_blocks(), _rows(ds)]


def _iter_batches(D, rt, tmp):
    ds = D.range(23, block_rows=5)
    return [[_py(b["id"]) for b in ds.iter_batches(
                batch_size=7, local_shuffle_buffer_size=10,
                local_shuffle_seed=3)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=7)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=7,
                                                   drop_last=True)]]


def _roundtrip(fmt):
    def scenario(D, rt, tmp):
        ds = D.from_numpy({"a": np.arange(10),
                           "b": np.arange(10) * 0.5}, block_rows=4)
        out = os.path.join(tmp, fmt)
        paths = getattr(ds, f"write_{fmt}")(out)
        back = getattr(D, f"read_{fmt}")(out).sort("a")
        return [[os.path.basename(p) for p in paths], _rows(back)]
    return scenario


def _tfrecords(D, rt, tmp):
    import importlib
    tf = importlib.import_module(rt.__name__ + ".data.tfrecords")
    path = os.path.join(tmp, "x.tfrecord")
    with open(path, "wb") as f:
        tf.write_records(f, [tf.encode_example(
            {"id": i, "w": [float(i), 0.5], "name": f"n{i}".encode()})
            for i in range(5)])
    return _rows(D.read_tfrecords(path))


def _streaming_split(D, rt, tmp):
    ds = D.range(14, block_rows=3)
    out = {}
    for equal in (True, False):
        its = ds.streaming_split(3, equal=equal)
        try:
            # Consumed in turn: with equal=False the first split takes
            # every block (work-stealing), with equal=True round-robin.
            out[equal] = [[_py(b["id"]) for b in it._iter_blocks()]
                          for it in its]
        finally:
            rt.kill(its[0]._coord)
    return out


SCENARIOS = {
    "from_items": lambda D, rt, tmp: _rows(D.from_items(
        [{"a": i, "s": f"r{i}"} for i in range(10)], block_rows=3)),
    "range": lambda D, rt, tmp: [_rows(D.range(11, block_rows=4)),
                                 D.range(11, block_rows=4).num_blocks()],
    "from_numpy": lambda D, rt, tmp: _rows(D.from_numpy(
        {"x": np.random.RandomState(1).standard_normal((9, 3)),
         "y": np.arange(9)}, block_rows=4)),
    "fused_map_filter_map_batches": _fused,
    "actor_pool_map_batches": _actor_pool,
    "random_shuffle": lambda D, rt, tmp: _rows(D.from_numpy(
        _numbers(), block_rows=5).random_shuffle(seed=7)),
    "sort": lambda D, rt, tmp: _rows(D.from_numpy(
        _numbers(), block_rows=5).sort("v", descending=True)),
    "groupby": _groupby,
    "join": _join,
    "zip_union_split_limit": _zip_union_split_limit,
    "repartition": _repartition,
    "iter_batches": _iter_batches,
    "parquet": _roundtrip("parquet"),
    "csv": _roundtrip("csv"),
    "json": _roundtrip("json"),
    "tfrecords": _tfrecords,
    "streaming_split": _streaming_split,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dataset_matches_jax(jax_rt, torch_rt, tmp_path, name):
    got = {}
    for rt in (jax_rt, torch_rt):
        tmp = tmp_path / rt.__name__
        tmp.mkdir()
        got[rt.__name__] = SCENARIOS[name](rt.data, rt, str(tmp))
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_iter_device_batches_cpu_matches_jax(jax_rt, torch_rt):
    from torch.distributed.tensor import Shard
    from test_torch_mesh import abstract_mesh
    cols = {"x": np.random.RandomState(2).standard_normal((22, 3)).astype(
        np.float32), "y": np.arange(22)}
    jax_batches = [{k: np.asarray(v) for k, v in b.items()} for b in
                   jax_rt.data.from_numpy(cols, block_rows=5)
                   .iter_device_batches(batch_size=4, prefetch=2)]
    ds = torch_rt.data.from_numpy(cols, block_rows=5)
    got = list(ds.iter_device_batches(batch_size=4, prefetch=2,
                                      device="cpu"))
    assert len(got) == len(jax_batches) == 5          # drop_last
    for g, j in zip(got, jax_batches):
        assert sorted(g) == sorted(j)
        for k in j:
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), j[k])
    mesh = abstract_mesh(dict(dp=2))
    sharded = next(iter(ds.iter_device_batches(
        batch_size=4, device="cpu", sharding=(mesh, [Shard(0)]))))
    assert tuple(sharded["x"].shape) == (4, 3)
    np.testing.assert_array_equal(sharded["x"].to_local().numpy(),
                                  cols["x"][:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(ds.iter_device_batches(batch_size=4)))


# ---------------------------------------------------------------------------
# the trainer's input path
# ---------------------------------------------------------------------------
def _live_coordinators(rt):
    """Ids of the session's live `_SplitCoordinator`s (the module's
    background fit may hold one of its own)."""
    actors = list(rt._session.node_service.actors.values())
    return {a.actor_id for a in actors if a.state != "dead"
            and "_SplitCoordinator" in a.spec.get("class_name", "")}


def test_elastic_with_datasets_raises_value_error_as_jax(torch_rt,
                                                         tmp_path):
    ds = torch_rt.data.range(4)
    trainer = GpuTrainer(
        lambda config: None, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False,
                                     elastic=True),
        run_config=RunConfig(name="el", storage_path=str(tmp_path)))
    before = _live_coordinators(torch_rt)
    with pytest.raises(ValueError, match="elastic training does not "
                                         "support datasets="):
        trainer.fit()
    assert _live_coordinators(torch_rt) <= before


def test_worker_dying_mid_fit_leaves_no_coordinator(torch_rt, tmp_path):
    def loop(config):
        import os
        from ray_tpu_torch.train import session
        it = session.get_dataset_shard("train").iter_batches(batch_size=2)
        next(iter(it))
        try:
            session.get_dataset_shard("x")
        except KeyError as e:
            session.report({"missing": str(e)})
        os._exit(1)

    before = _live_coordinators(torch_rt)
    result = GpuTrainer(
        loop, train_loop_config={}, datasets={"train": torch_rt.data.range(
            8, block_rows=2)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="die", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0))
    ).fit()
    assert result.error is not None
    deadline = time.time() + TIMEOUT
    while _live_coordinators(torch_rt) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not _live_coordinators(torch_rt) - before
    assert [r["missing"] for r in result.metrics_dataframe] == [
        "\"no dataset shard named 'x'; trainer datasets: ['train']\""]


# ---------------------------------------------------------------------------
# offline RLlib input
# ---------------------------------------------------------------------------
def _transitions(n=48, seed=9):
    rs = np.random.RandomState(seed)
    return {"obs": rs.standard_normal((n, 3)).astype(np.float32),
            "action": rs.uniform(-2, 2, (n, 1)).astype(np.float32),
            "reward": rs.standard_normal(n).astype(np.float32),
            "next_obs": rs.standard_normal((n, 3)).astype(np.float32),
            "done": (rs.uniform(size=n) < 0.1).astype(np.float32)}


def _cartpole_transitions(n=48, seed=10):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, 4)).astype(np.float32),
            rs.randint(0, 2, n), rs.uniform(0, 1, n).astype(np.float32),
            (np.arange(n) % 12) == 11)


def _equal_trees(a, b):
    for (path, x), (_, y) in zip(flat(a), flat(b)):
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_cql_and_marwil_from_input_path_equal_their_data_runs(torch_rt,
                                                              tmp_path):
    from ray_tpu_torch.rllib import (CQLConfig, MARWILConfig,
                                     log_transitions)
    from ray_tpu_torch.rllib.convert import params_to_jax
    cont = _transitions()
    torch_rt.data.from_numpy(cont, block_rows=16).write_parquet(
        str(tmp_path / "cql"))
    names = {"obs": "obs", "actions": "action", "rewards": "reward",
             "next_obs": "next_obs", "dones": "done"}
    runs = []
    for source in ({"input_path": str(tmp_path / "cql")},
                   {"data": {k: cont[v] for k, v in names.items()}}):
        algo = CQLConfig().training(num_grad_steps=2, batch_size=8,
                                    hidden=16).offline_data(
            **source).build(device="cpu")
        runs.append((algo.train(), params_to_jax(algo.actor)))
    assert runs[0][0]["critic_loss"] == runs[1][0]["critic_loss"]
    _equal_trees(runs[0][1], runs[1][1])

    obs, act, rew, done = _cartpole_transitions()
    log_transitions(str(tmp_path / "marwil"), obs, act, rew, done,
                    block_rows=16)
    runs = []
    for source in ({"input_path": str(tmp_path / "marwil")},
                   {"data": {"obs": obs, "action": act, "reward": rew,
                             "done": done}}):
        algo = MARWILConfig().training(num_grad_steps=2, batch_size=8,
                                       hidden=16).offline_data(
            **source).build(device="cpu")
        runs.append((algo.train()["loss"], params_to_jax(algo.params)))
    assert runs[0][0] == runs[1][0]
    _equal_trees(runs[0][1], runs[1][1])


def _jax_bc(path, cfg_kw, read_rows):
    """JAX's BC on `path`: its initial parameters, the minibatch indices
    of one train() (one key a read-batch, one a step, as its update
    draws them) and its parameters after that train()."""
    import jax
    from ray_tpu.rllib.offline import BCConfig as JAXBCConfig
    algo = JAXBCConfig().offline_data(input_path=path, **cfg_kw).build()
    init = jax.tree.map(np.asarray, algo.params)
    rng, draws = algo._rng, []
    for n in read_rows:
        rng, key = jax.random.split(rng)
        draw = jax.jit(jax.vmap(lambda k: jax.random.randint(
            k, (cfg_kw["batch_size"],), 0, n)))
        keys = jax.random.split(key, cfg_kw["num_grad_steps"])
        draws.append({"ix": np.asarray(compile_jax(draw, keys)(keys))})
    out = algo.train()
    return init, draws, out, jax.tree.map(np.asarray, algo.params)


def test_log_transitions_then_bc_matches_jax(jax_rt, torch_rt, tmp_path):
    from ray_tpu.rllib.offline import log_transitions as jax_log
    from ray_tpu_torch.rllib import BCConfig, log_transitions
    from ray_tpu_torch.rllib.convert import params_to_jax
    obs, act, rew, done = _cartpole_transitions()
    paths = {}
    for name, log in (("jax", jax_log), ("port", log_transitions)):
        paths[name] = str(tmp_path / name)
        log(paths[name], obs, act, rew, done, block_rows=20)
    files = {k: sorted(os.listdir(v)) for k, v in paths.items()}
    assert files["port"] == files["jax"]
    for f in files["port"]:
        assert (open(os.path.join(paths["port"], f), "rb").read()
                == open(os.path.join(paths["jax"], f), "rb").read())
    kw = dict(batch_size=8, num_grad_steps=3, read_batch_size=32,
              hidden=16)
    read_rows = [32, 16]
    init, draws, jout, jparams = _jax_bc(paths["jax"], kw, read_rows)
    algo = BCConfig().offline_data(input_path=paths["port"],
                                   **kw).build(device="cpu")
    algo.params = _port(init)
    algo.opt_state = algo.optimizer.init(algo.params)
    out = algo.train(draws=draws)
    assert out["rows_this_iter"] == jout["rows_this_iter"] == 48
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=METRIC_RTOL,
                               atol=METRIC_ATOL)
    assert_changes(params_to_jax(algo.params), jparams, init)
    assert isinstance(algo.compute_action(obs[0]), int)


# ---------------------------------------------------------------------------
# last: the Dataset-fed fit against JAX's steps
# ---------------------------------------------------------------------------
def test_gpu_trainer_from_a_dataset_matches_jax(fit):
    result = fit[0].result(timeout=300)
    assert result.error is None, result.error
    rows = result.metrics_dataframe
    assert [r["step"] for r in rows] == list(range(1, STEPS + 1))
    assert [r["first_token"] for r in rows] == [
        int(_token_rows()[i * B, 0]) for i in range(STEPS)]
    want = fit[1].result(timeout=300)
    np.testing.assert_allclose([r["loss"] for r in rows], want,
                               rtol=LOSS_RTOL)
    assert all(math.isfinite(r["loss"]) for r in rows)

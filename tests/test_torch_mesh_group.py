"""The port's MeshGroup (parallel/mesh_group.py), elastic gangs
(train/elastic.py) and placement groups (util/placement_group.py) on
CPU gloo ranks, against the JAX package.

`MeshGroup(num_hosts=2, devices_per_host=2, platform="cpu")` spawns one
rank actor per device (4 ranks, one world) in a placement group of two
bundles; every rank sees the world of 4 and an all-reduce sums over it.
`CompiledTrainStep` on the group's fsdp 2 × tp 2 mesh gives the loss of
the JAX package's `CompiledTrainStep` on a fsdp 2 × tp 2 mesh of four of
the conftest's CPU devices, from the same numpy weights and tokens
(rtol 1e-5: summation order only), and its state of DTensors crosses a
DCP checkpoint saved and loaded by the four ranks together, bit for
bit.  The gang resizes in place (2 → 1 →
2 hosts).  `shard_pytree`/`unshard_pytree` round-trip bf16 and f32
tensors at any world size, and an elastic `GpuTrainer` run that shrinks
from 2 workers to 1 on a preemption at step 4 and grows back by step
10 gives the loss curve of plain numpy full-batch SGD on the same data (float64,
atol 1e-8, as the JAX `test_loss_curve_equivalence_across_resize`).

One port runtime serves the module; the gang is made once, and the
elastic run trains beside the gang's tests.  Functions
run on the ranks are defined inside the tests, so they travel by value
and no rank imports this module (or JAX).
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel.mesh_group import MeshGroup
from ray_tpu_torch.train import (GpuTrainer, RunConfig, ScalingConfig,
                                 elastic as elastic_mod)
from ray_tpu_torch.train.elastic import shard_pytree, unshard_pytree
from ray_tpu_torch.util import (placement_group, placement_group_table,
                                remove_placement_group, tpu_slice_bundles)
from test_torch_transformer import numpy_params

MODEL = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=64, remat=False, arch="llama")
B, S = 8, 65
LOSS_RTOL = 1e-5
TIMEOUT = 120.0
ELASTIC_STEPS = 30
ELASTIC_ENV = {"RAY_TPU_TRAIN_CKPT_INTERVAL_S": "0",
               "RAY_TPU_TRAIN_MIN_WORLD_SIZE": "1",
               "RAY_TPU_TRAIN_GROW_RETRY_S": "0.4",
               "RAY_TPU_TRAIN_ELASTIC_POLL_S": "0.02",
               "RAY_TPU_TRAIN_TELEMETRY_PUBLISH_S": "0.1"}


def _tokens():
    rng = np.random.RandomState(0)
    return rng.randint(0, MODEL["vocab_size"], (B, S)).astype(np.int32)


def _jax_loss(params, devices):
    """One JAX CompiledTrainStep on a fsdp 2 x tp 2 mesh of 4 CPU
    devices."""
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts
    import jax
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), devices=devices)
    cfg = jt.TransformerConfig(**MODEL, dtype=jnp.float32)
    step = jts.CompiledTrainStep(cfg, mesh, donate_state=False)
    state = jax.jit(lambda p: jts.TrainState(
        jnp.zeros((), jnp.int32), p, step.optimizer.init(p)),
        out_shardings=step.state_shardings)(params)
    _, metrics = step(state, step.shard_batch(_tokens()))
    return float(metrics["loss"])


@pytest.fixture(scope="module")
def params():
    return numpy_params(tt.TransformerConfig(**MODEL), 0)


@pytest.fixture(scope="module")
def jax_loss(params, cpu_mesh_devices):
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_jax_loss, params, cpu_mesh_devices[:4])
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rt():
    if ray_tpu_torch.is_initialized():  # a session another module left
        ray_tpu_torch.shutdown()
    # The elastic knobs are set before init: workers read them from the
    # environment they were started with, and some are prestarted.
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ELASTIC_ENV.items():
            mp.setenv(key, value)
        # Prestarted workers spare the gang's first ranks and the
        # elastic workers a process start.
        ray_tpu_torch.init(num_cpus=12, num_gpus=0,
                           _system_config={"worker_pool_prestart": 8})
        try:
            yield ray_tpu_torch
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def mesh_group(rt, jax_loss, elastic_run):
    mg = MeshGroup(num_hosts=2, devices_per_host=2, platform="cpu")
    try:
        yield mg
    finally:
        mg.shutdown()


def test_global_device_counts(mesh_group):
    counts = mesh_group.device_counts()
    assert [c["global"] for c in counts] == [4, 4]
    assert [c["local"] for c in counts] == [2, 2]
    assert [c["rank"] for c in counts] == [0, 1]

    def world(rank):
        import torch.distributed as dist
        return rank, dist.get_rank(), dist.get_world_size()

    assert mesh_group.run(world, timeout=TIMEOUT) == [
        (r, r, 4) for r in range(4)]


def test_global_collective(mesh_group):
    def global_sum(rank):
        import torch
        import torch.distributed as dist
        x = torch.arange(8.0)[rank * 2:(rank + 1) * 2].sum()
        dist.all_reduce(x)
        return float(x)

    assert mesh_group.run(global_sum, timeout=TIMEOUT) == [28.0] * 4


def test_compiled_train_step_on_group_mesh(mesh_group, jax_loss, params,
                                           tmp_path):
    """The step's loss against JAX's; then the state (DTensors placed by
    the fsdp x tp rules) through a DCP checkpoint saved and loaded by all
    4 ranks together, into another init_state's tree, bit for bit."""
    def train_step_loss(rank, model, params, tokens, ckpt_dir):
        import torch
        from ray_tpu_torch.models import convert, transformer
        from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from ray_tpu_torch.train import Checkpoint
        from ray_tpu_torch.train.train_step import CompiledTrainStep
        cfg = transformer.TransformerConfig(**model, dtype=torch.float32)
        mesh = make_mesh(MeshSpec(fsdp=2, tp=2), devices=["cpu"] * 4)
        step = CompiledTrainStep(cfg, mesh)
        state = step.init_state(params=convert.params_from_jax(
            params, cfg, device="cpu"))
        state, metrics = step(state, step.shard_batch(tokens))
        Checkpoint.save_pytree(ckpt_dir, state)
        template = step.init_state(seed=5)
        loaded = Checkpoint(ckpt_dir).load_pytree(template)

        def leaves(tree):
            return [v for k in sorted(tree) for v in (
                leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]

        pairs = list(zip(leaves({"p": state.params, "o": state.opt_state}),
                         leaves({"p": loaded.params,
                                 "o": loaded.opt_state})))
        same = loaded.step == state.step and all(
            (a.placements == b.placements
             and torch.equal(a.to_local(), b.to_local()))
            if hasattr(a, "placements") else a == b for a, b in pairs)
        return float(metrics["loss"]), same, sum(
            hasattr(a, "placements") for a, _ in pairs)

    got = mesh_group.run(train_step_loss, MODEL, params, _tokens(),
                         str(tmp_path / "ckpt"), timeout=TIMEOUT)
    losses = [loss for loss, _, _ in got]
    assert len(set(losses)) == 1, losses
    want = jax_loss.result(timeout=300)
    assert losses[0] == pytest.approx(want, rel=LOSS_RTOL, abs=0)
    assert all(same for _, same, _ in got)
    assert all(n > 0 for _, _, n in got)       # DTensor leaves were saved


def test_checkpoint_tree_is_whole_before_any_rank_loads(mesh_group,
                                                       tmp_path):
    """Rank 0 writes the tree file a second late: a rank that loads as
    soon as `save_pytree` returns still finds it whole.  (When rank 0
    wrote it after DCP's save, the other ranks could open it before it
    existed and fail, while rank 0 waited for them in DCP's load until
    the run timed out.)"""
    def save_then_load(rank, ckpt_dir):
        import pickle
        import time

        import torch
        from ray_tpu_torch.train import checkpoint as ck

        class SlowPickle:
            def __getattr__(self, name):
                return getattr(pickle, name)

            @staticmethod
            def dumps(*a, **kw):
                time.sleep(1.0)
                return pickle.dumps(*a, **kw)

        ck.pickle = SlowPickle()
        try:
            ck.Checkpoint.save_pytree(
                ckpt_dir, {"w": torch.arange(4.0), "step": 3},
                metadata={"by": "rank 0"})
            got = ck.Checkpoint(ckpt_dir).load_pytree(
                {"w": torch.zeros(4), "step": 0})
            meta = ck.Checkpoint(ckpt_dir).metadata()
        finally:
            ck.pickle = pickle
        return got["w"].tolist(), got["step"], meta

    got = mesh_group.run(save_then_load, str(tmp_path / "ckpt"),
                         timeout=TIMEOUT)
    assert got == [([0.0, 1.0, 2.0, 3.0], 3, {"by": "rank 0"})] * 4


def test_run_timeout_names_each_ranks_stack(mesh_group):
    """A run that times out raises with what the finished ranks raised
    and the stacks of the ranks still running."""
    def rank1_fails(rank):
        import torch
        import torch.distributed as dist
        if rank == 1:
            raise ValueError("rank 1 gave up")
        dist.all_reduce(torch.ones(()))     # waits for rank 1 forever

    with pytest.raises(ray_tpu_torch.exceptions.GetTimeoutError) as info:
        mesh_group.run(rank1_fails, timeout=8.0)
    text = str(info.value)
    assert "rank 1 raised" in text and "rank 1 gave up" in text
    assert "--- rank 0 stacks ---" in text and "all_reduce" in text
    mesh_group.rebuild()       # the survivors are stuck in the collective


def test_resize_in_place(mesh_group):
    """Shrink to 1 host and grow back to 2 on the same placement group;
    grow is bounded by the bundles reserved at construction."""
    def world(rank):
        import torch
        import torch.distributed as dist
        x = torch.ones(())
        dist.all_reduce(x)
        return rank, dist.get_world_size(), float(x)

    mg = mesh_group
    mg.resize(1)
    counts = mg.device_counts()
    assert [(c["global"], c["local"], c["rank"]) for c in counts] == [
        (2, 2, 0)]
    assert mg.run(world, timeout=TIMEOUT) == [(0, 2, 2.0), (1, 2, 2.0)]
    mg.resize(2)
    assert [c["global"] for c in mg.device_counts()] == [4, 4]
    assert mg.run(world, timeout=TIMEOUT) == [
        (r, 4, 4.0) for r in range(4)]
    assert mg.resizes == 2
    with pytest.raises(ValueError):
        mg.resize(3)
    with pytest.raises(ValueError):
        mg.resize(0)
    assert mg.resizes == 2


# ---------------------------------------------------------------------------
# elastic gangs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shard_unshard_roundtrip_any_world_size(dtype):
    """Exact round-trip at any nshards — including nshards > leading
    dim (empty shards) and 0-d leaves (replicated) — with torch tensors
    of any dtype (bf16 has no numpy dtype)."""
    g = torch.Generator().manual_seed(0)
    tree = {
        "w": torch.randn(10, 3, generator=g).to(dtype),
        "opt": [torch.randn(7, generator=g).to(dtype),
                torch.tensor(3.5, dtype=dtype)],
        "meta": (torch.arange(2).to(dtype),),
        "count": np.float64(4.0),
    }
    for n in (1, 2, 3, 4, 5, 11):
        shards = [shard_pytree(tree, i, n) for i in range(n)]
        back = unshard_pytree(shards)
        for got, want in ((back["w"], tree["w"]),
                          (back["opt"][0], tree["opt"][0]),
                          (back["opt"][1], tree["opt"][1]),
                          (back["meta"][0], tree["meta"][0])):
            assert got.dtype == dtype and torch.equal(got, want)
        assert isinstance(back["meta"], tuple)
        assert float(back["count"]) == 4.0
    # 4 -> 3 -> 4: reshard through a different world size is lossless.
    via3 = unshard_pytree([shard_pytree(tree, i, 3) for i in range(3)])
    again = unshard_pytree([shard_pytree(via3, i, 4) for i in range(4)])
    assert torch.equal(again["w"], tree["w"])
    # The allreduce's sums run in float64 and come back in the leaf's
    # dtype.
    acc = elastic_mod._tree_scale_add(None, tree["opt"], 2.0)
    acc = elastic_mod._tree_scale_add(acc, tree["opt"], 1.0)
    assert acc[0].dtype == torch.float64
    mean = elastic_mod._tree_scale(acc, 1 / 3.0, tree["opt"])
    assert mean[0].dtype == dtype
    assert torch.equal(mean[0], tree["opt"][0].double().to(dtype))
    with pytest.raises(ValueError):
        shard_pytree(tree, 3, 3)
    with pytest.raises(ValueError):
        unshard_pytree([])


def _make_sgd_loop():
    """Linear regression by full-batch SGD in float64 torch tensors:
    each member computes the gradient over ITS row shard and the
    weighted-mean allreduce reassembles the exact full-batch gradient at
    any world size (the JAX test's loop, on tensors).  `holds` {step:
    epoch} makes the gang wait at that step until the gang's epoch has
    moved past the given one, so the resizes land mid-run; each step
    records the world size it ran at."""

    def loop(config):
        import json as _json
        import time as _t

        import numpy as np
        import torch

        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.elastic import ResizeInterrupt

        ctx = session.get_context()
        ctx.telemetry(tokens_per_step=12)
        es = ctx.elastic()
        es.join()
        rank = ctx.get_world_rank()
        deadline = _t.monotonic() + 120.0
        while rank not in es.members:
            if _t.monotonic() > deadline:
                raise TimeoutError(f"rank {rank} never joined the gang")
            _t.sleep(0.02)
            es.sync()

        d, batch, lr = 6, 12, 0.05
        f64 = torch.float64
        w_true = torch.from_numpy(np.random.default_rng(7).normal(size=d))
        total = int(config["total_steps"])
        holds = config.get("holds") or {}
        t = 0
        state = {"w": torch.zeros(d, dtype=f64),
                 "losses": torch.full((total,), float("nan"), dtype=f64),
                 "world": torch.zeros(total, dtype=torch.int64)}
        got = es.restore()
        if got is not None:
            t, state = got[0] + 1, got[1]
        while t < total:
            if _t.monotonic() > deadline:
                raise TimeoutError(f"rank {rank} stuck at step {t}")
            ev = es.sync()
            if ev and ev["resized"]:
                while rank not in es.members:
                    if _t.monotonic() > deadline:
                        raise TimeoutError(
                            f"rank {rank} dropped from the gang")
                    _t.sleep(0.02)
                    es.sync()
                t, state = es.restore_or(t, state)
                continue
            if ev and ev.get("notice_deadline"):
                es.save_shard(t - 1, state, force=True)
                return
            if t in holds and es.epoch <= holds[t]:
                _t.sleep(0.02)
                continue
            # The per-step batch comes from the STEP, not the world.
            x = torch.from_numpy(
                np.random.default_rng(1000 + t).normal(size=(batch, d)))
            y = x @ w_true
            members = es.members
            rows = torch.arange(batch).tensor_split(
                len(members))[members.index(rank)]
            err = x[rows] @ state["w"] - y[rows]
            grad = x[rows].T @ err / max(len(rows), 1)
            loss = torch.mean(err ** 2)
            try:
                red = es.allreduce(t, {"g": grad, "loss": loss},
                                   weight=float(len(rows)))
            except ResizeInterrupt:
                continue
            assert red["g"].dtype == f64
            state = {k: v.clone() for k, v in state.items()}
            state["w"] -= lr * red["g"]
            state["losses"][t] = red["loss"]
            state["world"][t] = len(members)
            es.save_shard(t, state)
            if rank == 0 and t == total - 1:
                session.report({"step": t, "losses_json": _json.dumps(
                    state["losses"].tolist()),
                    "world": state["world"].tolist()})
            t += 1

    return loop


def _plain_sgd_curve(total, d=6, batch=12, lr=0.05):
    """The fixed-world loss curve by plain numpy full-batch SGD: the
    same w_true, per-step batches and learning rate as the loop, with
    none of the port's code."""
    w_true = np.random.default_rng(7).normal(size=d)
    w = np.zeros(d)
    losses = []
    for t in range(total):
        x = np.random.default_rng(1000 + t).normal(size=(batch, d))
        err = x @ w - x @ w_true
        losses.append(float(np.mean(err ** 2)))
        w = w - lr * (x.T @ err / batch)
    return losses


def _elastic_fit(client, storage_path):
    """Fit a 2-worker elastic gang of the SGD loop for ELASTIC_STEPS
    steps, preempting one worker once the gang waits at step 4; the gang
    grows back to 2 by step 10."""
    import threading
    import time

    from ray_tpu_torch._private.chaos import chaos

    results = {}

    def fit():
        results["eq_elastic"] = GpuTrainer(
            _make_sgd_loop(),
            train_loop_config={"total_steps": ELASTIC_STEPS,
                               "holds": {4: 0, 10: 1}},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                         elastic=True),
            run_config=RunConfig(name="eq_elastic",
                                 storage_path=storage_path)).fit()

    chaos.clear()
    chaos.reset_trace()
    elastic = threading.Thread(target=fit)
    elastic.start()
    try:
        deadline = time.monotonic() + TIMEOUT
        while elastic_mod.latest_manifest_step(client, "eq_elastic") != 3:
            assert time.monotonic() < deadline, "elastic gang stalled"
            time.sleep(0.02)
        chaos.inject("train.worker", kind="preempt", p=1.0, n=1,
                     deadline_s=0.25)
        elastic.join(timeout=TIMEOUT)
    finally:
        chaos.clear()
    assert not elastic.is_alive()
    return results["eq_elastic"]


@pytest.fixture(scope="module")
def elastic_run(rt, tmp_path_factory):
    """The elastic run, started before the gang so that it trains while
    the gang's tests run (its workers and the gang's ranks each take
    seconds to import torch)."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_elastic_fit, ray_tpu_torch._ensure_connected(),
                      str(tmp_path_factory.mktemp("elastic")))
    yield fut
    pool.shutdown(wait=True)


def test_elastic_loss_curve_2_1_2_matches_fixed_world(rt, elastic_run):
    """A 2-worker elastic gang that shrinks to 1 on a preemption at step
    4 and grows back to 2 by step 10 reproduces the loss curve of a
    fixed world: plain numpy full-batch SGD on the same data (float64,
    atol 1e-8, as the JAX `test_loss_curve_equivalence_across_resize`)."""
    from ray_tpu_torch.train import telemetry as telemetry_mod

    result = elastic_run.result(timeout=2 * TIMEOUT)
    assert result.error is None, result.error
    want = _plain_sgd_curve(ELASTIC_STEPS)
    np.testing.assert_allclose(json.loads(result.metrics["losses_json"]),
                               want, rtol=0, atol=1e-8)
    # It actually trained, and actually shrank and grew back mid-run.
    assert want[-1] < 0.1 * want[0]
    assert result.metrics["world"] == [2] * 4 + [1] * 6 + [2] * 20
    meta = telemetry_mod.read_run_metas(
        ray_tpu_torch._ensure_connected())["eq_elastic"]
    assert [(e["direction"], e["from"], e["to"])
            for e in meta["resizes"]] == [("shrink", 2, 1), ("grow", 1, 2)]


# ---------------------------------------------------------------------------
# placement groups
# ---------------------------------------------------------------------------
def test_placement_group_wait_and_remove(rt):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.bundle_count == 2
    assert pg.wait(10)
    assert placement_group_table(pg)["state"] == "created"
    remove_placement_group(pg)
    assert placement_group_table(pg)["state"] == "removed"
    # A group waits while another holds what it needs, and is placed
    # once that one is removed.
    holder = placement_group([{"CPU": rt.available_resources()["CPU"]}])
    assert holder.wait(10)
    waiting = placement_group([{"CPU": 1}])
    try:
        assert not waiting.wait(0.5)
        remove_placement_group(holder)
        assert waiting.wait(10)
    finally:
        remove_placement_group(holder)
        remove_placement_group(waiting)
    # No GPU in this cluster: a GPU bundle can never be placed.
    gpu = placement_group([{"GPU": 1}])
    try:
        with pytest.raises(
                ray_tpu_torch.exceptions.InfeasibleResourceError):
            gpu.wait(10)
    finally:
        remove_placement_group(gpu)
    with pytest.raises(ValueError):
        placement_group([{"CPU": 1}], strategy="NEAR")
    with pytest.raises(NotImplementedError, match="A2f"):
        tpu_slice_bundles("v5e-16", 4)
    with pytest.raises(NotImplementedError, match="A2f"):
        MeshGroup(num_hosts=1, platform="cpu", slice_type="v5e-16")

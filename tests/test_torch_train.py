"""The port's trainer (ray_tpu_torch/train/: GpuTrainer, sessions,
checkpoints, telemetry) against the JAX package.

`GpuTrainer(use_gpu=False).fit()` trains a tiny f32 llama (2 layers,
d_model 64) in a worker actor for 4 AdamW steps from numpy weights; its
reported losses are held against the JAX package's `CompiledTrainStep`
on the same weights and tokens (rtol 1e-5: summation order only).  The
worker saves and reports a checkpoint after step 2, trains on to step
4 and then dies (`os._exit`); with `FailureConfig(max_failures=1)` a
new worker resumes from the checkpoint, and its steps 3 and 4 must give
the unbroken first attempt's losses bit for bit.  DCP checkpoints
round-trip AdamW and Adafactor `TrainState`s bit for bit; the copied
CheckpointManager, report and user-error cases of the JAX
`test_train.py` run against the port; the telemetry reducers give the
JAX package's dicts from the same snapshots.

One port runtime serves the module (`num_cpus=4`, no GPU), and the
crash-and-resume fit trains beside the other tests; train loops
are defined inside functions so they travel by value and a worker never
imports this module (or JAX).
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.train import (Checkpoint, CheckpointManager,
                                 FailureConfig, GpuTrainer, RunConfig,
                                 ScalingConfig)
from ray_tpu_torch.train import telemetry as ptel
from ray_tpu_torch.train import train_step as ts
from test_torch_transformer import numpy_params

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, max_seq=32, arch="llama")
B, S, STEPS = 4, 17, 4
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
LOSS_RTOL = 1e-5
TIMEOUT = 60.0


def _tokens():
    rng = np.random.RandomState(3)
    return rng.randint(0, MODEL["vocab_size"], (B, S)).astype(np.int32)


def _jax_losses(params):
    """Per-step losses of the JAX CompiledTrainStep (AdamW) on a
    one-device CPU mesh."""
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
    batch = step.shard_batch(_tokens())
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def params():
    return numpy_params(tt.TransformerConfig(**MODEL), 0)


@pytest.fixture(scope="module")
def jax_losses(params):
    """The JAX side, compiling in a thread while the port trains."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_jax_losses, params)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rt():
    if ray_tpu_torch.is_initialized():  # a session another module left
        ray_tpu_torch.shutdown()
    # Prestarted workers spare the first workers a process start.
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       _system_config={"worker_pool_prestart": 4})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _make_llama_loop():
    """A train loop over the port's CompiledTrainStep (AdamW, CPU) that
    reports each step's loss under telemetry.  The first attempt saves
    and reports a checkpoint after step `save_at`, trains to the end and
    then dies without cleanup; a restarted attempt resumes from the
    checkpoint."""

    def loop(config):
        import os

        from ray_tpu_torch.models import convert, transformer
        from ray_tpu_torch.train import Checkpoint, session
        from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                    make_optimizer)
        import torch
        ctx = session.get_context()
        cfg = transformer.TransformerConfig(**config["model"],
                                            dtype=torch.float32)
        step = CompiledTrainStep(
            cfg, optimizer=make_optimizer(**config["opt"]), device="cpu")
        state = step.init_state(params=convert.params_from_jax(
            config["params"], cfg, device="cpu"))
        restored = ctx.get_checkpoint()
        if restored is not None:
            state = restored.load_pytree(state)
        tel = ctx.telemetry(tokens_per_step=config["tokens"].size,
                            flops_per_token=step.flops_per_token(
                                config["tokens"].shape[1] - 1),
                            peak_flops=1e12)
        tel.register_jit(step)
        batch = step.shard_batch(config["tokens"])
        while state.step < config["steps"]:
            with tel.device_step():
                state, m = step(state, batch)
                loss = m["loss"].item()
            tel.end_step()
            metrics = {"step": state.step, "loss": loss,
                       "grad_norm": m["grad_norm"].item(),
                       "pid": os.getpid()}
            saved = None
            if state.step == config["save_at"] and restored is None:
                with tel.checkpoint():
                    saved = Checkpoint.save_pytree(
                        os.path.join(ctx.get_trial_dir(),
                                     f"ckpt_{state.step}"),
                        state, metadata={"step": state.step})
            session.report(metrics, checkpoint=saved)
        if restored is None:
            os._exit(1)                 # dies without cleanup

    return loop


def _crash_fit(params, storage_path):
    config = {"model": MODEL, "opt": OPT, "params": params,
              "tokens": _tokens(), "steps": STEPS, "save_at": 2}
    return GpuTrainer(
        _make_llama_loop(), train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(
            name="crash", storage_path=storage_path,
            failure_config=FailureConfig(max_failures=1))).fit()


@pytest.fixture(scope="module", autouse=True)
def run(rt, params, jax_losses, tmp_path_factory):
    """The crash-and-resume fit, started at the module's outset so that
    it trains while the other tests run (each of its two workers takes
    seconds to import torch); its tests come last.  jax_losses first:
    JAX compiles in its own thread meanwhile."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_crash_fit, params,
                      str(tmp_path_factory.mktemp("t")))
    yield fut
    pool.shutdown(wait=True)


def _state_after_a_step(kind, seed):
    cfg = tt.TransformerConfig(**MODEL, dtype=torch.float32)
    step = ts.CompiledTrainStep(
        cfg, optimizer=ts.make_optimizer(**OPT, kind=kind), device="cpu")
    state = step.init_state(seed=seed)
    state, _ = step(state, step.shard_batch(_tokens()))
    return step, state


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_save_load_pytree_roundtrip(tmp_path, kind):
    step, state = _state_after_a_step(kind, seed=1)
    ckpt = Checkpoint.save_pytree(str(tmp_path / "ck"), state,
                                  metadata={"kind": kind})
    assert ckpt.metadata() == {"kind": kind}
    template = step.init_state(seed=7)
    loaded = ckpt.load_pytree(template)
    assert isinstance(loaded, ts.TrainState)
    assert loaded.step == state.step == 1
    assert loaded.opt_state["count"] == state.opt_state["count"] == 1
    # Loaded in place into the template's tensors, bit for bit, with the
    # shapes init_state makes (Adafactor's factored rows and columns).
    for tree in ("params", "opt_state"):
        want = dict(_flat(getattr(state, tree)))
        got = dict(_flat(getattr(loaded, tree)))
        init = dict(_flat(getattr(template, tree)))
        assert set(want) == set(got)
        for key, w in want.items():
            if not isinstance(w, torch.Tensor):
                assert got[key] == w
                continue
            assert got[key] is init[key]
            assert got[key].shape == w.shape and got[key].dtype == w.dtype
            assert torch.equal(got[key], w), key
    assert all(p.requires_grad for p in loaded.params.values()
               if isinstance(p, torch.Tensor))
    # Without a template every tensor comes back whole on the CPU.
    bare = ckpt.load_pytree()
    for key, w in _flat(state.opt_state):
        if isinstance(w, torch.Tensor):
            assert torch.equal(dict(_flat(bare.opt_state))[key], w)
    # A template of another structure is refused.
    with pytest.raises(ValueError):
        ckpt.load_pytree({"params": template.params})


def test_trainer_basic_reports(rt, tmp_path):
    def loop(config=None):
        from ray_tpu_torch.train import session
        ctx = session.get_context()
        assert ctx.get_world_size() == 2
        for step in range(3):
            session.report({"step": step, "rank": ctx.get_world_rank(),
                            "loss": 1.0 / (step + 1)})

    result = GpuTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="basic",
                             storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_dataframe) == 3  # rank-0 reports only
    assert all(m["rank"] == 0 for m in result.metrics_dataframe)
    assert [m["_step"] for m in result.metrics_dataframe] == [0, 1, 2]
    assert all(m["_ts"] <= time.time() for m in result.metrics_dataframe)


def test_trainer_checkpointing(rt, tmp_path):
    def loop(config=None):
        import json
        import os

        from ray_tpu_torch.train import Checkpoint, session
        ctx = session.get_context()
        for step in range(3):
            ckpt_dir = os.path.join(ctx.get_trial_dir(),
                                    f"my_ckpt_{step}")
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            session.report({"step": step},
                           checkpoint=Checkpoint(ckpt_dir))

    result = GpuTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="ckpt",
                             storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.checkpoint is not None
    with open(os.path.join(result.checkpoint.path, "state.json")) as f:
        assert json.load(f)["step"] == 2


def test_trainer_user_error_surfaces(rt, tmp_path):
    def loop(config=None):
        raise RuntimeError("train loop exploded")

    result = GpuTrainer(
        loop, train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="err",
                             storage_path=str(tmp_path))).fit()
    assert result.error is not None
    assert "exploded" in str(result.error)


def test_checkpoint_manager_topk(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "cm"), num_to_keep=2,
                            score_attribute="acc", score_order="max")
    paths = []
    for i, acc in enumerate([0.1, 0.9, 0.5]):
        p = mgr.next_checkpoint_path()
        os.makedirs(p, exist_ok=True)
        paths.append(p)
        mgr.register(Checkpoint(p), {"acc": acc})
    kept = [c.path for c in mgr.list_checkpoints()]
    assert len(kept) == 2
    assert paths[0] not in kept          # worst evicted
    assert not os.path.exists(paths[0])  # and deleted from disk
    assert mgr.best_checkpoint.path == paths[1]


def test_checkpoint_manager_same_path_reregister(tmp_path):
    """Re-reporting one directory must not let eviction delete it."""
    mgr = CheckpointManager(str(tmp_path / "cm2"), num_to_keep=2)
    p = str(tmp_path / "cm2" / "shared")
    os.makedirs(p, exist_ok=True)
    for step in range(5):
        mgr.register(Checkpoint(p), {"step": step})
    assert os.path.exists(p)
    assert mgr.latest_checkpoint.path == p
    assert len(mgr.list_checkpoints()) == 1


# ---------------------------------------------------------------------------
# telemetry reducers: the same snapshots give the same dicts
# ---------------------------------------------------------------------------
def _snap(rank, step_s, n=8, data_wait=0.0, compile_s=0.0, restarts=0):
    window = [{"i": i, "ts": 1000.0 + i, "wall": step_s + data_wait,
               "phases": {"step": step_s, "data_wait": data_wait,
                          **({"compile": compile_s} if i == 0 else {})},
               "tokens": 64} for i in range(n)]
    return {"run": "r", "rank": rank, "world_size": 3, "pid": 100 + rank,
            "node_id": "ab" * 8, "host": "h", "ts": 1010.0, "t0": 1000.0,
            "ledger_ts": 1009.0, "wall_s": 10.0 + rank,
            "restarts": restarts, "step_index": n,
            "phases": {"data_wait": data_wait * n, "compile": compile_s,
                       "step": step_s * n, "checkpoint": 0.5, "sync": 0.0,
                       "resize": 0.0},
            "ledger": {"productive": step_s * n, "compile": compile_s,
                       "input_wait": data_wait * n, "checkpoint": 0.5,
                       "sync": 0.0, "restart_recovery": 1.0 * restarts,
                       "resize_recovery": 0.0, "idle": 0.25},
            "compile_sites": {"site.py:1": compile_s} if compile_s else {},
            "ckpt_reads": {"memory": 0, "disk": restarts},
            "tokens_per_s": 64 / step_s, "mfu": 0.01 * (rank + 1),
            "flops_per_token": 6e6, "window": window, "stopped": False}


SNAPSHOTS = {
    "gang_with_straggler": {0: _snap(0, 0.1), 1: _snap(1, 0.1),
                            2: _snap(2, 0.35, restarts=1)},
    "two_workers": {0: _snap(0, 0.1), 1: _snap(1, 0.2)},
    "too_few_steps": {0: _snap(0, 0.1, n=3), 1: _snap(1, 0.5, n=3)},
    "input_bound": {0: _snap(0, 0.1, data_wait=0.2)},
    "compile_bound": {0: _snap(0, 0.01, n=5, compile_s=5.0)},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_telemetry_reducers_match_jax(name):
    from ray_tpu.train import telemetry as jtel
    snaps = SNAPSHOTS[name]
    assert (ptel.straggler_verdicts(snaps)
            == jtel.straggler_verdicts(snaps))
    meta = {"run": "r", "state": "finished", "world_size": len(snaps),
            "resizes": [{"direction": "shrink", "from": 2, "to": 1}]}
    captures = {0: {"ts": 1.0, "p95_s": 0.3, "median_s": 0.1}}
    assert (ptel.summarize_run(meta, snaps, captures)
            == jtel.summarize_run(meta, snaps, captures))
    for snap in snaps.values():
        assert (ptel._bound_verdict(snap["phases"])
                == jtel._bound_verdict(snap["phases"]))
    assert ptel._bound_verdict({}) == jtel._bound_verdict({})


# ---------------------------------------------------------------------------
# datasets, and GPU requests without a GPU
# ---------------------------------------------------------------------------
def test_datasets_shard_across_workers_and_unknown_shards_raise(rt,
                                                                tmp_path):
    """GpuTrainer(datasets=...) gives each rank its streaming split
    (equal=True: blocks round-robin); an unknown name raises KeyError."""
    def loop(config):
        import json
        import os
        from ray_tpu_torch.train import session
        ctx = session.get_context()
        ids = [int(i) for b in session.get_dataset_shard("train")
               .iter_batches(batch_size=2) for i in b["id"]]
        try:
            session.get_dataset_shard("eval")
            missing = None
        except KeyError as e:
            missing = str(e)
        with open(os.path.join(ctx.get_trial_dir(),
                               f"rank{ctx.get_world_rank()}.json"), "w") as f:
            json.dump({"ids": ids, "missing": missing}, f)

    result = GpuTrainer(
        loop, train_loop_config={},
        datasets={"train": ray_tpu_torch.data.range(10, block_rows=2)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="ds", storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    got = [json.load(open(tmp_path / "ds" / f"rank{r}.json"))
           for r in range(2)]
    assert [g["ids"] for g in got] == [[0, 1, 4, 5, 8, 9], [2, 3, 6, 7]]
    assert {g["missing"] for g in got} == {
        "\"no dataset shard named 'eval'; trainer datasets: ['train']\""}


def test_use_gpu_without_a_gpu_fails_and_does_not_run_on_cpu(rt, tmp_path):
    from ray_tpu_torch._private.device import resolve_device
    marker = tmp_path / "ran"

    def loop(config):
        open(config["marker"], "w").close()

    with pytest.raises(RuntimeError) as want:
        resolve_device()
    trainer = GpuTrainer(
        loop, train_loop_config={"marker": str(marker)},
        scaling_config=ScalingConfig(num_workers=1),      # use_gpu=True
        run_config=RunConfig(name="gpu", storage_path=str(tmp_path)))
    with pytest.raises(RuntimeError) as got:
        trainer.fit()
    assert str(want.value) in str(got.value)
    assert not marker.exists()


# ---------------------------------------------------------------------------
# the crash-and-resume fit (started at the outset; its tests come last)
# ---------------------------------------------------------------------------
def _crash_result(run):
    result = run.result(timeout=300)
    assert result.error is None, result.error
    return result


def test_fit_matches_jax_compiled_train_step(run, jax_losses):
    unbroken = _crash_result(run).metrics_dataframe[:STEPS]
    got = [m["loss"] for m in unbroken]
    assert [m["step"] for m in unbroken] == [1, 2, 3, 4]
    assert [m["_step"] for m in unbroken] == [0, 1, 2, 3]
    want = jax_losses.result(timeout=300)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert got[-1] < got[0]


def test_crash_resumes_from_checkpoint_bit_for_bit(run):
    result = _crash_result(run)
    rows = result.metrics_dataframe
    first, resumed = rows[:STEPS], rows[STEPS:]
    assert [m["step"] for m in resumed] == [3, 4]
    # Bit for bit: the resumed steps start from the checkpoint's exact
    # state, in a new process.
    for a, b in zip(first[2:], resumed):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    assert len({m["pid"] for m in first}) == 1
    assert {m["pid"] for m in resumed} == {resumed[0]["pid"]}
    assert resumed[0]["pid"] != first[0]["pid"]
    # The report index continues across the restart.
    assert [m["_step"] for m in rows] == [0, 1, 2, 3, 4, 5]
    assert result.checkpoint.metadata() == {"step": 2}
    assert result.metrics["step"] == STEPS
    snap = ptel.read_snapshots(ray_tpu_torch._ensure_connected(),
                               "crash")[0]
    assert snap["restarts"] == 1
    assert snap["ledger"]["restart_recovery"] > 0
    assert snap["mfu"] is not None and snap["mfu"] > 0

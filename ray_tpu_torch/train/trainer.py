"""GpuTrainer: multi-worker training orchestration on the actor runtime.

The port's copy of `ray_tpu/train/trainer.py` (reference:
DataParallelTrainer + BackendExecutor + WorkerGroup,
train/data_parallel_trainer.py:25,
train/_internal/backend_executor.py:68, _internal/worker_group.py:102):
N worker actors are spawned with the requested resources, the user's
`train_loop_per_worker` runs inside each worker, `session.report(...)`
streams metrics and checkpoint handles back to the driver, and
FailureConfig governs restart-from-last-checkpoint.

GPU differences from the JAX package:
  * `ScalingConfig(use_gpu=True)` (the default) gives each worker
    `num_gpus=gpus_per_worker or 1`; the runtime pins the worker to its
    cards with CUDA_VISIBLE_DEVICES.  A cluster without the GPU
    resource fails `fit()` with `resolve_device`'s message instead of
    training on the CPU; `use_gpu=False` runs the workers on the CPU.
  * Inside a worker, the step is `CompiledTrainStep` (one process per
    device; a multi-rank mesh is `parallel/mesh_group.py`'s).
  * Checkpoints are `torch.distributed.checkpoint` saves
    (`Checkpoint.save_pytree`).

The driver never imports torch: trainer, session and checkpoint manager
touch it only where a tensor is handled, in the workers.
`datasets=` gives each rank a `ray_tpu_torch.data` streaming split
(`session.get_dataset_shard(name)`), as in the JAX package.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train import session as session_mod


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: int = 0           # GPUs reserved per worker (0: 1)
    resources_per_worker: Optional[Dict[str, float]] = None
    # Elastic gang training (train/elastic.py): shrink-in-place on
    # preemption, grow back when capacity heals, resharding from the
    # in-cluster checkpoint.  None defers to the
    # `train_elastic_enabled` config knob.
    elastic: Optional[bool] = None


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = 2
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    # Stop condition (reference: RunConfig stop): a dict {metric:
    # threshold} or a callable (trial_id, result) -> bool; read by Tune
    # (ROADMAP A2g).
    stop: Any = None


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[Exception]
    path: str
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None


@ray_tpu_torch.remote
class _TrainWorker:
    """One training worker actor.  Reports write through to the control
    plane KV (session.py) so they survive worker crashes."""

    def __init__(self, rank: int, world_size: int, trial_dir: str,
                 config: Dict[str, Any],
                 restore_checkpoint: Optional[str],
                 report_ns: str,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 recovery_class: str = "restart_recovery") -> None:
        self._ctx = session_mod.TrainContext(
            world_size=world_size, world_rank=rank, trial_dir=trial_dir,
            restore_checkpoint=restore_checkpoint, config=config,
            report_ns=report_ns, dataset_shards=dataset_shards,
            recovery_class=recovery_class)
        session_mod.set_context(self._ctx)

    def run(self, fn_and_cfg) -> Optional[str]:
        fn, config = fn_and_cfg
        try:
            if config is not None:
                fn(config)
            else:
                fn()
            return None
        except Exception as e:
            import traceback
            return "".join(traceback.format_exception(
                type(e), e, e.__traceback__))
        finally:
            # Clean-exit telemetry teardown: final snapshot publish,
            # publisher-thread join, per-run gauge removal.  A killed
            # worker skips this — the restarted session restores from
            # the last published snapshot and the driver force-zeroes
            # the gauges at fit() end.
            try:
                self._ctx._stop_telemetry()
            except Exception:
                pass


class GpuTrainer:
    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None) -> None:
        self._fn = train_loop_per_worker
        self._config = train_loop_config
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        # {name: Dataset}: each is streaming_split across the workers;
        # inside the loop, session.get_dataset_shard(name) yields this
        # rank's DataIterator (reference: DataParallelTrainer datasets=
        # + ray.train.get_dataset_shard).
        self._datasets = datasets or {}
        self._stragglers_captured: set = set()

    # ------------------------------------------------------------------
    def _check_start(self) -> None:
        """What fails before any worker is spawned: GPU workers on a
        cluster that has no GPU."""
        s = self._scaling
        if s.use_gpu:
            need = s.gpus_per_worker or 1
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if have < need:
                from ray_tpu_torch._private.accelerators import (
                    NO_GPU_MESSAGE)
                raise RuntimeError(
                    f"{NO_GPU_MESSAGE} (GpuTrainer: ScalingConfig("
                    f"use_gpu=True) needs {need} GPU a worker, the "
                    f"cluster has {have:g}; use_gpu=False trains on the "
                    "CPU)")

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._check_start()
        run_name = self._run_config.name or f"train_{int(time.time())}"
        storage = self._run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
        trial_dir = os.path.join(storage, run_name)
        os.makedirs(trial_dir, exist_ok=True)
        ckpt_cfg = self._run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(trial_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)

        failures_left = self._run_config.failure_config.max_failures
        restore: Optional[str] = None
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        error: Optional[Exception] = None
        self._stragglers_captured = set()
        # A fresh fit must not inherit a previous fit's telemetry
        # state under a reused run name (within-fit restarts DO
        # restore — workers only start publishing after this).
        from ray_tpu_torch.train import telemetry as telemetry_mod
        try:
            telemetry_mod.reset_run(ray_tpu_torch._ensure_connected(),
                                    run_name, trial_dir=trial_dir)
        except Exception:
            pass

        attempt = 0
        terminal = None          # None = aborted (non-retryable raise)
        try:
            while True:
                try:
                    last_metrics = self._run_attempt(
                        trial_dir, manager, restore, attempt, history)
                    error = None
                    terminal = "finished"
                    break
                except (exc.ActorDiedError, exc.WorkerCrashedError,
                        exc.TaskError) as e:
                    error = e
                    if failures_left == 0:
                        terminal = "failed"
                        break
                    failures_left -= 1
                    attempt += 1
                    latest = manager.latest_checkpoint
                    restore = latest.path if latest else None
        finally:
            # terminal stays None when the loop died on a
            # NON-retryable exception (KeyboardInterrupt, a control-
            # plane error out of _drain/wait): the run must not read
            # "finished" in its run meta.
            self._finalize_telemetry(run_name, terminal or "aborted")

        return Result(metrics=last_metrics,
                      checkpoint=manager.latest_checkpoint,
                      error=error, path=trial_dir,
                      metrics_dataframe=history)

    def _finalize_telemetry(self, run_name: str,
                            state: str) -> None:
        """Stamp the run's terminal state in the runs registry and
        force-zero its per-run gauges — workers that died uncleanly
        (SIGKILL mid-run) never ran their own remove(), and the
        node-side aggregate would hold their last samples forever."""
        from ray_tpu_torch.train import telemetry as telemetry_mod
        try:
            client = ray_tpu_torch._ensure_connected()
            if telemetry_mod.read_snapshots(client, run_name):
                telemetry_mod.mark_run_state(client, run_name, state)
                # Only for runs that actually published telemetry:
                # force-zeroing unconditionally would MINT node-side
                # series per fit (the aggregate never deletes series).
                telemetry_mod.remove_run_gauges(run_name, force=True)
        except Exception:
            pass

    def _check_stragglers(self, run_name: str) -> None:
        """Driver-side straggler sweep over the workers' published
        step windows; each newly flagged rank gets ONE targeted stack
        capture through the node service's stack_dump.  The capture
        itself runs on a one-shot daemon thread so the drive loop keeps
        draining reports meanwhile."""
        import threading

        from ray_tpu_torch.train import telemetry as telemetry_mod
        try:
            client = ray_tpu_torch._ensure_connected()
            snaps = telemetry_mod.read_snapshots(client, run_name)
            if len(snaps) < 2:
                return
            for rank, verdict in telemetry_mod.straggler_verdicts(
                    snaps).items():
                if (verdict.get("straggler")
                        and rank not in self._stragglers_captured
                        and rank in snaps):
                    self._stragglers_captured.add(rank)
                    threading.Thread(
                        target=telemetry_mod.capture_straggler,
                        args=(client, run_name, rank, snaps[rank],
                              verdict),
                        daemon=True,
                        name=f"rtpu-straggler-capture-{rank}").start()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _actor_opts(self) -> Dict[str, Any]:
        s = self._scaling
        actor_opts: Dict[str, Any] = {}
        if s.use_gpu:
            # use_gpu with unset gpus_per_worker means one GPU a worker
            # (the reference's use_gpu=True convention).
            actor_opts["num_gpus"] = s.gpus_per_worker or 1
        if s.resources_per_worker:
            actor_opts["resources"] = dict(s.resources_per_worker)
        return actor_opts

    def _run_attempt(self, trial_dir: str, manager: CheckpointManager,
                     restore: Optional[str], attempt: int,
                     history: List[Dict[str, Any]]):
        s = self._scaling
        actor_opts = self._actor_opts()
        report_ns = f"train_reports/{trial_dir}/{attempt}"

        from ray_tpu_torch._private.config import config as _cfg
        elastic_enabled = (s.elastic if s.elastic is not None
                           else bool(_cfg.train_elastic_enabled))
        if elastic_enabled:
            if self._datasets:
                raise ValueError(
                    "elastic training does not support datasets= yet: "
                    "streaming splits are fixed-world (pass batches "
                    "through the loop config, or disable elastic)")
            from ray_tpu_torch.train import elastic as elastic_mod
            return elastic_mod.run_elastic_attempt(
                self, trial_dir, manager, restore, attempt, history,
                actor_opts=actor_opts, report_ns=report_ns)

        # One streaming execution per named dataset, n per-rank feeds.
        # equal=True: SPMD training needs every rank to see the same
        # number of batches, or the stragglers hang in collectives —
        # work-stealing (equal=False) is for throughput consumers.
        shard_lists = {name: ds.streaming_split(s.num_workers,
                                                equal=True)
                       for name, ds in self._datasets.items()}
        coordinators = [its[0]._coord
                        for its in shard_lists.values() if its]
        workers = []
        for rank in range(s.num_workers):
            cls = (_TrainWorker.options(**actor_opts) if actor_opts
                   else _TrainWorker)
            shards = {name: its[rank]
                      for name, its in shard_lists.items()}
            workers.append(cls.remote(rank, s.num_workers, trial_dir,
                                      self._config or {}, restore,
                                      report_ns, shards))

        run_refs = [w.run.remote((self._fn, self._config))
                    for w in workers]
        run_name = os.path.basename(trial_dir.rstrip("/"))
        straggler_check_s = float(_cfg.train_straggler_check_s)
        next_straggler_check = time.time() + straggler_check_s
        try:
            pending = list(run_refs)
            while pending:
                ready, pending = ray_tpu_torch.wait(
                    pending, num_returns=len(pending), timeout=0.25)
                self._drain(report_ns, manager, history)
                if (straggler_check_s > 0
                        and time.time() >= next_straggler_check):
                    next_straggler_check = (time.time()
                                            + straggler_check_s)
                    self._check_stragglers(run_name)
                for r in ready:
                    tb = ray_tpu_torch.get(r)
                    if tb is not None:
                        raise exc.TaskError("train_loop_per_worker", tb)
            self._drain(report_ns, manager, history)
            return history[-1] if history else {}
        except (exc.ActorDiedError, exc.WorkerCrashedError):
            # Salvage reports (incl. checkpoints) written before death.
            self._drain(report_ns, manager, history)
            raise
        finally:
            # Coordinators too: each fit attempt spawns one per
            # dataset, and leaked ones pin their streaming execution's
            # block refs for the life of the cluster.
            for a in workers + coordinators:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    def _drain(self, report_ns: str, manager: CheckpointManager,
               history: List[Dict[str, Any]]) -> None:
        """Pull KV-buffered reports (rank 0's metrics are authoritative;
        any rank's checkpoints register — only after their report, so a
        worker killed while writing never leaves a half-written
        checkpoint as the latest)."""
        import pickle
        client = ray_tpu_torch._ensure_connected()
        for key in sorted(client.kv_keys(report_ns)):
            blob = client.kv_get(report_ns, key)
            client.kv_del(report_ns, key)
            if blob is None:
                continue
            metrics, ckpt_path = pickle.loads(blob)
            rank = int(key.decode().split(":")[0])
            if rank == 0:
                history.append(metrics)
            if ckpt_path:
                manager.register(Checkpoint(ckpt_path), metrics)


# Reference-compatible alias: the DataParallelTrainer role.
DataParallelTrainer = GpuTrainer

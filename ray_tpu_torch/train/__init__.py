"""ray_tpu_torch.train: distributed training orchestration (reference:
Ray Train), the port of `ray_tpu.train`.

Public surface mirrors ray.train: GpuTrainer (DataParallelTrainer
analog), ScalingConfig/RunConfig/FailureConfig/CheckpointConfig, Result,
Checkpoint (saved with torch.distributed.checkpoint), session
get_context()/report(); plus the train step (CompiledTrainStep,
TrainState, make_optimizer).  The torch-heavy train_step symbols are
lazy (PEP 562) so the driver and CPU-only trainer workers don't pay the
torch import.

Telemetry (train/telemetry.py): every worker can open a
``TrainTelemetry`` session — ``session.get_context().telemetry(...)``
inside a train loop, or ``TrainTelemetry(run, client=None)`` offline —
that decomposes each step's wall clock into data_wait / compile /
step / checkpoint / sync (+ implicit idle), keeps a live
decayed-window tokens/s + MFU readout, maintains a run-level goodput
ledger that survives worker restarts through the control-plane KV, and
publishes a rolling step window the trainer's straggler reducer
compares across the gang.  Every ``report()`` is stamped with a
monotonic ``_step`` index + ``_ts`` that survives
resume-from-checkpoint.

Elastic gang training (train/elastic.py): with
``ScalingConfig(elastic=True)`` (or ``train_elastic_enabled``) the
trainer resizes the gang in place on preemption — workers snapshot
sharded state into the object store on a cadence, a per-run keeper
actor registers consistent step manifests in the control-plane KV,
survivors reshard from the in-cluster checkpoint (zero disk reads)
at N−1, and the gang grows back when capacity heals.  Worker surface:
``session.get_context().elastic()`` -> ``ElasticSession``.
"""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.session import (get_context,
                                         get_dataset_shard, report)
from ray_tpu_torch.train.trainer import (CheckpointConfig,
                                         DataParallelTrainer,
                                         FailureConfig, GpuTrainer,
                                         Result, RunConfig, ScalingConfig)

_LAZY = {"CompiledTrainStep", "TrainState", "make_optimizer"}


def __getattr__(name):
    if name in _LAZY:
        from ray_tpu_torch.train import train_step
        return getattr(train_step, name)
    if name == "TrainTelemetry":
        from ray_tpu_torch.train.telemetry import TrainTelemetry
        return TrainTelemetry
    if name in ("ElasticSession", "ResizeInterrupt"):
        from ray_tpu_torch.train import elastic
        return getattr(elastic, name)
    raise AttributeError(name)


__all__ = [
    "Checkpoint", "CheckpointManager", "get_context", "get_dataset_shard",
    "report", "CheckpointConfig", "DataParallelTrainer", "FailureConfig",
    "Result", "RunConfig", "ScalingConfig", "GpuTrainer",
    "CompiledTrainStep", "TrainState", "TrainTelemetry", "make_optimizer",
    "ElasticSession", "ResizeInterrupt",
]

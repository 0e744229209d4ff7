"""Per-worker training session context.

The port's copy of `ray_tpu/train/session.py`.  Analog of the
reference's train session (train/_internal/session.py:111
_TrainSession + ray.train.get_context()): inside a training worker,
user code calls `get_context()` for rank info and `report(metrics,
checkpoint=...)` to stream results to the driver.

The context also owns this worker's telemetry session
(``ctx.telemetry(...)`` -> train/telemetry.py): per-step phase
decomposition, live MFU/goodput, and the published step window the
straggler reducer consumes.  Every ``report()`` is stamped with a
monotonic ``_step`` index and ``_ts`` timestamp; the index is
persisted through the control-plane KV so a resume-from-checkpoint
restart CONTINUES the numbering — timeline spans and metrics agree on
step identity across restarts.
"""

from __future__ import annotations

import os
import time
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_context: Optional["TrainContext"] = None


@dataclass
class _Report:
    metrics: Dict[str, Any]
    checkpoint_path: Optional[str] = None


class TrainContext:
    def __init__(self, world_size: int, world_rank: int,
                 trial_dir: str, restore_checkpoint: Optional[str],
                 config: Dict[str, Any],
                 report_ns: Optional[str] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 recovery_class: str = "restart_recovery") -> None:
        self._dataset_shards = dict(dataset_shards or {})
        # Which goodput ledger class this worker's telemetry charges
        # its restore gap to: "restart_recovery" for a fresh attempt,
        # "resize_recovery" for an elastic grow-back replacement.
        self._recovery_class = recovery_class
        self._world_size = world_size
        self._world_rank = world_rank
        self._trial_dir = trial_dir
        self._restore = restore_checkpoint
        self._config = config
        self._reports: List[_Report] = []
        self._lock = threading.Lock()
        self._finished = False
        # Reports are written through to the control plane's KV so they
        # survive worker death (a checkpoint reported the instant before
        # a crash must still be restorable — reference semantics: report
        # is synchronized with the driver, session.py:111).
        self._report_ns = report_ns
        self._seq = 0
        # Monotonic report index stamped onto every report's metrics;
        # restored from the KV on restart so a resumed run keeps
        # counting instead of resetting to 0 (None = not yet loaded).
        # Its OWN lock (not self._lock) serializes hand-out AND the
        # KV write-through as one unit: two racing report() threads
        # must not land their persists out of order, or a restart
        # would restore the stale lower index and mint a duplicate
        # _step — and nothing else ever blocks on this lock, so the
        # held kv_put cannot convoy the report path.
        self._report_index: Optional[int] = None
        self._seq_lock = threading.Lock()
        self._telemetry = None
        self._elastic = None

    # -- public API (mirrors ray.train context) -------------------------
    def get_world_size(self) -> int:
        return self._world_size

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_trial_dir(self) -> str:
        return self._trial_dir

    def get_config(self) -> Dict[str, Any]:
        return self._config

    def get_checkpoint(self) -> Optional[Checkpoint]:
        """Checkpoint to resume from (set after failure restarts)."""
        if self._restore is None:
            return None
        # Disk-read accounting: the elastic storm drill asserts ZERO
        # restart-from-disk by checking this counter stays flat.
        if self._telemetry is not None:
            try:
                self._telemetry.note_ckpt_read("disk")
            except Exception:
                pass
        return Checkpoint(self._restore)

    def telemetry(self, **kwargs):
        """This worker's TrainTelemetry session (created on first
        call; see train/telemetry.py).  The run id is the trial-dir
        basename, shared by every worker and every restart attempt —
        which is what lets the goodput ledger accumulate across
        restarts."""
        if self._telemetry is None:
            from ray_tpu_torch.train import telemetry as telemetry_mod
            run = os.path.basename(
                self._trial_dir.rstrip("/")) or self._trial_dir
            kwargs.setdefault("recovery_class", self._recovery_class)
            self._telemetry = telemetry_mod.TrainTelemetry(
                run, rank=self._world_rank,
                world_size=self._world_size, **kwargs)
        return self._telemetry

    def elastic(self):
        """This worker's ElasticSession (train/elastic.py): gang
        membership, in-cluster sharded checkpoint save/restore, and
        the resize-aware allreduce.  Requires the trainer to be
        running the elastic path (gang record + checkpoint keeper)."""
        if self._elastic is None:
            from ray_tpu_torch.train import elastic as elastic_mod
            run = os.path.basename(
                self._trial_dir.rstrip("/")) or self._trial_dir
            self._elastic = elastic_mod.ElasticSession(
                run, self._world_rank,
                telemetry_provider=lambda: self._telemetry)
        return self._elastic

    def _stop_telemetry(self) -> None:
        tel, self._telemetry = self._telemetry, None
        if tel is not None:
            tel.stop()

    def _next_report_index(self, client) -> int:
        """Monotonic per-rank report index, persisted through the KV
        so a restarted worker CONTINUES the numbering (resume from
        checkpoint must not reset step identity).  The KV ops run
        under _seq_lock ON PURPOSE — persist order must match
        hand-out order, and the lock guards nothing else."""
        from ray_tpu_torch.train.telemetry import KV_SEQ_NS
        key = f"{self._trial_dir}:{self._world_rank}".encode()
        with self._seq_lock:
            if self._report_index is None:
                restore = 0
                if client is not None:
                    try:
                        blob = client.kv_get(   # ray-tpu: noqa[RT011]
                            KV_SEQ_NS, key)
                        restore = int(blob) + 1 if blob else 0
                    except Exception:
                        restore = 0
                self._report_index = restore
            idx = self._report_index
            self._report_index += 1
            if client is not None:
                try:
                    client.kv_put(          # ray-tpu: noqa[RT011]
                        KV_SEQ_NS, key, str(idx).encode())
                except Exception:
                    pass
        return idx

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        client = None
        if self._report_ns is not None:
            from ray_tpu_torch._private.client import get_global_client
            client = get_global_client()
        stamped = dict(metrics)
        if "_step" not in stamped:
            # Guarded, not setdefault: an eagerly-evaluated default
            # would consume (and persist) an index even when the
            # caller re-reports metrics that already carry the stamp.
            stamped["_step"] = self._next_report_index(client)
        if "_ts" not in stamped:
            stamped["_ts"] = time.time()
        rep = _Report(stamped,
                      checkpoint.path if checkpoint else None)
        if self._report_ns is not None:
            import pickle
            with self._lock:
                seq = self._seq
                self._seq += 1
            key = f"{self._world_rank:05d}:{seq:09d}".encode()
            client.kv_put(self._report_ns, key,
                          pickle.dumps((rep.metrics, rep.checkpoint_path)))
        else:
            with self._lock:
                self._reports.append(rep)

    # -- driver-facing (drained by trainer polls) ------------------------
    def drain_reports(self) -> List[_Report]:
        with self._lock:
            out, self._reports = self._reports, []
            return out


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError("get_context() called outside a train worker")
    return _context


def set_context(ctx: Optional[TrainContext]) -> None:
    global _context
    _context = ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Module-level convenience mirroring ray.train.report."""
    get_context().report(metrics, checkpoint)


def get_dataset_shard(name: str = "train"):
    """This rank's DataIterator for a Dataset passed to
    GpuTrainer(datasets={name: ds}) (reference:
    ray.train.get_dataset_shard)."""
    ctx = get_context()
    shards = getattr(ctx, "_dataset_shards", None) or {}
    if name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r}; trainer datasets: "
            f"{sorted(shards)}")
    return shards[name]

"""Per-operator execution stats for Dataset pipelines.

Analog of the reference's ``data/_internal/stats.py`` (per-op wall/
cpu/mem counters feeding ``Dataset.stats()`` and the dashboard data
panel).  Every operator in a running pipeline keeps an ``OpStats``:
blocks/bytes in and out, current + peak in-flight window depth, and
wall time; the same numbers are published through ``util.metrics``
(Counters/Gauges tagged ``op=<i>:<OpName>``), so they flow through the
node-service aggregation into the dashboard's ``/api/metrics.json``
and Prometheus endpoints with zero extra plumbing.

Byte sizes come from the object directory via the operator's
``MemoryBudget`` (no block fetch); when byte backpressure is disabled
(``DataContext.max_bytes_in_flight=None``) sizes are unknown and
``bytes_out`` stays 0.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

_metrics_lock = threading.Lock()
_metrics: Dict[str, Any] = {}


def _get_metrics() -> Dict[str, Any]:
    """Lazily create the shared metric instruments (one set per
    process; tags distinguish ops/pipelines)."""
    with _metrics_lock:
        if not _metrics:
            from ray_tpu_torch.util.metrics import Counter, Gauge
            _metrics["blocks_out"] = Counter(
                "data_op_blocks_out",
                "Blocks completed by a Dataset operator",
                tag_keys=("op",))
            _metrics["bytes_out"] = Counter(
                "data_op_bytes_out",
                "Bytes completed by a Dataset operator",
                tag_keys=("op",))
            _metrics["queue_depth"] = Gauge(
                "data_op_queue_depth",
                "Current in-flight blocks of a Dataset operator",
                tag_keys=("op",))
            _metrics["wall_s"] = Gauge(
                "data_op_wall_s",
                "Wall seconds since a Dataset operator started",
                tag_keys=("op",))
        return _metrics


class OpStats:
    """Counters for one operator within one pipeline execution."""

    def __init__(self, name: str, index: int) -> None:
        self.name = name
        self.index = index
        self.tag = {"op": f"{index}:{name}"}
        self.submitted = 0
        self.completed = 0
        self.bytes_out = 0
        self.queue_depth = 0
        self.peak_depth = 0
        self.wall_s = 0.0
        self._t0: Optional[float] = None

    def on_start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def on_submit(self, depth: int) -> None:
        self.on_start()
        self.submitted += 1
        self.queue_depth = depth
        self.peak_depth = max(self.peak_depth, depth)
        try:
            _get_metrics()["queue_depth"].set(depth, tags=self.tag)
        except Exception:
            pass

    def on_complete(self, size: Optional[int], depth: int,
                    ref=None) -> None:
        self.on_start()
        self.completed += 1
        self.queue_depth = depth
        if size is None and ref is not None:
            # Order-preserving streams yield refs that may still be
            # pending (never waited on); by the time the consumer pulls
            # the next block this one is usually stored — probe the
            # object directory directly (no fetch).
            try:
                import ray_tpu_torch
                size = ray_tpu_torch._ensure_connected().object_sizes(
                    [ref])[0]
            except Exception:
                size = None
        if size:
            self.bytes_out += size
        if self._t0 is not None:
            self.wall_s = time.perf_counter() - self._t0
        try:
            m = _get_metrics()
            m["blocks_out"].inc(1, tags=self.tag)
            m["queue_depth"].set(depth, tags=self.tag)
            m["wall_s"].set(self.wall_s, tags=self.tag)
            if size:
                m["bytes_out"].inc(size, tags=self.tag)
        except Exception:
            pass

    def to_dict(self) -> Dict[str, Any]:
        return {"op": f"{self.index}:{self.name}",
                "submitted": self.submitted,
                "completed": self.completed,
                "bytes_out": self.bytes_out,
                "queue_depth": self.queue_depth,
                "peak_depth": self.peak_depth,
                "wall_s": round(self.wall_s, 4)}

    def line(self) -> str:
        mb = self.bytes_out / 1e6
        return (f"  op {self.index}: {self.name} — blocks {self.completed}"
                f"/{self.submitted}, {mb:.1f} MB out, "
                f"window peak {self.peak_depth}, {self.wall_s:.2f}s")


class PipelineStats:
    """One execution's per-op stats, attached to the Dataset."""

    def __init__(self, op_names: List[str]) -> None:
        self.ops = [OpStats(n, i) for i, n in enumerate(op_names)]
        self.started_unix = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {"started_unix": self.started_unix,
                "ops": [o.to_dict() for o in self.ops]}

    def summary(self) -> str:
        return "\n".join(o.line() for o in self.ops)

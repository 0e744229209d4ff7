"""Central config registry: the port's copy of `ray_tpu/_private/config.py`.

The serving engine's four knobs (kv_block_size, kv_num_blocks,
prefix_cache_enabled, kv_eviction_policy) keep their defaults and their
`RAY_TPU_<NAME>` overrides, so one environment configures both packages;
only the paths on disk differ (`session_dir_prefix` and the sanitizer
report dirs), so the two runtimes never share a session directory.

TPU-native analog of the reference's single C++ config registry
(`src/ray/common/ray_config_def.h` — 217 RAY_CONFIG(type, name, default)
entries, each overridable via a `RAY_<name>` env var).  We keep the same
shape: every knob is declared once here, typed, defaulted, and overridable
via `RAY_TPU_<NAME>` environment variables or programmatically via
``ray_tpu_torch.init(_system_config={...})``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"

# A node's socket is <prefix>/session_<ms>_<pid>/node.sock, and an
# AF_UNIX path holds 107 bytes at most.
_SOCKET_TAIL = len("/ray_tpu_torch/session_0000000000000_4194304/node.sock")


def _session_dir_prefix_default() -> str:
    """`<temp dir>/ray_tpu_torch`, where Ray keeps its sessions on Linux
    (`tempfile.gettempdir()`: TMPDIR, else /tmp).  A temp dir too long
    for the node's socket path falls back to /tmp."""
    import tempfile
    tmp = tempfile.gettempdir()
    if len(tmp) + _SOCKET_TAIL > 107:
        tmp = "/tmp"
    return os.path.join(tmp, "ray_tpu_torch")


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


@dataclass
class _ConfigEntry:
    name: str
    type: type
    default: Any
    doc: str = ""


class ConfigRegistry:
    """Typed, env-overridable config registry (singleton at module scope)."""

    def __init__(self) -> None:
        self._entries: Dict[str, _ConfigEntry] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, type_: type, default: Any, doc: str = "") -> None:
        self._entries[name] = _ConfigEntry(name, type_, default, doc)

    def get(self, name: str) -> Any:
        entry = self._entries[name]
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        env = os.environ.get(_ENV_PREFIX + name.upper())
        if env is not None:
            if entry.type is bool:
                return _parse_bool(env)
            return entry.type(env)
        return entry.default

    def set(self, name: str, value: Any) -> None:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"Unknown config: {name}")
        with self._lock:
            self._overrides[name] = entry.type(value)

    def update(self, overrides: Dict[str, Any]) -> None:
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()

    def __getattr__(self, name: str) -> Any:
        # Attribute-style access: config.object_store_memory
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None

    def describe(self) -> Dict[str, Any]:
        return {n: self.get(n) for n in self._entries}


config = ConfigRegistry()
_D = config.declare

# ---------------------------------------------------------------------------
# Core runtime
# ---------------------------------------------------------------------------
_D("object_store_memory", int, 256 * 1024 * 1024,
   "Bytes of shared memory for the per-node object store.")
_D("object_store_min_alloc", int, 64, "Allocation granularity / alignment.")
_D("max_direct_call_object_size", int, 100 * 1024,
   "Results <= this many bytes are returned inline (in-process memory "
   "store) instead of the shared-memory store.  Mirrors the reference's "
   "max_direct_call_object_size (ray_config_def.h).")
_D("worker_register_timeout_s", float, 30.0,
   "Seconds to wait for a spawned worker process to register.")
_D("task_default_num_cpus", float, 1.0, "Default CPU requirement per task.")
_D("actor_default_num_cpus", float, 0.0,
   "Default CPU requirement for an actor process (reference default: "
   "actors reserve 0 CPUs when running, 1 for placement).")
_D("worker_pool_prestart", int, 0, "Workers to prestart on init.")
_D("worker_idle_timeout_s", float, 600.0,
   "Idle worker processes are reaped after this many seconds.")
_D("heartbeat_interval_s", float, 1.0, "Node -> GCS heartbeat period.")
_D("health_check_failure_threshold", int, 5,
   "Missed heartbeats before a node is marked dead (reference: "
   "health_check_failure_threshold).")
_D("scheduler_spread_threshold", float, 0.5,
   "Utilization below which the hybrid policy packs; above, spreads "
   "(reference: scheduler_spread_threshold).")
_D("scheduler_top_k_fraction", float, 0.2,
   "Top-k fraction for hybrid scheduling randomization.")
_D("max_pending_lease_requests_per_scheduling_category", int, 10,
   "Pipelined lease requests per scheduling key (reference name kept).")
_D("max_task_retries", int, 3, "Default retries for normal tasks.")
_D("max_actor_restarts", int, 0, "Default actor restarts.")
_D("log_to_driver", bool, True, "Forward worker stdout/stderr to driver.")
_D("session_dir_prefix", str, _session_dir_prefix_default(),
   "Prefix for per-session scratch directories.")
_D("inline_small_args_size", int, 100 * 1024,
   "Task args <= this many bytes are shipped inline in the task spec.")
_D("testing_rpc_failure", str, "",
   "Chaos (legacy): 'method:max_failures' pairs, comma separated — "
   "injected failures in the message layer (reference: "
   "RAY_testing_rpc_failure).  Folded into the chaos_spec schedule.")
_D("testing_asio_delay_us", str, "",
   "Chaos (legacy): 'method:min:max' artificial delays in message "
   "dispatch (reference: RAY_testing_asio_delay_us).  Folded into the "
   "chaos_spec schedule.")
_D("chaos_seed", int, 0,
   "Seed for the chaos fault-injection RNG (_private/chaos.py): the "
   "same seed + workload replays the identical injected-fault trace.")
_D("chaos_spec", str, "",
   "Chaos schedule: comma-separated 'site:key=value:...' entries "
   "(kinds: error, drop, delay, kill_worker, evict, kill_replica, "
   "partition, preempt).  See _private/chaos.py for the grammar; "
   "validate with `ray_tpu_torch chaos`.")
_D("drain_grace_s", float, 30.0,
   "Default grace for a graceful node drain: running tasks get this "
   "long to finish (and actors/objects to migrate) before the node "
   "falls back to the kill-and-retry path and exits.")
_D("preemption_notice_file", str, "",
   "Path polled (~4x/s) by the node monitor: when the file appears, "
   "the node treats it as a TPU preemption notice and begins a "
   "graceful drain.  File contents: empty (use drain_grace_s), a "
   "float (seconds until the deadline), or JSON {\"deadline_s\": N}. "
   "A GCE metadata-watcher shim or a test writes this file.")
_D("gcs_wal_fsync", bool, True,
   "fsync the GCS write-ahead log.  Critical records (named-actor /"
   " node-membership transitions, snapshots) fsync on append; hot-path"
   " records (KV, small-object payloads) batch into one fsync per"
   " gcs_wal_fsync_batch_s window.  Off trades an OS-crash durability"
   " window for append latency (a GCS process crash alone never loses"
   " flushed records).")
_D("gcs_wal_fsync_batch_s", float, 0.05,
   "Max seconds of flushed-but-unsynced hot-path WAL records an OS "
   "crash may lose when gcs_wal_fsync is on.")
_D("gcs_wal_compact_ops", int, 2000,
   "WAL records appended since the last snapshot that trigger "
   "snapshot + log compaction (gcs.snap written, gcs.wal truncated).")
_D("gcs_wal_compact_bytes", int, 8 * 1024 * 1024,
   "WAL size in bytes that triggers snapshot + log compaction "
   "regardless of record count.")
_D("gcs_call_timeout_s", float, 10.0,
   "Default per-call deadline for node->GCS rpcs: a dead-but-connected "
   "GCS surfaces as a timeout into the reconnect/retry path instead of "
   "wedging the caller forever.")
_D("gcs_reconnect_max_s", float, 60.0,
   "Total time a GCS call rides out an outage (transparent reconnect "
   "with exponential backoff) before surfacing ConnectionLost; nodes "
   "keep working on cached locations/actor homes meanwhile.")
_D("gcs_reconnect_delay_ms", int, 50,
   "Base backoff between GCS reconnect attempts; doubles per attempt "
   "with jitter up to gcs_reconnect_max_delay_ms.")
_D("gcs_reconnect_max_delay_ms", int, 2000,
   "Upper bound on the per-attempt GCS reconnect backoff.")
_D("gcs_resync_grace_s", float, 10.0,
   "After a GCS restart, recovered (stale) node records get this long "
   "to reconnect and re-sync before the health check reaps them.")
_D("gcs_status_interval_s", float, 10.0,
   "How often the node monitor polls gcs_status (feeds the "
   "ray_tpu_gcs_wal_bytes gauge and epoch-change detection).")
_D("task_retry_delay_ms", int, 50,
   "Base backoff before a task retry is resubmitted; doubles per "
   "attempt with jitter (reference role: task resubmit backoff).")
_D("task_retry_max_delay_ms", int, 5000,
   "Upper bound on the per-retry backoff delay.")
_D("object_store_prefault", bool, True,
   "Write-touch every store page at creation so puts never pay "
   "first-touch page faults (~4x single-copy put bandwidth).")
_D("object_spilling_enabled", bool, True,
   "Spill sealed objects to disk when the store fills (reference: "
   "automatic_object_spilling_enabled).")
_D("object_spilling_threshold", float, 0.8,
   "Fraction of the object store that may fill before spilling begins.")
_D("object_spilling_dir", str, "",
   "Directory for spilled objects (default: <session_dir>/spill).")
_D("min_spilling_size", int, 1024 * 1024,
   "Batch spills until at least this many bytes are queued.")
_D("max_object_reconstructions", int, 3,
   "Times a lost object may be recomputed from lineage before its "
   "readers get ObjectLostError (reference: max_task_retries role in "
   "object_recovery_manager).")
_D("object_transfer_chunk_bytes", int, 4 * 1024 * 1024,
   "Chunk size for inter-node object transfer (reference: "
   "object_manager_default_chunk_size, 5 MiB).")
_D("object_transfer_window", int, 8,
   "Outstanding chunk requests pipelined per transfer stream "
   "(reference: object_manager_max_bytes_in_flight role).  <=1 falls "
   "back to stop-and-wait chunk RPCs over the control connection.")
_D("object_transfer_parallelism", int, 4,
   "Max concurrent source nodes for a range-split parallel fetch of "
   "one large object.")
_D("object_transfer_multisource_min_bytes", int, 16 * 1024 * 1024,
   "Objects at least this large with multiple holders are fetched as "
   "contiguous ranges from several holders in parallel.")
_D("object_pull_workers", int, 8,
   "Bounded worker pool for the object pull manager (replaces "
   "thread-per-object pulls; reference: pull_manager.h request "
   "pipelining).")
_D("locality_spill_threshold_bytes", int, 1024 * 1024,
   "A queued task whose locally-resident dependency bytes reach this "
   "threshold (and dominate every candidate peer's resident bytes) "
   "briefly waits for local capacity instead of spilling to a "
   "dependency-less node (reference: locality-aware spillback in "
   "cluster_task_manager).")
_D("locality_spill_wait_s", float, 1.0,
   "How long a locality-dominant task waits for local capacity before "
   "spilling anyway.")
_D("dag_spin_us", int, 50,
   "Compiled-graph channel wait: microseconds of pure spin before the "
   "wait degrades to sched_yield (~20ms) and then escalating sleeps.  "
   "Spin covers the hot pipelined case (peer answers within µs); "
   "raise it on dedicated cores, lower it (or 0) when executors "
   "outnumber cores — a spinning waiter steals cycles the producing "
   "stage needs.")
_D("kv_block_size", int, 16,
   "Paged-KV serving: tokens per KV block.  Every request's cache is a "
   "list of fixed-size blocks from a shared pool (vLLM/RPA-style paged "
   "attention); only FULL blocks are prefix-shareable, so smaller "
   "blocks share more but cost more gather indices per decode step.")
_D("kv_num_blocks", int, 0,
   "Paged-KV serving: usable blocks in the shared pool.  0 = auto "
   "(num_slots * ceil(max_len / kv_block_size) — same HBM footprint "
   "as the dense per-slot cache, with sharing as pure upside).")
_D("prefix_cache_enabled", bool, True,
   "Paged-KV serving: keep retired requests' full prompt blocks in a "
   "per-model radix tree so later prompts sharing the prefix decode "
   "from cached blocks (prefill runs only the uncached suffix).")
_D("kv_eviction_policy", str, "lru",
   "Paged-KV serving: how cached (refcount-0) prefix blocks are "
   "reclaimed when the free pool empties.  Only 'lru' is implemented; "
   "the knob exists so a different policy is a config change, not an "
   "API change.")
_D("serve_compiled_pipeline", bool, False,
   "Serve fast lane: route unary deployment requests through a "
   "per-replica compiled graph (router handoff writes into the "
   "graph's input channel) instead of a scheduled actor task per "
   "call.  Streaming requests always use the task path.")

# ---------------------------------------------------------------------------
# TPU / mesh execution layer
# ---------------------------------------------------------------------------
_D("tpu_chips_per_host", int, 4, "Chips per TPU host (v5e/v5p default 4).")
_D("mesh_default_axes", str, "dp,fsdp,tp",
   "Default logical mesh axis names, outer to inner.")
_D("train_report_queue_size", int, 64, "Buffered train.report() messages.")
_D("prefetch_buffer_size", int, 2,
   "Device prefetch depth for host->HBM input pipelines.")
_D("memory_usage_threshold", float, 0.95,
   "Host-memory used fraction above which the memory monitor kills a "
   "worker (reference: memory_monitor.h); >= 1.0 disables killing.")
_D("memory_monitor_refresh_ms", int, 1000,
   "Memory-monitor poll period; 0 disables the monitor.")
_D("memory_monitor_min_rss_mb", float, 64.0,
   "Workers below this RSS are never chosen as OOM-kill victims.")
_D("profile_events_max", int, 10_000,
   "Per-node ring capacity for profile/trace events (ray.timeline "
   "analog; reference: RAY_PROFILING event table).")
_D("event_ring_capacity", int, 0,
   "Per-node lifecycle/profile event ring capacity; 0 falls back to "
   "profile_events_max.  Evictions from the full ring are counted in "
   "ray_tpu_events_dropped_total so long-running clusters can see "
   "lifecycle history silently rolling off.")
_D("stall_detection_enabled", bool, True,
   "Stall sentinel: the node monitor compares every executing task's "
   "elapsed time against the executing-stage latency histogram and "
   "auto-captures the worker's stack when it exceeds the threshold "
   "(a 'stall' lifecycle event; reference role: the dashboard "
   "reporter's py-spy integration, made automatic).")
_D("stall_min_seconds", float, 60.0,
   "Stall sentinel floor: a task is never flagged before running this "
   "long, regardless of the p95-derived threshold.  The effective "
   "threshold is max(stall_min_seconds, stall_p95_multiple * p95).")
_D("stall_p95_multiple", float, 3.0,
   "Stall threshold as a multiple of the executing-stage p95 from the "
   "node's ray_tpu_task_stage_duration_seconds histogram.")
_D("stall_min_samples", int, 10,
   "Minimum completed-task samples in the executing-stage histogram "
   "before its p95 participates in the stall threshold (below this, "
   "only the stall_min_seconds floor applies).")
_D("stall_check_interval_s", float, 2.0,
   "How often the node monitor sweeps executing tasks for stalls.")
_D("train_telemetry_enabled", bool, True,
   "Training telemetry plane (train/telemetry.py): per-step phase "
   "decomposition, live MFU/goodput accounting, and cross-host "
   "straggler detection for train sessions.")
_D("train_telemetry_window", int, 128,
   "Rolling window of per-step records kept (and published) by each "
   "train worker's telemetry session — feeds step-time percentiles "
   "and the straggler reducer.")
_D("train_telemetry_publish_s", float, 1.0,
   "How often a train worker's telemetry session publishes its "
   "snapshot (phase totals, goodput ledger, step window) to the "
   "control-plane KV for state.train_summary() / `ray_tpu_torch train "
   "status`.  A publisher thread keeps snapshots fresh even while a "
   "step is wedged.")
_D("train_span_min_interval_s", float, 0.25,
   "Rate limit for train-step timeline spans: per-step driver events "
   "are BATCHED into one span per interval (an "
   "unbatched per-step notify re-introduces ms-scale stalls on fast "
   "step loops).  0 emits one span per step.")
_D("train_straggler_multiple", float, 1.5,
   "A worker is flagged as the gang's straggler when its step-phase "
   "p95 exceeds the gang median p95 by this multiple (>= 2 workers, "
   "train_straggler_min_steps samples each).")
_D("train_straggler_min_steps", int, 5,
   "Minimum step samples in a worker's telemetry window before it "
   "participates in straggler detection.")
_D("train_straggler_check_s", float, 2.0,
   "How often the trainer driver runs the straggler reducer over the "
   "workers' published step windows (each newly flagged rank gets ONE "
   "targeted stack capture via the stall-sentinel dump path).")
_D("train_input_bound_fraction", float, 0.3,
   "A run is classified input-bound when data_wait takes at least "
   "this fraction of attributed step time (the ingest-vs-compute "
   "verdict in state.train_summary() / `ray_tpu_torch train status`).")
_D("train_mfu_halflife_s", float, 30.0,
   "Half-life of the exponentially decayed window behind the live "
   "tokens/s and MFU readouts (recent steps dominate; a paused run "
   "decays toward zero instead of averaging it away).")
_D("train_elastic_enabled", bool, False,
   "Elastic gang training (train/elastic.py): workers publish sharded "
   "in-cluster checkpoints, and a preempted worker triggers a gang "
   "RESIZE (survivors reshard from the object-store checkpoint and "
   "continue at N-1) instead of a restart-from-disk at fixed world "
   "size; the gang grows back when capacity heals.")
_D("train_ckpt_interval_s", float, 30.0,
   "Cadence of the elastic in-cluster sharded checkpoint: each worker "
   "snapshots its shard of params/opt_state into the object store at "
   "most this often (0 = every step — tests).  The keeper commits a "
   "manifest once every member's shard for a step has arrived.")
_D("train_ckpt_keep", int, 2,
   "Committed in-cluster checkpoint steps the keeper pins at once; "
   "older steps' shard refs are released only AFTER a newer manifest "
   "is registered (never drop the last live copy).")
_D("train_min_world_size", int, 1,
   "Elastic shrink floor: a resize below this many workers is refused "
   "and the failure falls through to the fixed-world restart path.")
_D("train_elastic_poll_s", float, 0.25,
   "How often an elastic worker checks the gang record for an epoch "
   "change (resize) or a preemption notice, and the driver polls for "
   "grow-back capacity.")
_D("train_grow_retry_s", float, 2.0,
   "Elastic grow-back probe cadence: after a shrink, the driver "
   "attempts to re-expand the gang to its full world size at most "
   "this often (each attempt spawns a replacement worker which "
   "reshards from the in-cluster checkpoint).")
_D("train_resize_thrash_per_min", float, 4.0,
   "Doctor threshold for GANG_RESIZE_THRASH: a run whose resize rate "
   "over its lifetime exceeds this many resizes/min is flagged — the "
   "gang is spending its time resharding, not training.")
_D("workflow_storage_dir", str, "",
   "Durable workflow storage root (default: ~/.ray_tpu_torch/workflows). "
   "Deliberately outside the session dir so resume survives shutdown.")
_D("lint_mode", str, "warn",
   "Decoration-time static analysis on @remote/@actor (devtools/lint): "
   "'warn' emits RayTpuLintWarning, 'error' raises LintError, 'off' "
   "disables the check.")
# The lock sanitizer itself has NO config knob on purpose: it is
# enabled ONLY by the RAY_TPU_LOCKSAN env var, read at `import
# ray_tpu_torch` (devtools/locksan.py) — _system_config is applied far too
# late to instrument import-time locks and would not inherit into
# spawned node/worker processes, so a config switch would be a
# silent no-op trap.
_D("lock_hold_warn_ms", float, 500.0,
   "Locksan: a lock held longer than this is recorded as a long-hold "
   "finding (site, duration, holder stack) in the locksan report — "
   "the live counterpart of lint rule RT011's "
   "blocking-call-under-lock class.")
_D("locksan_dir", str, "",
   "Locksan: directory where each process drops its <pid>.json "
   "report for `ray_tpu_torch locksan` / state.locksan_report() to merge "
   "(default <temp dir>/ray_tpu_torch_locksan; RAY_TPU_LOCKSAN_DIR "
   "overrides).")
# The leak ledger follows locksan's rules exactly: enabled ONLY by the
# RAY_TPU_LEAKSAN env var (read at `import ray_tpu_torch`, inherited by
# spawned processes); only the report directory is a config knob.
_D("leaksan_dir", str, "",
   "Leaksan: directory where each process drops its <pid>.json "
   "resource ledger for `ray_tpu_torch leaksan` / state.leaksan_report() "
   "to merge (default <temp dir>/ray_tpu_torch_leaksan; RAY_TPU_LEAKSAN_DIR "
   "overrides).")
_D("metrics_history_resolution_s", float, 2.0,
   "Metrics history ring: sampling interval of the node monitor's "
   "per-series (ts, value) recorder behind state.metric_history() / "
   "/api/metrics/history / `ray_tpu_torch top`.  Counters sample their "
   "running total, gauges their last value, histograms their "
   "observation count.")
_D("metrics_history_window_s", float, 600.0,
   "Metrics history ring: how much trailing history each series "
   "keeps (ring capacity = window / resolution samples; older "
   "samples are evicted).")
_D("metrics_history_max_series", int, 512,
   "Metrics history ring: cap on distinct (name, tags) series "
   "tracked per node — past it, new series are not recorded (bounds "
   "memory under tag-cardinality explosions).")
_D("slow_rpc_min_seconds", float, 1.0,
   "Slow-RPC sentinel floor: an in-flight control-plane handler is "
   "never flagged before running this long (the stall sentinel's "
   "stall_min_seconds, at RPC scale).")
_D("slow_rpc_p95_multiple", float, 5.0,
   "Slow-RPC sentinel: with enough samples, a handler is flagged "
   "when it exceeds this multiple of its method's server-side p95 — "
   "the effective threshold is max(floor, multiple * p95).")
_D("slow_rpc_min_samples", int, 20,
   "Minimum completed-RPC samples in a method's server histogram "
   "before its p95 participates in the slow-RPC threshold (below "
   "this, only the slow_rpc_min_seconds floor applies).")
_D("slow_rpc_capture_window_s", float, 30.0,
   "Slow-RPC sentinel rate limit: at most ONE stack + args capture "
   "per method per this window (the flag counter still increments "
   "for every flagged handler).")
_D("slow_rpc_check_interval_s", float, 2.0,
   "How often the node monitor sweeps in-flight RPC handlers for "
   "slow-RPC flags.")
_D("sched_span_min_interval_s", float, 1.0,
   "Rate limit for sampled `sched.decide` timeline spans: scheduler "
   "decisions are BATCHED into at most one span per interval per "
   "node (the per-decision counters and "
   "the recent-decision ring are always on; only span emission is "
   "sampled).  0 emits one span per scheduling pass.")

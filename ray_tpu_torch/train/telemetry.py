"""Training telemetry & goodput plane: per-step decomposition, live
MFU, ingest-vs-compute attribution, straggler detection.

The port's copy of `ray_tpu/train/telemetry.py`:

* **Per-step decomposition** — each step's wall clock is split into
  ``data_wait`` (blocked on the next batch), ``compile`` (steps on
  which a registered step's compiled-variant count grew), ``step``
  (device compute), ``checkpoint``, ``sync``, ``resize`` and implicit
  ``idle``.  Phases are recorded with context managers
  (``tel.data_wait()``, ``tel.device_step()``, ...) and finalized by
  ``tel.end_step()``.  ``register_jit`` takes the port's
  ``CompiledTrainStep``, whose ``_cache_size`` is the compile
  detector (eager PyTorch compiles nothing, so it stays constant and
  no step is classified ``compile``).

* **Live MFU & goodput** — tokens/s over an exponentially decayed
  window (``train_mfu_halflife_s``), MFU from a declared
  ``flops_per_token`` (or 6·N from ``param_count``) against
  ``peak_flops``; and a run-level *goodput ledger* that classifies
  every wall-clock second into productive / compile / input_wait /
  checkpoint / sync / restart_recovery / resize_recovery / idle.  The
  ledger is persisted through the control-plane KV snapshot and
  restored on a worker restart: the gap between the dead worker's last
  snapshot and the restarted session's first breath is charged to
  ``restart_recovery``.

* **Cross-host step agreement** — every worker publishes its rolling
  step window; :func:`straggler_verdicts` flags a worker whose step
  p95 exceeds the gang median by ``train_straggler_multiple``, and
  the trainer driver takes ONE stack capture of the flagged worker
  through the node service's ``stack_dump``.

`PEAK_FLOPS`/`peak_flops_for` give the MFU denominator for the cards
the port runs on, keyed by `torch.cuda.get_device_name`; a card the
table does not know raises, so a run on the CPU passes ``peak_flops``
or reports no MFU — never one against a guessed peak.

The metric names live in util/metrics.py
(``ray_tpu_train_step_seconds{phase}`` and friends); per-run gauge
series are removed on ``stop()``.  The readers of the run metas,
snapshots and resize records (``state.train_summary()``, the
dashboard's ``/api/train``, the CLI's ``train status``) come with the
state API and the dashboard (ROADMAP A2d, A2e).

Offline mode: constructed with ``client=None`` (no runtime), the
session still decomposes steps, keeps the ledger, and records
process-local metrics.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from ray_tpu_torch._private.config import config
from ray_tpu_torch.devtools import leaksan
from ray_tpu_torch.util import metrics as metrics_mod

# Explicit phases a step can attribute time to; anything left over in
# the step's wall clock lands in the implicit "idle" bucket.
PHASES = ("data_wait", "compile", "step", "checkpoint", "sync",
          "resize")

# Goodput ledger classes: every wall-clock second of the run lands in
# exactly one.  The five the goodput literature names (productive /
# compile / input_wait / restart_recovery / idle) plus checkpoint and
# sync split out so save/collective overhead is visible on its own,
# and resize_recovery so an elastic gang resize (reshard from the
# in-cluster checkpoint, train/elastic.py) is charged separately from
# a restart-from-disk.
LEDGER_CLASSES = ("productive", "compile", "input_wait", "checkpoint",
                  "sync", "restart_recovery", "resize_recovery",
                  "idle")

# The ledger classes a restart gap may be charged to (TrainTelemetry
# recovery_class=): the plain worker-restart path charges
# restart_recovery; an elastic replacement worker charges
# resize_recovery.
RECOVERY_CLASSES = ("restart_recovery", "resize_recovery")

_PHASE_TO_LEDGER = {"data_wait": "input_wait", "compile": "compile",
                    "step": "productive", "checkpoint": "checkpoint",
                    "sync": "sync", "resize": "resize_recovery"}

# Control-plane KV namespaces.  Snapshots are keyed
# "<run>\x1fw:<rank>" (worker snapshots) and "<run>\x1fs:<rank>"
# (straggler capture records); the runs registry maps run -> meta.
KV_RUNS_NS = "__train_runs__"
KV_SNAP_NS = "__train_telemetry__"
KV_SEQ_NS = "__train_report_seq__"
_SEP = "\x1f"

# Dense bf16 tensor-core peak FLOP/s (NVIDIA data sheets, SXM parts, no
# sparsity).  Matched as a prefix of the device name.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,     # H100 SXM
}


def peak_flops_for(device_name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the named card (default: CUDA device 0).
    Raises for a card the table does not know."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    for name, peak in PEAK_FLOPS.items():
        if device_name.startswith(name):
            return peak
    raise KeyError(f"no peak FLOP/s known for {device_name!r}; add it to "
                   "ray_tpu_torch/train/telemetry.py PEAK_FLOPS from the "
                   "card's data sheet")


def transformer_flops_per_token(n_params: int, n_layers: int,
                                seq: int, d_model: int) -> float:
    """Model FLOPs per trained token: 6N + attention 12·L·s·d (PaLM
    appendix B) — the JAX package's formula."""
    return 6.0 * n_params + 12.0 * n_layers * seq * d_model


def run_trace_id(run: str) -> str:
    """Deterministic 16-byte trace id shared by every span of a run —
    all workers and attempts compute the same id without a handshake
    (the lifecycle_span_id trick, applied per run)."""
    return hashlib.md5(run.encode()).hexdigest()


def _snap_key(run: str, rank: int) -> bytes:
    return f"{run}{_SEP}w:{rank:05d}".encode()


def _straggler_key(run: str, rank: int) -> bytes:
    return f"{run}{_SEP}s:{rank:05d}".encode()


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * q), len(sorted_vals) - 1)
    return sorted_vals[idx]


def _median_low(sorted_vals: List[float]) -> float:
    """Lower-middle median: with an even count this picks the smaller
    middle element, so in a 2-worker gang the 'gang median' is the
    FAST worker's p95 and a slow peer can actually exceed
    multiple*median (the upper-middle convention made the slow
    worker its own yardstick — unflaggable by construction)."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[(len(sorted_vals) - 1) // 2]


class _PhaseTimer:
    """Context manager attributing its body's wall time to one phase."""

    __slots__ = ("_tel", "_phase", "_t0")

    def __init__(self, tel: "TrainTelemetry", phase: str) -> None:
        self._tel = tel
        self._phase = phase

    def __enter__(self) -> "_PhaseTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._tel._add_phase(self._phase,
                             time.perf_counter() - self._t0)


class _DeviceStepTimer:
    """Times the device-step body; classified ``compile`` when any
    registered jitted callable's cache grew across it (a shape-change
    step paid tracing/lowering), else ``step``."""

    __slots__ = ("_tel", "_tokens", "_t0", "_jit0")

    def __init__(self, tel: "TrainTelemetry",
                 tokens: Optional[int]) -> None:
        self._tel = tel
        self._tokens = tokens

    def __enter__(self) -> "_DeviceStepTimer":
        self._t0 = time.perf_counter()
        self._jit0 = self._tel._jit_cache_size()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        jit1 = self._tel._jit_cache_size()
        compiled = self._jit0 >= 0 and jit1 > self._jit0
        self._tel._add_phase("compile" if compiled else "step", dt)
        self._tel._note_compile_sites()
        if self._tokens is not None:
            self._tel._note_tokens(self._tokens)


class TrainTelemetry:
    """One worker's telemetry session for one training run.

    Typical use inside a ``train_loop_per_worker`` (the trainer stops
    it automatically when the loop returns)::

        tel = session.get_context().telemetry(
            tokens_per_step=B * S, param_count=n_params,
            peak_flops=peak, jit_fns=[compiled_step])
        for batch in ...:
            with tel.data_wait():
                batch = next(it)
            with tel.device_step():
                state, m = compiled_step(state, batch)
            tel.end_step()

    Thread contract: the step API (phase timers, ``end_step``) is
    driven by the train loop thread; a small publisher thread pushes
    snapshots to the control-plane KV on ``train_telemetry_publish_s``
    so a wedged step still surfaces.  Shared state is guarded by
    ``self._lock``; KV/network pushes always run outside it.
    """

    def __init__(self, run: str, *, rank: int = 0, world_size: int = 1,
                 tokens_per_step: int = 0,
                 flops_per_token: Optional[float] = None,
                 param_count: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 jit_fns: Iterable[Any] = (),
                 client: Any = "auto",
                 publish: bool = True,
                 recovery_class: str = "restart_recovery") -> None:
        if recovery_class not in RECOVERY_CLASSES:
            raise ValueError(
                f"recovery_class {recovery_class!r} not in "
                f"{RECOVERY_CLASSES}")
        # Which ledger class the restore gap (last snapshot -> first
        # breath of this session) is charged to: restart_recovery for
        # the fixed-world restart path, resize_recovery for an elastic
        # replacement worker rejoining after a gang resize.
        self._recovery_class = recovery_class
        if client == "auto":
            from ray_tpu_torch._private.client import get_global_client
            client = get_global_client()
        self._client = client
        self._run = run
        self._rank = int(rank)
        self._world_size = int(world_size)
        self._tokens_per_step = int(tokens_per_step or 0)
        if flops_per_token is None and param_count:
            # 6N: the dense-transformer floor (attention extra needs
            # layer shapes — pass flops_per_token for exactness).
            flops_per_token = 6.0 * float(param_count)
        self._flops_per_token = flops_per_token
        self._peak_flops = peak_flops
        self._jit_fns = [f for f in jit_fns
                         if hasattr(f, "_cache_size")]
        self._trace_id = run_trace_id(run)
        # This worker's node id (hex): disambiguates the straggler
        # stack capture's pid@node keys — bare pids collide across
        # hosts.
        self._node_id = ""
        if self._client is not None:
            try:
                nid = self._client.node_info().get("node_id")
                self._node_id = (nid.hex() if isinstance(nid, bytes)
                                 else str(nid or ""))
            except Exception:
                pass

        self._lock = threading.Lock()
        self._stopped = False
        self._phase_totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._ledger: Dict[str, float] = {c: 0.0
                                          for c in LEDGER_CLASSES}
        # Per-jit-site compile seconds (xlasan attribution): which
        # construction site the run's `compile` ledger class went to.
        self._compile_sites: Dict[str, float] = {}
        # Checkpoint-read accounting: how many restores this worker
        # served from the in-cluster object-store checkpoint vs from
        # disk — the elastic drill's zero-restart-from-disk witness.
        self._ckpt_reads: Dict[str, int] = {"memory": 0, "disk": 0}
        self._window: deque = deque(
            maxlen=max(int(config.train_telemetry_window), 8))
        self._step_index = 0
        self._restarts = 0
        self._t0 = time.time()           # run wall-clock origin
        self._cur: Dict[str, float] = {}
        self._cur_tokens: Optional[int] = None
        self._step_start = time.perf_counter()
        # Wall-clock frontier the ledger is complete up to (advanced
        # by end_step/stop).  Restart gaps are charged from HERE, not
        # from the last snapshot's push time — a snapshot pushed
        # mid-step would otherwise swallow the partial step's time.
        self._ledger_ts = time.time()
        # Decayed-window rate state (tokens/s, MFU).
        self._dec_tokens = 0.0
        self._dec_time = 0.0
        # Span batching: never emit one driver event per step on a
        # fast loop.
        self._span_t0 = time.time()
        self._span_steps = 0
        self._span_phases: Dict[str, float] = {}
        self._last_publish = 0.0

        self._restore()

        # Per-phase pre-resolved observers: the step path skips the
        # tag merge/sort on every observation.
        hist = metrics_mod.shared_histogram(
            metrics_mod.TRAIN_STEP_SECONDS_METRIC,
            "Per-step training wall clock split by phase",
            boundaries=metrics_mod.TRAIN_STEP_BUCKETS,
            tag_keys=("phase",))
        self._hist_obs = {p: hist.observer(tags={"phase": p})
                          for p in PHASES + ("idle",)}
        self._mfu_gauge = metrics_mod.shared_gauge(
            metrics_mod.TRAIN_MFU_METRIC,
            "Live model-FLOPs utilization over a decayed window",
            tag_keys=("run",))
        self._tokens_gauge = metrics_mod.shared_gauge(
            metrics_mod.TRAIN_TOKENS_PER_S_METRIC,
            "Live training tokens/s over a decayed window",
            tag_keys=("run",))
        self._goodput_gauge = metrics_mod.shared_gauge(
            metrics_mod.TRAIN_GOODPUT_FRACTION_METRIC,
            "Run wall-clock ledger class as a fraction of wall",
            tag_keys=("run", "class"))

        # One switch for EVERYTHING that leaves the process (KV
        # snapshots, run meta, timeline spans, the publisher thread):
        # train_telemetry_enabled=False must take the telemetry plane
        # off the step path, not silently move its blocking kv_put
        # from the background thread onto the train loop.
        self._publish_enabled = (self._client is not None and publish
                                 and bool(
                                     config.train_telemetry_enabled))
        if self._publish_enabled and self._rank == 0:
            self._write_run_meta("running")

        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self._publish_enabled:
            t = threading.Thread(
                target=self._publish_loop, daemon=True,
                name=f"rtpu-train-telemetry-{run[:24]}")
            self._thread = t
            t.start()
            leaksan.track_thread(t, detail=f"train-telemetry {run}")

    # -- restore across restarts ----------------------------------------
    def _restore(self) -> None:
        """Resume cumulative state from the last published snapshot of
        this (run, rank): step index, phase totals, and the goodput
        ledger survive a worker kill; the dead time between the last
        snapshot and now is charged to restart_recovery."""
        if self._client is None:
            return
        try:
            blob = self._client.kv_get(KV_SNAP_NS,
                                       _snap_key(self._run, self._rank))
        except Exception:
            return
        if not blob:
            return
        try:
            snap = json.loads(blob)
        except ValueError:
            return
        for p, v in (snap.get("phases") or {}).items():
            if p in self._phase_totals:
                self._phase_totals[p] = float(v)
        for c, v in (snap.get("ledger") or {}).items():
            if c in self._ledger:
                self._ledger[c] = float(v)
        for s, v in (snap.get("compile_sites") or {}).items():
            self._compile_sites[s] = float(v)
        for src, v in (snap.get("ckpt_reads") or {}).items():
            if src in self._ckpt_reads:
                self._ckpt_reads[src] = int(v)
        self._step_index = int(snap.get("step_index") or 0)
        # An elastic replacement resuming after a gang resize is a
        # RESIZE, not a restart — it's already counted by
        # record_resize and must not inflate the restart column.
        self._restarts = (int(snap.get("restarts") or 0)
                          + (1 if self._recovery_class
                             == "restart_recovery" else 0))
        self._t0 = float(snap.get("t0") or self._t0)
        frontier = float(snap.get("ledger_ts") or snap.get("ts")
                         or time.time())
        gap = max(0.0, time.time() - frontier)
        self._ledger[self._recovery_class] += gap

    # -- step API --------------------------------------------------------
    def phase(self, name: str) -> _PhaseTimer:
        """Attribute the body's wall time to `name` (one of PHASES)."""
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; "
                             f"expected one of {PHASES}")
        return _PhaseTimer(self, name)

    def data_wait(self) -> _PhaseTimer:
        """Time blocked waiting on the next batch (the ingest signal)."""
        return _PhaseTimer(self, "data_wait")

    def checkpoint(self) -> _PhaseTimer:
        return _PhaseTimer(self, "checkpoint")

    def sync(self) -> _PhaseTimer:
        return _PhaseTimer(self, "sync")

    def resize(self) -> _PhaseTimer:
        """Time spent handling a gang resize (re-deriving the mesh,
        pulling and resharding the in-cluster checkpoint) — lands in
        the ledger's resize_recovery class."""
        return _PhaseTimer(self, "resize")

    def note_ckpt_read(self, source: str, n: int = 1) -> None:
        """Count a checkpoint restore by where the bytes came from:
        'memory' (in-cluster object-store shards) or 'disk'.  The
        elastic storm drill asserts disk stays at ZERO."""
        if source not in ("memory", "disk"):
            raise ValueError(
                f"ckpt read source {source!r} not in (memory, disk)")
        with self._lock:
            self._ckpt_reads[source] += int(n)

    def device_step(self, tokens: Optional[int] = None
                    ) -> _DeviceStepTimer:
        """Time the device compute; auto-classified as ``compile``
        when a registered jitted callable's cache grows across the
        body (jit cache miss = this step paid tracing/lowering).  The
        caller is responsible for making the body a real device fence
        (``block_until_ready`` / a host transfer on a scalar)."""
        return _DeviceStepTimer(self, tokens)

    def register_jit(self, fn: Any) -> None:
        """Add a step whose ``_cache_size`` growth marks compile steps
        (the port's ``CompiledTrainStep``)."""
        if hasattr(fn, "_cache_size"):
            with self._lock:
                self._jit_fns.append(fn)

    def end_step(self, tokens: Optional[int] = None) -> Dict[str, Any]:
        """Finalize the current step: record the wall split, update
        the rolling window, ledger, decayed rates, metrics, and the
        (rate-limited, batched) timeline span.  Returns the step
        record."""
        now_p = time.perf_counter()
        now_w = time.time()
        with self._lock:
            wall = max(0.0, now_p - self._step_start)
            phases = self._cur
            self._cur = {}
            attributed = sum(phases.values())
            idle = max(0.0, wall - attributed)
            if tokens is None:
                tokens = (self._cur_tokens
                          if self._cur_tokens is not None
                          else self._tokens_per_step)
            self._cur_tokens = None
            rec = {"i": self._step_index,
                   "ts": round(now_w, 3),
                   "wall": round(wall, 6),
                   "phases": {p: round(v, 6)
                              for p, v in phases.items()},
                   "tokens": int(tokens or 0)}
            self._window.append(rec)
            for p, v in phases.items():
                self._phase_totals[p] += v
                self._ledger[_PHASE_TO_LEDGER[p]] += v
            self._ledger["idle"] += idle
            self._ledger_ts = now_w
            self._step_index += 1
            self._step_start = now_p
            # Decayed-window rates: recent steps dominate, a pause
            # decays toward zero instead of averaging it away.
            halflife = max(float(config.train_mfu_halflife_s), 1e-3)
            decay = 0.5 ** (wall / halflife)
            self._dec_tokens = self._dec_tokens * decay + (tokens or 0)
            self._dec_time = self._dec_time * decay + wall
            tokens_rate = (self._dec_tokens / self._dec_time
                           if self._dec_time > 0 else 0.0)
            mfu = self._mfu_locked(tokens_rate)
            # Span batching state.
            self._span_steps += 1
            for p, v in phases.items():
                self._span_phases[p] = self._span_phases.get(p, 0) + v
            self._span_phases["idle"] = (
                self._span_phases.get("idle", 0.0) + idle)
            span_due = (self._publish_enabled
                        and now_w - self._span_t0
                        >= float(config.train_span_min_interval_s))
            if span_due:
                span = {"t0": self._span_t0, "t1": now_w,
                        "steps": self._span_steps,
                        "last_step": self._step_index - 1,
                        "phases": {p: round(v, 6) for p, v
                                   in self._span_phases.items()}}
                self._span_t0 = now_w
                self._span_steps = 0
                self._span_phases = {}
            else:
                span = None
            publish_due = (self._publish_enabled
                           and now_w - self._last_publish
                           >= float(
                               config.train_telemetry_publish_s))
            if publish_due:
                self._last_publish = now_w
                snap = self._snapshot_locked()
            else:
                snap = None
            gauges = self._rank == 0
            ledger_fracs = (self._ledger_fractions_locked()
                            if gauges else None)
        # Everything network/registry-flavored runs OUTSIDE the lock.
        for p, v in phases.items():
            self._hist_obs[p](v)
        if idle > 0:
            self._hist_obs["idle"](idle)
        if gauges:
            self._tokens_gauge.set(tokens_rate,
                                   tags={"run": self._run})
            if mfu is not None:
                self._mfu_gauge.set(mfu, tags={"run": self._run})
            for c, f in ledger_fracs.items():
                self._goodput_gauge.set(
                    f, tags={"run": self._run, "class": c})
        if span is not None:
            self._emit_span(span)
        if snap is not None:
            self._push_snapshot(snap)
        return rec

    def _add_phase(self, phase: str, dt: float) -> None:
        with self._lock:
            self._cur[phase] = self._cur.get(phase, 0.0) + dt

    def _note_compile_sites(self) -> None:
        """Drain the compile sanitizer's (site, seconds) events into
        this run's attribution map — the `compile` goodput class broken
        down by construction site.  The JAX package reads xlasan here;
        the port's analog (a ledger of `torch.compile` recompiles) is
        ROADMAP A9, so until then this records nothing and
        `compile_sites` stays empty."""

    def _note_tokens(self, tokens: int) -> None:
        with self._lock:
            self._cur_tokens = (self._cur_tokens or 0) + int(tokens)

    def _jit_cache_size(self) -> int:
        fns = self._jit_fns
        if not fns:
            return -1
        try:
            return sum(int(f._cache_size()) for f in fns)
        except Exception:
            return -1

    def _mfu_locked(self, tokens_rate: float) -> Optional[float]:
        if not self._flops_per_token or not self._peak_flops:
            return None
        return tokens_rate * self._flops_per_token / self._peak_flops

    def _ledger_fractions_locked(self) -> Dict[str, float]:
        wall = max(time.time() - self._t0, 1e-9)
        return {c: min(v / wall, 1.0)
                for c, v in self._ledger.items()}

    # -- spans -----------------------------------------------------------
    def _emit_span(self, span: Dict[str, Any]) -> None:
        """One batched timeline span covering `steps` steps, on the
        run's shared trace id."""
        if not self._publish_enabled:
            return
        from ray_tpu_torch._private import tracing
        try:
            self._client.profile_event({
                "name": f"train.step[{self._run}]",
                "start": span["t0"], "end": span["t1"],
                "pid": os.getpid(), "user": True,
                "trace_id": self._trace_id,
                "span_id": tracing.new_span_id(),
                "extra": {"run": self._run, "rank": self._rank,
                          "steps": span["steps"],
                          "last_step": span["last_step"],
                          "phases": span["phases"]},
            })
        except Exception:
            pass

    # -- snapshots / publish --------------------------------------------
    def _snapshot_locked(self) -> Dict[str, Any]:
        """Caller holds self._lock."""
        now = time.time()
        wall = max(now - self._t0, 0.0)
        tokens_rate = (self._dec_tokens / self._dec_time
                       if self._dec_time > 0 else 0.0)
        return {
            "run": self._run,
            "rank": self._rank,
            "world_size": self._world_size,
            "pid": os.getpid(),
            "node_id": self._node_id,
            "host": socket.gethostname(),
            "ts": now,
            "t0": self._t0,
            "ledger_ts": self._ledger_ts,
            "wall_s": wall,
            "restarts": self._restarts,
            "step_index": self._step_index,
            "phases": {p: round(v, 6)
                       for p, v in self._phase_totals.items()},
            "ledger": {c: round(v, 6)
                       for c, v in self._ledger.items()},
            "compile_sites": {s: round(v, 6)
                              for s, v in self._compile_sites.items()},
            "ckpt_reads": dict(self._ckpt_reads),
            "tokens_per_s": tokens_rate,
            "mfu": self._mfu_locked(tokens_rate),
            "flops_per_token": self._flops_per_token,
            "window": list(self._window),
            "stopped": self._stopped,
        }

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._snapshot_locked()

    def summary(self) -> Dict[str, Any]:
        """Local single-worker rollup (offline mode's face; the
        cluster face is state.train_summary())."""
        snap = self.snapshot()
        return summarize_run({"run": self._run,
                              "world_size": self._world_size,
                              "state": ("stopped" if snap["stopped"]
                                        else "running")},
                             {self._rank: snap})

    def _push_snapshot(self, snap: Dict[str, Any]) -> None:
        if not self._publish_enabled:
            return
        try:
            self._client.kv_put(KV_SNAP_NS,
                                _snap_key(self._run, self._rank),
                                json.dumps(snap).encode())
        except Exception:
            pass

    def _write_run_meta(self, state: str) -> None:
        # Read-modify-write: the elastic driver's record_resize shares
        # this key — a blind overwrite here would drop resize history
        # recorded before this session came up (a shrink can land
        # before rank 0's first breath).
        try:
            blob = self._client.kv_get(KV_RUNS_NS, self._run.encode())
            meta = json.loads(blob) if blob else {}
        except Exception:
            meta = {}
        meta["run"] = self._run
        meta["started_ts"] = self._t0
        meta["state"] = state
        # record_resize owns world_size once a resize happened.
        if "resizes" not in meta:
            meta["world_size"] = self._world_size
        try:
            self._client.kv_put(KV_RUNS_NS, self._run.encode(),
                                json.dumps(meta).encode())
        except Exception:
            pass

    def _publish_loop(self) -> None:
        interval = max(float(config.train_telemetry_publish_s), 0.05)
        while not self._stop_event.wait(interval):
            with self._lock:
                self._last_publish = time.time()
                snap = self._snapshot_locked()
            self._push_snapshot(snap)

    # -- teardown --------------------------------------------------------
    @property
    def step_index(self) -> int:
        with self._lock:
            return self._step_index

    def stop(self) -> None:
        """Finalize the session: fold the partial step into the
        ledger, stop and join the publisher, push the last snapshot,
        and remove this run's per-run gauge series (the RT015
        contract — repeated runs must not accumulate dead cells)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            # The partial step's attributed phases count; the tail
            # since the last end_step is idle.
            tail = max(0.0, time.perf_counter() - self._step_start)
            for p, v in self._cur.items():
                self._phase_totals[p] += v
                self._ledger[_PHASE_TO_LEDGER[p]] += v
            self._ledger["idle"] += max(
                0.0, tail - sum(self._cur.values()))
            self._ledger_ts = time.time()
            self._cur = {}
            snap = self._snapshot_locked()
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if not t.is_alive():
                leaksan.discharge_thread(t)
        self._push_snapshot(snap)
        if self._rank == 0:
            self._mfu_gauge.remove(tags={"run": self._run})
            self._tokens_gauge.remove(tags={"run": self._run})
            for c in LEDGER_CLASSES:
                self._goodput_gauge.remove(
                    tags={"run": self._run, "class": c})
        # Push pending metric deltas NOW: a short-lived train worker
        # is killed by the trainer right after its loop returns, and
        # the 1s daemon flusher would lose the final step histograms.
        try:
            metrics_mod.flush()
        except Exception:
            pass

    def __enter__(self) -> "TrainTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# cluster-side reducers (driver / state API)
# ---------------------------------------------------------------------------
def read_run_metas(client) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for key in client.kv_keys(KV_RUNS_NS):
        blob = client.kv_get(KV_RUNS_NS, key)
        if not blob:
            continue
        try:
            meta = json.loads(blob)
        except ValueError:
            continue
        out[key.decode()] = meta
    return out


def read_snapshots(client, run: str) -> Dict[int, Dict[str, Any]]:
    """{rank: latest snapshot} for one run."""
    out: Dict[int, Dict[str, Any]] = {}
    prefix = f"{run}{_SEP}w:".encode()
    for key in client.kv_keys(KV_SNAP_NS, prefix=prefix):
        blob = client.kv_get(KV_SNAP_NS, key)
        if not blob:
            continue
        try:
            snap = json.loads(blob)
        except ValueError:
            continue
        out[int(snap.get("rank") or 0)] = snap
    return out


def read_straggler_captures(client, run: str
                            ) -> Dict[int, Dict[str, Any]]:
    out: Dict[int, Dict[str, Any]] = {}
    prefix = f"{run}{_SEP}s:".encode()
    for key in client.kv_keys(KV_SNAP_NS, prefix=prefix):
        blob = client.kv_get(KV_SNAP_NS, key)
        if not blob:
            continue
        try:
            rec = json.loads(blob)
        except ValueError:
            continue
        out[int(rec.get("rank") or 0)] = rec
    return out


def straggler_verdicts(snaps: Dict[int, Dict[str, Any]],
                       multiple: Optional[float] = None,
                       min_steps: Optional[int] = None
                       ) -> Dict[int, Dict[str, Any]]:
    """Pure reducer: per-rank step-phase p95 vs the gang median.

    A rank is a straggler when its p95 exceeds the gang median p95 by
    `multiple` (default config.train_straggler_multiple), with at
    least `min_steps` window samples per participating rank and >= 2
    participating ranks."""
    if multiple is None:
        multiple = float(config.train_straggler_multiple)
    if min_steps is None:
        min_steps = int(config.train_straggler_min_steps)
    p95s: Dict[int, float] = {}
    for rank, snap in snaps.items():
        vals = sorted(
            s["phases"].get("step", 0.0) + s["phases"].get(
                "compile", 0.0)
            for s in (snap.get("window") or [])
            if s.get("phases"))
        if len(vals) >= min_steps:
            p95s[rank] = _percentile(vals, 0.95)
    out: Dict[int, Dict[str, Any]] = {}
    if len(p95s) < 2:
        for rank in snaps:
            out[rank] = {"straggler": False,
                         "p95_s": p95s.get(rank),
                         "median_s": None}
        return out
    med = _median_low(sorted(p95s.values()))
    for rank, p95 in p95s.items():
        out[rank] = {
            "straggler": med > 0 and p95 > multiple * med,
            "p95_s": p95,
            "median_s": med,
            "multiple": (p95 / med) if med > 0 else None,
        }
    for rank in snaps:
        out.setdefault(rank, {"straggler": False, "p95_s": None,
                              "median_s": med})
    return out


def capture_straggler(client, run: str, rank: int,
                      snap: Dict[str, Any],
                      verdict: Dict[str, Any]) -> Optional[str]:
    """ONE targeted stack capture of a flagged worker via the node
    service's stall-sentinel dump path; the stack is persisted next to the run's
    snapshots, a timeline span records the verdict, and the straggler
    counter bumps.  Returns the captured stack text (or None)."""
    stack = None
    pid = snap.get("pid")
    # Cluster stack keys: bare pid for head-local workers,
    # "pid@<node12>" for remote ones (pids collide across hosts).  A
    # straggler KNOWN to live on a remote node must match its exact
    # pid@node key — falling back to a bare pid there would attach an
    # unrelated head-local process's stack whenever numeric pids
    # collide, misdirecting the diagnosis exactly when the remote
    # node is wedged enough to miss the dump window.
    node12 = (snap.get("node_id") or "")[:12]
    head12 = ""
    try:
        hn = client.node_info().get("node_id")
        head12 = (hn.hex() if isinstance(hn, bytes)
                  else str(hn or ""))[:12]
    except Exception:
        pass
    try:
        reply = client.conn.call({"type": "stack_dump",
                                  "timeout": 5.0, "cluster": True},
                                 timeout=20.0)
        stacks = {str(k): v
                  for k, v in (reply.get("stacks") or {}).items()}
        if node12 and node12 != head12:
            stack = stacks.get(f"{pid}@{node12}")
        else:
            stack = stacks.get(str(pid))
    except Exception:
        pass
    rec = {"run": run, "rank": rank, "ts": time.time(),
           "p95_s": verdict.get("p95_s"),
           "median_s": verdict.get("median_s"),
           "stack": (stack or "")[:8000]}
    try:
        client.kv_put(KV_SNAP_NS, _straggler_key(run, rank),
                      json.dumps(rec).encode())
    except Exception:
        pass
    from ray_tpu_torch._private import tracing
    try:
        now = time.time()
        client.profile_event({
            "name": f"train.straggler[{run}]",
            "start": now, "end": now,
            "pid": os.getpid(), "user": True,
            "trace_id": run_trace_id(run),
            "span_id": tracing.new_span_id(),
            "extra": {"run": run, "rank": rank,
                      "p95_s": verdict.get("p95_s"),
                      "median_s": verdict.get("median_s")},
        })
    except Exception:
        pass
    metrics_mod.shared_counter(
        metrics_mod.TRAIN_STRAGGLERS_METRIC,
        "Gang workers flagged as stragglers by the train reducer",
        tag_keys=("run",)).inc(tags={"run": run})
    return stack


def reset_run(client, run: str,
              trial_dir: Optional[str] = None) -> None:
    """Driver-side, called as a fresh fit() starts: clear any
    PREVIOUS fit's persisted state under this run name.  Without
    this, a reused RunConfig name restores the old fit's ledger and
    step index and charges the entire between-fits gap to
    restart_recovery.  Within-fit worker restarts are unaffected —
    workers construct their telemetry only after this runs.  Passing
    `trial_dir` also clears the report-index counters so the
    telemetry step index and the report ``_step`` stamp restart in
    agreement."""
    try:
        for key in client.kv_keys(KV_SNAP_NS,
                                  prefix=f"{run}{_SEP}".encode()):
            client.kv_del(KV_SNAP_NS, key)
        client.kv_del(KV_RUNS_NS, run.encode())
        if trial_dir:
            for key in client.kv_keys(KV_SEQ_NS,
                                      prefix=f"{trial_dir}:".encode()):
                client.kv_del(KV_SEQ_NS, key)
    except Exception:
        pass


def mark_run_state(client, run: str, state: str) -> None:
    """Driver-side run lifecycle stamp in the runs registry."""
    try:
        blob = client.kv_get(KV_RUNS_NS, run.encode())
        meta = json.loads(blob) if blob else {"run": run}
    except Exception:
        meta = {"run": run}
    meta["state"] = state
    meta["updated_ts"] = time.time()
    try:
        client.kv_put(KV_RUNS_NS, run.encode(),
                      json.dumps(meta).encode())
    except Exception:
        pass


def set_world_size_gauge(run: str, world_size: int) -> None:
    """Driver-side: the run's CURRENT gang size
    (``ray_tpu_train_world_size{run}``).  A per-run series — removed
    by remove_run_gauges when the run finalizes (RT015)."""
    metrics_mod.shared_gauge(
        metrics_mod.TRAIN_WORLD_SIZE_METRIC,
        "Current world size of an elastic train gang",
        tag_keys=("run",)).set(float(world_size), tags={"run": run})


def record_resize(client, run: str, direction: str, old_size: int,
                  new_size: int, step: int,
                  dead_s: float = 0.0) -> None:
    """Driver-side elastic-resize bookkeeping: append the event to the
    run meta (capped history — train status / doctor read it), bump
    ``ray_tpu_train_resizes_total{direction}``, and move the world-size
    gauge.  ``step`` is the checkpoint step the survivors resharded
    from; ``dead_s`` the driver-observed resize dead time."""
    if direction not in ("shrink", "grow"):
        raise ValueError(f"direction {direction!r} not shrink/grow")
    try:
        blob = client.kv_get(KV_RUNS_NS, run.encode())
        meta = json.loads(blob) if blob else {"run": run}
    except Exception:
        meta = {"run": run}
    events = list(meta.get("resizes") or [])
    events.append({"ts": time.time(), "direction": direction,
                   "from": int(old_size), "to": int(new_size),
                   "step": int(step), "dead_s": round(dead_s, 3)})
    meta["resizes"] = events[-32:]       # capped: meta stays small
    meta["resize_count"] = int(meta.get("resize_count") or 0) + 1
    meta["world_size"] = int(new_size)
    meta["updated_ts"] = time.time()
    try:
        client.kv_put(KV_RUNS_NS, run.encode(),
                      json.dumps(meta).encode())
    except Exception:
        pass
    metrics_mod.shared_counter(
        metrics_mod.TRAIN_RESIZES_METRIC,
        "Elastic gang resizes, by direction",
        tag_keys=("direction",)).inc(tags={"direction": direction})
    set_world_size_gauge(run, new_size)


def remove_run_gauges(run: str, force: bool = True) -> None:
    """Zero a run's per-run gauge series even when THIS process never
    wrote them — cross-process cleanup for workers that died uncleanly
    (SIGKILL mid-run: their registry died with them, the node-side
    aggregate would read the last live value forever)."""
    metrics_mod.shared_gauge(
        metrics_mod.TRAIN_MFU_METRIC, tag_keys=("run",)
    ).remove(tags={"run": run}, force=force)
    metrics_mod.shared_gauge(
        metrics_mod.TRAIN_TOKENS_PER_S_METRIC, tag_keys=("run",)
    ).remove(tags={"run": run}, force=force)
    g = metrics_mod.shared_gauge(
        metrics_mod.TRAIN_GOODPUT_FRACTION_METRIC,
        tag_keys=("run", "class"))
    for c in LEDGER_CLASSES:
        g.remove(tags={"run": run, "class": c}, force=force)
    metrics_mod.shared_gauge(
        metrics_mod.TRAIN_WORLD_SIZE_METRIC, tag_keys=("run",)
    ).remove(tags={"run": run}, force=force)


def _bound_verdict(phase_totals: Dict[str, float]) -> Dict[str, Any]:
    active = sum(phase_totals.get(p, 0.0) for p in PHASES)
    if active <= 0:
        return {"bound": "unknown", "verdict": "no steps recorded"}
    frac = {p: phase_totals.get(p, 0.0) / active for p in PHASES}
    if frac["data_wait"] >= float(config.train_input_bound_fraction):
        bound = "input-bound"
        line = (f"input-bound: data_wait "
                f"{frac['data_wait'] * 100:.0f}% of step time")
    elif frac["compile"] >= 0.5:
        bound = "compile-bound"
        line = (f"compile-bound: compile "
                f"{frac['compile'] * 100:.0f}% of step time")
    else:
        bound = "compute-bound"
        line = (f"compute-bound: step "
                f"{frac['step'] * 100:.0f}% of step time")
    return {"bound": bound, "verdict": line}


def summarize_run(meta: Dict[str, Any],
                  snaps: Dict[int, Dict[str, Any]],
                  captures: Optional[Dict[int, Dict[str, Any]]] = None
                  ) -> Dict[str, Any]:
    """Merge one run's worker snapshots into the rollup
    state.train_summary() serves: phase decomposition, goodput
    ledger, live rates, step percentiles, straggler verdicts, and the
    bound verdict line."""
    phases: Dict[str, float] = {p: 0.0 for p in PHASES}
    ledger: Dict[str, float] = {c: 0.0 for c in LEDGER_CLASSES}
    wall = 0.0
    step_index = 0
    tokens_per_s = 0.0
    mfus: List[float] = []
    restarts = 0
    step_samples: List[float] = []
    compile_sites: Dict[str, float] = {}
    ckpt_reads: Dict[str, int] = {"memory": 0, "disk": 0}
    for snap in snaps.values():
        for p, v in (snap.get("phases") or {}).items():
            if p in phases:
                phases[p] += float(v)
        for c, v in (snap.get("ledger") or {}).items():
            if c in ledger:
                ledger[c] += float(v)
        for s, v in (snap.get("compile_sites") or {}).items():
            compile_sites[s] = compile_sites.get(s, 0.0) + float(v)
        for src, v in (snap.get("ckpt_reads") or {}).items():
            if src in ckpt_reads:
                ckpt_reads[src] += int(v)
        wall = max(wall, float(snap.get("wall_s") or 0.0))
        step_index = max(step_index,
                         int(snap.get("step_index") or 0))
        tokens_per_s += float(snap.get("tokens_per_s") or 0.0)
        if snap.get("mfu") is not None:
            mfus.append(float(snap["mfu"]))
        restarts = max(restarts, int(snap.get("restarts") or 0))
        step_samples.extend(
            s.get("wall", 0.0) for s in (snap.get("window") or []))
    n_workers = max(len(snaps), 1)
    # Phase seconds and the ledger are summed over the gang, so the
    # wall-clock denominator is one worker's clock times the number
    # of reporting workers.
    active = sum(phases.values())
    per_worker_wall = wall * len(snaps)
    coverage = (sum(ledger.values()) / per_worker_wall
                if per_worker_wall > 0 else 0.0)
    step_samples.sort()
    out = {
        "run": meta.get("run"),
        "state": meta.get("state", "running"),
        "world_size": meta.get("world_size",
                               max(n_workers, 1)),
        "workers_reporting": len(snaps),
        "restarts": restarts,
        "step_index": step_index,
        "wall_s": wall,
        "phases": {p: {"seconds": round(v, 6),
                       "fraction": (v / active if active > 0
                                    else 0.0)}
                   for p, v in phases.items()},
        "coverage": coverage,
        "ledger": {c: round(v, 6) for c, v in ledger.items()},
        "goodput_fraction": (ledger["productive"] / per_worker_wall
                             if per_worker_wall > 0 else 0.0),
        "tokens_per_s": tokens_per_s,
        "mfu": (sum(mfus) / len(mfus)) if mfus else None,
        "step_ms": {
            "p50": _percentile(step_samples, 0.50) * 1000.0,
            "p95": _percentile(step_samples, 0.95) * 1000.0,
        },
        "stragglers": {
            str(r): v
            for r, v in straggler_verdicts(snaps).items()},
        "ckpt_reads": ckpt_reads,
    }
    # Elastic resize history lives on the run meta (the driver's
    # record_resize writes it): surface it plus the CURRENT gang size
    # so `ray_tpu train status` shows a resize as it happens.
    if meta.get("resizes"):
        out["resizes"] = meta["resizes"]
        out["resize_count"] = int(meta.get("resize_count")
                                  or len(meta["resizes"]))
    if compile_sites:
        # xlasan attribution: the `compile` ledger class broken down
        # by jit construction site, gang-summed, costliest first.
        out["compile_sites"] = {
            s: round(v, 6) for s, v in sorted(
                compile_sites.items(), key=lambda kv: -kv[1])}
    out.update(_bound_verdict(phases))
    if captures:
        out["straggler_captures"] = {
            str(r): {k: rec.get(k) for k in
                     ("ts", "p95_s", "median_s")}
            for r, rec in captures.items()}
    return out

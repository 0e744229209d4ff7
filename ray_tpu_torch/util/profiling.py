"""Tracing/profiling: runtime timeline + user spans.

Counterpart of `ray_tpu/util/profiling.py`.  Span half:
* `timeline(filename)` (python/ray/_private/state.py chrome-trace
  export of profile events),
* `span()` / `@profiled` / `record_span()`, recorded into the same
  per-node event ring workers feed with task execution spans — Serve's
  proxy, router, replica and LLM TTFT spans ride these,
* `export_otlp()` and the stack-dump helpers.

Device half: `gpu_trace(logdir)` (the JAX package's `tpu_trace`) is a
`torch.profiler` capture over the CPU and, where there is one, the
card, written as a Chrome trace into `logdir`; `annotate(name)` is a
`torch.profiler.record_function` range with an NVTX range of the same
name.  Both import torch only when called.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import tracing
from ray_tpu_torch._private.client import get_global_client


def _client():
    c = get_global_client()
    if c is None:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return c


def current_trace_id() -> Optional[str]:
    """The ambient trace id (set inside `span()` bodies and task
    executions), or None outside any trace."""
    ctx = tracing.current()
    return ctx["trace_id"] if ctx else None


def timeline_events(cluster: bool = True) -> List[dict]:
    """Raw profile events: task execution spans (name/start/end/pid/
    node) + custom `span()` records."""
    return _client().timeline_events(cluster=cluster)


_TRACE_ARG_KEYS = ("failed", "extra", "trace_id", "span_id",
                   "parent_span_id", "task_id")


def timeline(filename: Optional[str] = None) -> Any:
    """Chrome-trace export (open in chrome://tracing or Perfetto).
    Returns the event list; writes JSON when `filename` is given.

    Task-lifecycle records expand into per-stage child spans
    (submit/queued/dispatch/executing) on the worker's row, linked to
    the proxy/router/user spans of the same request by `trace_id` in
    `args` — one flame per request across processes.
    Reference: ray.timeline."""
    traced = []
    for ev in timeline_events():
        args = {k: v for k, v in ev.items() if k in _TRACE_ARG_KEYS
                and v is not None}
        if ev.get("kind") == "gcs_restart":
            args["epoch"] = ev.get("epoch")
            args["resync_s"] = ev.get("resync_s")
        if ev.get("kind") == "stall":
            # Sentinel capture: elapsed/threshold plus (a bounded
            # slice of) the worker stack ride in the span args.
            args["elapsed_s"] = ev.get("elapsed_s")
            args["threshold_s"] = ev.get("threshold_s")
            stack = ev.get("stack") or ""
            args["stack"] = stack[:4000]
        if ev.get("kind") == "slow_rpc":
            # Slow-RPC sentinel: same shape as a stall capture plus
            # the handler method and a size-bounded args summary.
            args["method"] = ev.get("method")
            args["elapsed_s"] = ev.get("elapsed_s")
            args["threshold_s"] = ev.get("threshold_s")
            args["rpc_args"] = ev.get("rpc_args")
            stack = ev.get("stack") or ""
            args["stack"] = stack[:4000]
        if ev.get("kind") == "sched":
            # Batched scheduler-decision span: outcome counts for the
            # scheduling episode the span covers.
            args["outcomes"] = ev.get("outcomes")
            args["decisions"] = ev.get("decisions")
        row = {
            "name": ev.get("name", "<span>"),
            "cat": ("lifecycle" if ev.get("kind") == "lifecycle" else
                    "drain" if ev.get("kind") == "drain" else
                    "stall" if ev.get("kind") == "stall" else
                    "slow_rpc" if ev.get("kind") == "slow_rpc" else
                    "sched" if ev.get("kind") == "sched" else
                    "gcs_restart" if ev.get("kind") == "gcs_restart"
                    else "actor" if ev.get("actor") else
                    "user" if ev.get("user") else "task"),
            "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": max(ev["end"] - ev["start"], 0.0) * 1e6,
            "pid": ev.get("node_id", "node")[:8],
            "tid": ev.get("pid", 0),
            "args": args,
        }
        traced.append(row)
        if ev.get("kind") == "lifecycle":
            base = ev.get("task_name") or ev.get("name", "<task>")
            for stage, s0, s1 in tracing.stage_intervals(
                    ev.get("stages") or {}):
                traced.append({
                    "name": f"{base}:{stage}",
                    "cat": "lifecycle",
                    "ph": "X",
                    "ts": s0 * 1e6,
                    "dur": max(s1 - s0, 0.0) * 1e6,
                    "pid": row["pid"],
                    "tid": row["tid"],
                    "args": dict(args, stage=stage),
                })
    traced.sort(key=lambda e: e["ts"])
    if filename:
        with open(filename, "w") as f:
            json.dump(traced, f)
    return traced


def record_span(name: str, start: float, end: float,
                trace_ctx: Optional[Dict[str, str]] = None,
                **extra) -> None:
    """Record a span with explicit timestamps (e.g. a latency
    decomposition measured after the fact).  Attaches the ambient
    trace context — or an explicit `trace_ctx` captured earlier, for
    spans finalized outside the originating context (generator
    drains, callbacks) — so the span joins the request's trace."""
    ev: Dict[str, Any] = {"name": name, "start": start, "end": end,
                          "pid": os.getpid(), "user": True,
                          "extra": extra or None}
    ctx = trace_ctx if trace_ctx is not None else tracing.current()
    if ctx is not None:
        ev["trace_id"] = ctx["trace_id"]
        ev["span_id"] = tracing.new_span_id()
        ev["parent_span_id"] = ctx["span_id"]
    try:
        _client().profile_event(ev)
    except Exception:
        pass


@contextlib.contextmanager
def span(name: str, **extra):
    """Record a custom span from driver or task code into the runtime
    timeline (reference: ray.util.tracing spans / ray.profile).

    Opens a child of the ambient trace context (or roots a new trace),
    and activates it for the body — so tasks submitted inside the span
    carry the trace across processes."""
    info = tracing.child_span()
    token = tracing.set_current(info)
    t0 = time.time()
    try:
        yield
    finally:
        tracing.reset(token)
        try:
            _client().profile_event({
                "name": name, "start": t0, "end": time.time(),
                "pid": os.getpid(), "user": True,
                "trace_id": info["trace_id"],
                "span_id": info["span_id"],
                "parent_span_id": info["parent_span_id"],
                "extra": extra or None})
        except Exception:
            pass


def profiled(fn=None, *, name: Optional[str] = None):
    """Decorator form of `span()`."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*a, **kw):
            with span(name or f.__qualname__):
                return f(*a, **kw)
        return wrapper
    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def gpu_trace(logdir: str):
    """Device profile of the enclosed region: `torch.profiler.profile`
    over the CPU and CUDA (when a card is present), written on exit as
    a Chrome trace `<host>.<pid>.<ms>.pt.trace.json` in `logdir` (view
    in Perfetto or chrome://tracing).  It captures kernel times and the
    host's launch timeline — the device-side complement to the runtime
    timeline.  Yields the profiler (`key_averages()` and the rest)."""
    import socket

    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}."
                f"{int(time.time() * 1000)}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named device region: a `torch.profiler.record_function` range
    (it shows under `name` in a `gpu_trace`) and an NVTX range of the
    same name when a card is present.  A context manager and a
    decorator."""
    import torch
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def export_otlp(filename: Optional[str] = None,
                endpoint: Optional[str] = None,
                service_name: str = "ray_tpu_torch") -> dict:
    """Export the profile spans as OTLP/JSON (the OpenTelemetry
    ExportTraceServiceRequest schema), so any OTLP-ingesting backend
    (Jaeger, Tempo, collector) can read them — the reference's
    util/tracing/tracing_helper.py role without requiring the otel SDK
    in the image.  Writes to `filename` and/or POSTs to `endpoint`
    (an OTLP/HTTP traces URL); returns the payload."""
    import os
    import urllib.request

    def span_id(n: int) -> str:
        return f"{n & 0xFFFFFFFFFFFFFFFF:016x}"

    spans = []
    # Fallback trace for legacy events recorded without a trace
    # context; traced events carry their own per-request trace ids.
    trace_id = os.urandom(16).hex()
    for i, ev in enumerate(timeline_events()):
        attrs = [{"key": "node.id",
                  "value": {"stringValue": str(ev.get("node_id", ""))[:16]}},
                 {"key": "process.pid",
                  "value": {"intValue": str(ev.get("pid", 0))}}]
        for k, v in (ev.get("extra") or {}).items() \
                if isinstance(ev.get("extra"), dict) else []:
            attrs.append({"key": str(k),
                          "value": {"stringValue": str(v)}})
        sp = {
            "traceId": ev.get("trace_id") or trace_id,
            "spanId": ev.get("span_id") or span_id(i + 1),
            "name": ev.get("name", "<span>"),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(ev["start"] * 1e9)),
            "endTimeUnixNano": str(int(max(ev["end"], ev["start"]) * 1e9)),
            "attributes": attrs,
            "status": ({"code": 2} if ev.get("failed")
                       else {"code": 1}),
        }
        if ev.get("parent_span_id"):
            sp["parentSpanId"] = ev["parent_span_id"]
        spans.append(sp)
    payload = {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{
            "scope": {"name": "ray_tpu_torch.profiling"},
            "spans": spans,
        }],
    }]}
    if filename:
        with open(filename, "w") as f:
            json.dump(payload, f)
    if endpoint:
        req = urllib.request.Request(
            endpoint, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10).read()
    return payload


def stack_traces(timeout: float = 10.0,
                 cluster: bool = True) -> Dict[Any, str]:
    """On-demand stack dump of every live worker process in the
    cluster (reference: the dashboard reporter's py-spy integration).
    Returns {pid: formatted stacks}; workers on remote nodes appear
    under "pid@node" keys (pids collide across hosts).  cluster=False
    restricts to the local node — which used to be the silent behavior
    of this documented "every live worker" API."""
    return _client().conn.call({"type": "stack_dump",
                                "timeout": timeout,
                                "cluster": cluster},
                               timeout=timeout + 15.0)["stacks"]


def stack_task(task_id: str, timeout: float = 10.0) -> Dict[Any, str]:
    """Targeted stack capture of the worker(s) currently executing the
    task whose id matches the hex prefix `task_id` (anywhere in the
    cluster) — the on-demand face of the stall sentinel's automatic
    captures.  Returns {} when the task is not executing."""
    return _client().conn.call({"type": "stack_dump",
                                "timeout": timeout,
                                "task_id": task_id,
                                "cluster": True},
                               timeout=timeout + 15.0)["stacks"]


def folded_stacks(samples: int = 40, interval_s: float = 0.02,
                  timeout: float = 10.0, cluster: bool = True,
                  task_id: Optional[str] = None) -> Dict[str, int]:
    """Cluster flamegraph sampling: every live worker captures its
    thread stacks `samples` times, `interval_s` apart; the node layer
    merges the folded-stack counts across workers and nodes.  With a
    `task_id` hex prefix, only the worker(s) executing that task are
    sampled.  Returns {"thread;frame;frame;...": count}."""
    msg = {"type": "stack_dump", "timeout": timeout,
           "cluster": cluster, "samples": samples,
           "interval_s": interval_s}
    if task_id:
        msg["task_id"] = task_id
    reply = _client().conn.call(
        msg, timeout=timeout + samples * interval_s + 15.0)
    return reply.get("folded") or {}


def flamegraph(samples: int = 40, interval_s: float = 0.02,
               timeout: float = 10.0, cluster: bool = True,
               task_id: Optional[str] = None,
               filename: Optional[str] = None) -> str:
    """`folded_stacks()` rendered in the flamegraph.pl folded format
    (one "stack count" line per distinct stack) — pipe the output into
    flamegraph.pl / speedscope, or read hot frames straight off the
    counts.  Writes to `filename` when given; returns the text."""
    folded = folded_stacks(samples=samples, interval_s=interval_s,
                           timeout=timeout, cluster=cluster,
                           task_id=task_id)
    text = "\n".join(f"{stack} {count}" for stack, count in
                     sorted(folded.items(),
                            key=lambda kv: (-kv[1], kv[0])))
    if filename:
        with open(filename, "w") as f:
            f.write(text + ("\n" if text else ""))
    return text

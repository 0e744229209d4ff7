"""Serve data plane: the replica actor.

Counterpart of `ray_tpu/serve/_replica.py`; analog of the reference's
ReplicaActor (serve/_private/replica.py:233) + its user-code wrapper
(:800): one actor per replica wrapping the user class; every request
runs through handle_request, which tracks the in-flight count the
pow-2 router probes.  A replica deployed with
`ray_actor_options={"num_gpus": 1}` owns one card: the runtime pins
CUDA_VISIBLE_DEVICES before the user class is built, so an
LLMDeployment's engine lands on it.  With `serve_compiled_pipeline`
on, the router drives `pipeline_step` through a compiled DAG instead
(`pipe_config` names the methods that must not ride it).
"""

from __future__ import annotations

import inspect
import threading
from collections import deque
from typing import Any, List, Optional


# Latency samples older than this never reach the autoscaler: a burst
# hour ago must not veto this minute's scale-down.
_SLO_WINDOW_S = 15.0


def _p95_ms(samples: List[float]) -> Optional[float]:
    """p95 of a list of second-valued samples, in ms (None if empty).
    Shares the runtime's one percentile implementation."""
    from ray_tpu_torch.util.metrics import percentile
    if not samples:
        return None
    return percentile(sorted(samples), 0.95) * 1000.0


class Replica:
    def __init__(self, deployment_name: str, cls_blob: bytes,
                 init_args: tuple, init_kwargs: dict,
                 user_config=None) -> None:
        import cloudpickle
        self._name = deployment_name
        cls = cloudpickle.loads(cls_blob)
        self._user = cls(*init_args, **(init_kwargs or {}))
        self._inflight = 0
        self._served = 0
        # Rolling (timestamp, seconds) request-latency window feeding
        # slo_stats() — for a plain deployment the whole request IS
        # its time-to-first-byte, so this doubles as the TTFT signal
        # the autoscaler consumes (LLM deployments override it with
        # real engine TTFT/ITL samples via the __rtpu_slo_stats__
        # hook).  Samples age out after _SLO_WINDOW_S.
        self._lat_window: deque = deque(maxlen=256)
        # handle_request runs on the actor's event loop while
        # pipeline_step runs on the compiled-graph executor thread:
        # the counters the router/controller probe must not lose
        # updates to interleaved `+=`.
        self._count_lock = threading.Lock()
        # Dedicated event loop for async user methods reached through
        # the compiled pipeline (pipeline_step runs on the DAG
        # executor thread, outside the actor's asyncio loop).
        self._pipe_loop = None
        if user_config is not None:
            self.reconfigure(user_config)

    def _retag_rejection(self, e):
        """Engine-side rejections (the serve/llm.py max_queue
        backstop) carry a placeholder deployment label — the engine
        doesn't know which deployment wraps it.  Re-issue the error
        under THIS deployment's name so shed metrics and 429 bodies
        attribute correctly, counting the shed against the real
        deployment (the engine deliberately does not count)."""
        from ray_tpu_torch.serve._admission import (RequestRejectedError,
                                              _count_shed)
        if not isinstance(e, RequestRejectedError):
            return e
        _count_shed(self._name, e.reason)
        return RequestRejectedError(
            deployment=self._name, reason=e.reason,
            retry_after_s=e.retry_after_s, priority=e.priority,
            tenant_id=e.tenant_id)

    def reconfigure(self, user_config) -> None:
        """Live config push WITHOUT a replica restart (reference:
        user_config + reconfigure(), serve/_private/replica.py) — the
        user class must define reconfigure(cfg)."""
        fn = getattr(self._user, "reconfigure", None)
        if fn is None:
            raise ValueError(
                f"deployment class for {self._name!r} got a "
                f"user_config but defines no reconfigure() method")
        fn(user_config)

    async def handle_request(self, method: str, args: tuple,
                             kwargs: dict,
                             multiplexed_model_id: str = "") -> Any:
        """Run one request on the user instance (async so batched /
        concurrent user methods interleave on the actor's event loop)."""
        import time
        from ray_tpu_torch.serve.multiplex import (_current_model_id,
                                             _set_current_model_id)
        from ray_tpu_torch.util import profiling
        t0 = time.monotonic()
        ok = False
        with self._count_lock:
            self._inflight += 1
        token = _set_current_model_id(multiplexed_model_id)
        try:
            # Child of the execute span the worker opened for this
            # actor call — the replica-side hop of the request trace.
            with profiling.span("replica.handle_request",
                                deployment=self._name, method=method):
                from ray_tpu_torch.serve._admission import \
                    RequestRejectedError
                target = getattr(self._user, method)
                try:
                    out = target(*args, **(kwargs or {}))
                    if inspect.isawaitable(out):
                        out = await out
                except RequestRejectedError as e:
                    raise self._retag_rejection(e) from None
            ok = True
            return out
        finally:
            _current_model_id.reset(token)
            with self._count_lock:
                self._inflight -= 1
                self._served += 1
                if ok:
                    # Successful requests only: fast failures (a
                    # melting-down deployment rejecting in ~1 ms)
                    # must not drag the TTFT p95 the autoscaler
                    # reads toward zero right when it matters.
                    self._lat_window.append(
                        (time.monotonic(), time.monotonic() - t0))

    def pipe_config(self) -> dict:
        """Router probe at pipe-compile time: which methods must NOT
        ride the compiled pipeline.  @serve.batch methods depend on
        CONCURRENT arrivals on the actor's event loop to accumulate a
        batch — the pipe's strictly serial step loop would degrade
        every batch to size 1."""
        skip = [name for name, m
                in inspect.getmembers(type(self._user))
                if getattr(m, "_rtpu_batch_queue_factory", False)]
        return {"skip_methods": skip}

    def pipeline_step(self, request) -> Any:
        """One request step on the compiled serve pipeline
        (serve_compiled_pipeline): the router's handoff writes
        (method, args, kwargs, model_id) into the graph's input
        channel; this method — bound into a per-replica compiled DAG
        and driven by the pinned executor loop — runs it and returns a
        ("ok", value) / ("err", exception) envelope.  The envelope is
        load-bearing: a raised exception would kill the executor loop
        and tear down the whole pipe, so application errors must
        travel as values."""
        import asyncio
        import time
        from ray_tpu_torch.serve.multiplex import (_current_model_id,
                                             _set_current_model_id)
        from ray_tpu_torch.util import profiling
        method, args, kwargs, model_id = request
        t0 = time.monotonic()
        with self._count_lock:
            self._inflight += 1
        token = _set_current_model_id(model_id)
        try:
            with profiling.span("replica.handle_request",
                                deployment=self._name, method=method,
                                compiled=True):
                out = getattr(self._user, method)(*args,
                                                  **(kwargs or {}))
                if inspect.isawaitable(out):
                    if self._pipe_loop is None:
                        self._pipe_loop = asyncio.new_event_loop()
                    out = self._pipe_loop.run_until_complete(out)
            with self._count_lock:
                self._lat_window.append(
                    (time.monotonic(), time.monotonic() - t0))
            return ("ok", out)
        except BaseException as e:  # noqa: BLE001
            return ("err", self._retag_rejection(e))
        finally:
            _current_model_id.reset(token)
            with self._count_lock:
                self._inflight -= 1
                self._served += 1

    def handle_request_stream(self, method: str, args: tuple,
                              kwargs: dict):
        """Streaming request: the user method returns a generator whose
        items are re-yielded through the core streaming-generator plane
        (reference: replica.py streaming ASGI responses ride streaming
        generator actor calls).

        Not a generator itself: the trace context must be captured at
        CALL time (inside the task's activated context) — the inner
        generator's frames run in the consumer's context, where a
        `span()` contextvar set/reset would leak or raise on
        cross-context finalization.  The span is recorded explicitly
        when the drain ends (including abandonment)."""
        import time
        from ray_tpu_torch._private import tracing
        from ray_tpu_torch.util import profiling
        ctx = tracing.current()
        t0 = time.time()
        with self._count_lock:
            self._inflight += 1

        def _stream():
            try:
                out = getattr(self._user, method)(*args,
                                                  **(kwargs or {}))
                yield from out
            except BaseException as e:  # noqa: BLE001
                e2 = self._retag_rejection(e)
                if e2 is e:
                    raise
                raise e2 from None
            finally:
                profiling.record_span(
                    "replica.handle_request", t0, time.time(),
                    trace_ctx=ctx, deployment=self._name,
                    method=method, stream=True)
                with self._count_lock:
                    self._inflight -= 1
                    self._served += 1

        return _stream()

    def check_health(self) -> bool:
        """Controller-probed liveness (reference: replica.py
        check_health + user-defined check_health on the deployment
        class).  A user `check_health` that raises or returns False
        marks the replica unhealthy; absent one, reaching the actor at
        all is the health signal."""
        user_check = getattr(self._user, "check_health", None)
        if user_check is None:
            return True
        out = user_check()
        return True if out is None else bool(out)

    def queue_len(self) -> int:
        """Probed by the pow-2 router (reference: replica queue-length
        probing in pow_2_scheduler.py)."""
        with self._count_lock:
            return self._inflight

    def replica_info(self) -> dict:
        """Router probe: queue length + resident multiplexed models
        (reference: multiplex-aware pow-2 scheduling)."""
        from ray_tpu_torch.serve.multiplex import resident_model_ids
        with self._count_lock:
            qlen = self._inflight
        return {"qlen": qlen,
                "model_ids": resident_model_ids(self._user)}

    def slo_stats(self) -> dict:
        """Controller autoscaler probe: queue depth + the latency SLO
        readings.  Baseline: in-flight count and the rolling request
        latency p95 (a plain deployment's whole-request latency IS
        its TTFT).  A user object exposing `__rtpu_slo_stats__` (the
        LLM engine) overrides with real signals — engine queue depth,
        decode TTFT p95, inter-token latency p95."""
        import time
        cutoff = time.monotonic() - _SLO_WINDOW_S
        with self._count_lock:
            qlen = self._inflight
            lats = [dur for t, dur in self._lat_window if t >= cutoff]
        out = {"qlen": qlen, "ttft_p95_ms": _p95_ms(lats),
               "itl_p95_ms": None}
        hook = getattr(self._user, "__rtpu_slo_stats__", None)
        if hook is not None:
            try:
                engine = hook() or {}
                out.update(engine)
                # Engine-side queued requests are invisible in the
                # actor in-flight count only when callers time out;
                # normally each waiting request also holds an actor
                # slot, so the MAX of the two views is the depth.
                if "queue_depth" in engine:
                    out["qlen"] = max(qlen,
                                      int(engine["queue_depth"]))
            except Exception:
                pass
        return out

    def kv_engine_tags(self) -> list:
        """Controller health-sweep probe: the per-engine metric tags
        this replica's paged-KV engine(s) write their
        ray_tpu_kv_blocks{state} gauges under — cached controller-side
        so an uncleanly killed replica's series can be zeroed."""
        hook = getattr(self._user, "__rtpu_kv_engine_tags__", None)
        if hook is None:
            return []
        try:
            return list(hook() or [])
        except Exception:
            return []

    def stats(self) -> dict:
        with self._count_lock:
            return {"inflight": self._inflight, "served": self._served}

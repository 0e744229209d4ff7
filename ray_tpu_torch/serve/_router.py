"""Serve request router: power-of-two-choices replica scheduling, with
request failover and a per-replica circuit breaker.

Counterpart of `ray_tpu/serve/_router.py`.  With
`serve_compiled_pipeline` on, each replica's requests ride a compiled
DAG of one `pipeline_step` node (`ray_tpu_torch.dag`); a replica whose
pipe cannot be built, a method that must not ride it (`@serve.batch`)
and a request the pipe lost to a replica's death take the task path.
`pipe_stats()` counts both ways.

Analog of the reference's Router (serve/_private/router.py:311) +
PowerOfTwoChoicesReplicaScheduler
(_private/replica_scheduler/pow_2_scheduler.py:52): sample two
replicas, send to the one with the smaller queue.  Queue depth is the
caller-side outstanding count (cheap, no probe RPC on the hot path),
periodically CORRECTED by replica-side queue_len probes so two routers
sharing a deployment converge instead of each believing the replicas
are idle (reference: cached queue-length probing).

Config updates arrive by PUSH: a long-poll thread parks a
`wait_for_update` call on the controller (reference:
serve/_private/long_poll.py:64 LongPollClient) and refreshes the
replica list the moment the version advances — no hot-path polling.

Failover (reference: the router re-scheduling requests whose replica
died before running them): the ref a caller gets back from `assign` is
a RELAY object, not the replica call's own return.  A per-request
waiter bridges the attempt's outcome onto the relay — and when the
attempt dies with a death-type error (ActorDiedError /
WorkerCrashedError / ActorUnavailableError) whose task_started flag
PROVES the request never began executing, it resubmits ONCE on a
different replica first.  The caller never observes the first death;
`get` on the relay blocks until a final outcome lands.  Started — or
possibly-started (task_started unknown) — requests are NOT retried (a
replay could double side effects); their death error bridges through.

Circuit breaker: consecutive request failures sideline a replica
(excluded from pick) until its next successful queue-length probe —
router-local protection for the window before the controller's
replacement propagates.  A sidelined replica receives no traffic, so
request waiters can never discover it died — the PROBE classifies
death errors itself (report + drop) so a replica that is sidelined
and then scaled away or killed is removed instead of probed forever.

Admission control (serve/_admission.py): deployments with an
``admission_config`` get a per-router gate checked BEFORE the replica
pick — token bucket, priority-classed queue-depth caps, per-tenant
weighted fairness.  A shed raises the typed RequestRejectedError from
``assign``/``assign_stream`` synchronously (pure local state, sub-10
ms) instead of parking the request until a timeout.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

# Fallback full-refresh period if the long-poll thread dies (e.g.
# controller restart): keeps handles converging even without pushes.
_FALLBACK_REFRESH_S = 30.0
# Replica queue-length probe period (correct cross-router drift).
_PROBE_INTERVAL_S = 1.0
# Consecutive failures before a replica is sidelined.
_CB_THRESHOLD = 3
# How long a failover retry waits for the controller to backfill a
# replacement when no other replica exists yet.
_FAILOVER_WAIT_S = 15.0


class NoReplicasError(RuntimeError):
    """Deployment has no live replicas (typed so ingress can 404 it
    without string matching)."""


class Router:
    def __init__(self, deployment_name: str) -> None:
        from ray_tpu_torch.serve._admission import AdmissionController
        self._name = deployment_name
        # Admission gate (token bucket / priority / tenant fairness);
        # configured from the controller's pushed admission_config.
        self._gate = AdmissionController(deployment_name)
        self._replicas: List[Any] = []
        self._version = -1
        self._outstanding: Dict[bytes, int] = {}
        # replica-side queue lengths from the last probe (baseline the
        # caller-side delta is applied to).
        self._probed: Dict[bytes, int] = {}
        # replica -> resident multiplexed model ids (last probe)
        self._models: Dict[bytes, list] = {}
        # circuit breaker: consecutive failures + sidelined set
        self._failures: Dict[bytes, int] = {}
        self._sidelined: Dict[bytes, float] = {}
        self._lock = threading.Lock()
        # Compiled serve pipeline (serve_compiled_pipeline): one
        # compiled DAG per replica, requests ride its channels instead
        # of per-call actor tasks.  actor_id -> (CompiledDAG, Lock,
        # skip_methods).  _pipe_failed negative-caches compile
        # failures so a replica whose pipe can't build degrades to the
        # task path without paying probe+compile on every request.
        self._pipes: Dict[bytes, tuple] = {}
        self._pipe_failed: Dict[bytes, float] = {}
        # Pipes of replicas REMOVED from the routing set while their
        # requests are still in flight (graceful scale-down mask):
        # torn down from done() once the replica's outstanding count
        # drains — tearing down under in-flight requests surfaces
        # "DAG was torn down" to users whose replica is alive and
        # merely draining.
        self._retired_pipes: Dict[bytes, tuple] = {}
        self._pipe_counts = {"pipe": 0, "task": 0}
        self._last_refresh = 0.0
        self._last_probe = 0.0
        self._probe_thread = None
        self._poll_thread: Optional[threading.Thread] = None
        # Event (not a bool): the long-poll loop's error backoff waits
        # on it, so close() interrupts the backoff instead of leaving
        # the thread sleeping out a stale second (RT005-class fix).
        self._closed = threading.Event()

    def _controller(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve._controller import CONTROLLER_NAME
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    def _refresh(self, force: bool = False) -> None:
        import ray_tpu_torch
        now = time.time()
        with self._lock:
            fresh = (self._replicas
                     and now - self._last_refresh < _FALLBACK_REFRESH_S)
        if fresh and not force:
            return
        info = ray_tpu_torch.get(
            self._controller().get_replicas.remote(self._name),
            timeout=30)
        self._apply(info)
        self._ensure_poll_thread()

    def _apply(self, info: dict) -> None:
        self._gate.configure(info.get("admission"))
        with self._lock:
            self._replicas = info["replicas"]
            self._version = info["version"]
            self._last_refresh = time.time()
            live = {r._actor_id for r in self._replicas}
            dead_pipes = []
            for k in list(self._pipes):
                if k in live:
                    continue
                ent = self._pipes.pop(k)
                if self._outstanding.get(k, 0) > 0:
                    # Replica masked (draining) with requests still in
                    # flight through its pipe: park it; done() tears
                    # it down when the last request completes.
                    self._retired_pipes[k] = ent
                else:
                    dead_pipes.append(ent)
            self._pipe_failed = {k: v for k, v
                                 in self._pipe_failed.items()
                                 if k in live}
            out = {r._actor_id: self._outstanding.get(r._actor_id, 0)
                   for r in self._replicas}
            for k, n in self._outstanding.items():
                if k not in out and n > 0:
                    # Draining replica's in-flight requests: keep the
                    # count so _total_depth sees them and done() can
                    # detect the drain completing.
                    out[k] = n
            self._outstanding = out
            self._probed = {
                r._actor_id: self._probed.get(r._actor_id, 0)
                for r in self._replicas}
            self._models = {
                r._actor_id: self._models.get(r._actor_id, [])
                for r in self._replicas}
            self._failures = {k: v for k, v in self._failures.items()
                              if k in live}
            self._sidelined = {k: v for k, v in self._sidelined.items()
                               if k in live}
        for ent in dead_pipes:
            self._teardown_pipe_async(ent)

    # -- long-poll push (reference: long_poll.py LongPollClient) --------
    def _ensure_poll_thread(self) -> None:
        if self._poll_thread is not None and self._poll_thread.is_alive():
            return
        t = threading.Thread(target=self._poll_loop, daemon=True,
                             name=f"rtpu-serve-longpoll-{self._name}")
        self._poll_thread = t
        t.start()

    def _poll_loop(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private.client import get_global_client
        client0 = get_global_client()
        while not self._closed.is_set():
            if get_global_client() is not client0:
                return          # session shut down / replaced
            try:
                with self._lock:
                    known = self._version
                info = ray_tpu_torch.get(
                    self._controller().wait_for_update.remote(
                        self._name, known), timeout=70)
                if info is not None:
                    self._apply(info)
            except Exception:
                # Controller restart / timeout: back off, the fallback
                # refresh in pick() keeps correctness.  close() wakes
                # the wait immediately.
                if self._closed.wait(1.0):
                    return

    # -- replica queue-length folding (cross-router correctness) --------
    def _maybe_probe(self) -> None:
        now = time.time()
        with self._lock:
            if (now - self._last_probe < _PROBE_INTERVAL_S
                    or (self._probe_thread is not None
                        and self._probe_thread.is_alive())):
                return        # previous probe still draining slow replicas
            self._last_probe = now
            reps = list(self._replicas)
        if not reps:
            return

        def probe() -> None:
            import ray_tpu_torch
            from ray_tpu_torch import exceptions as exc
            from ray_tpu_torch._private.client import get_global_client
            for r in reps:
                if get_global_client() is None:
                    return      # session shut down mid-probe
                try:
                    info = ray_tpu_torch.get(r.replica_info.remote(),
                                       timeout=5)
                except (exc.ActorDiedError,
                        exc.WorkerCrashedError) as e:
                    # A sidelined replica gets no traffic, so no
                    # request waiter will ever report its death — if
                    # it was killed or scaled away in the meantime
                    # the probe is the only path that can notice.
                    # Without this classification the router probes
                    # it every interval forever, waiting for a
                    # successful probe that can never come.
                    # (ActorUnavailableError = restarting: keep
                    # probing, it will answer when it's back.)
                    self._note_replica_failure(r, e)
                    continue
                except Exception:
                    continue
                with self._lock:
                    if r._actor_id in self._probed:
                        # The replica-side count includes THIS router's
                        # own in-flight requests; subtract them so
                        # probed only carries other callers' load and
                        # _load doesn't double-count ours.
                        ours = self._outstanding.get(r._actor_id, 0)
                        self._probed[r._actor_id] = max(
                            0, int(info["qlen"]) - ours)
                        self._models[r._actor_id] = info["model_ids"]
                # The probe doubles as the router-side health signal:
                # a sidelined replica that answers it rejoins the pool.
                self._record_success(r._actor_id)

        t = threading.Thread(target=probe, daemon=True,
                             name="rtpu-serve-probe")
        with self._lock:
            self._probe_thread = t
        t.start()

    # -- circuit breaker ------------------------------------------------
    def _note_replica_failure(self, replica, err) -> None:
        """THE death-vs-transient classification, shared by the unary
        and stream waiters: every failure circuit-breaks locally;
        only true death errors are reported to the controller.
        ActorUnavailableError means the replica is RESTARTING —
        reporting it would make the controller kill+backfill a
        replica that is already coming back."""
        from ray_tpu_torch import exceptions as exc
        self._record_failure(replica._actor_id)
        if not isinstance(err, exc.ActorUnavailableError):
            self.report_failure(replica)

    def _record_failure(self, actor_id: bytes) -> None:
        with self._lock:
            n = self._failures.get(actor_id, 0) + 1
            self._failures[actor_id] = n
            if n >= _CB_THRESHOLD:
                self._sidelined.setdefault(actor_id, time.time())

    def _record_success(self, actor_id: bytes) -> None:
        with self._lock:
            self._failures.pop(actor_id, None)
            self._sidelined.pop(actor_id, None)

    def _load(self, replica) -> int:
        """Caller holds self._lock (pick's pow-2 comparison)."""
        k = replica._actor_id
        return self._outstanding.get(k, 0) + self._probed.get(k, 0)

    def _total_depth(self) -> int:
        """This router's view of the deployment's total outstanding
        requests (its own in-flight + other routers' probed load) —
        the queue-depth the admission gate judges against."""
        with self._lock:
            return (sum(self._outstanding.values())
                    + sum(self._probed.values()))

    def pick(self, model_id: str = "", exclude=()):
        """Pow-2 choice over caller-side outstanding + probed counts;
        with a multiplexed model id, replicas already holding the
        model win (reference: multiplex-aware pow_2_scheduler).
        Sidelined (circuit-broken) replicas are skipped unless the
        whole pool is sidelined — degraded beats down."""
        self._refresh()
        self._maybe_probe()
        exclude = set(exclude)
        with self._lock:
            reps = self._replicas
            if not reps:
                raise NoReplicasError(
                    f"deployment {self._name!r} has no replicas")
            pool = [r for r in reps if r._actor_id not in exclude]
            if not pool:
                raise NoReplicasError(
                    f"deployment {self._name!r} has no replicas "
                    f"outside the excluded set")
            healthy = [r for r in pool
                       if r._actor_id not in self._sidelined]
            if healthy:
                pool = healthy
            if model_id:
                holders = [r for r in pool if model_id in
                           self._models.get(r._actor_id, ())]
                if holders:
                    pool = holders
            if len(pool) == 1:
                choice = pool[0]
            else:
                a, b = random.sample(pool, 2)
                choice = a if self._load(a) <= self._load(b) else b
            self._outstanding[choice._actor_id] = \
                self._outstanding.get(choice._actor_id, 0) + 1
            return choice

    def done(self, replica) -> None:
        ent = None
        with self._lock:
            k = replica._actor_id
            if self._outstanding.get(k, 0) > 0:
                self._outstanding[k] -= 1
            if self._outstanding.get(k, 0) == 0 \
                    and all(r._actor_id != k for r in self._replicas):
                # A retired (masked/draining) replica just drained its
                # last in-flight request: drop the bookkeeping and
                # tear its parked pipe down now that nothing rides it.
                self._outstanding.pop(k, None)
                ent = self._retired_pipes.pop(k, None)
        if ent is not None:
            self._teardown_pipe_async(ent)

    # -- compiled serve pipeline (serve_compiled_pipeline) --------------
    @staticmethod
    def _compiled_enabled() -> bool:
        from ray_tpu_torch._private.config import config
        return bool(config.serve_compiled_pipeline)

    def _try_pipe(self, replica):
        """Get (or compile) the replica's request pipe as
        (CompiledDAG, Lock, skip_methods); None on any compile failure
        — the caller degrades to the task path."""
        import ray_tpu_torch
        k = replica._actor_id
        with self._lock:
            ent = self._pipes.get(k)
            if ent is None and \
                    time.time() - self._pipe_failed.get(k, 0.0) < 30.0:
                return None     # recent compile failure: task path
        if ent is not None:
            return ent
        try:
            skip = set(ray_tpu_torch.get(replica.pipe_config.remote(),
                                   timeout=30)["skip_methods"])
            # Importing ray_tpu_torch.dag activates .bind on actor methods.
            from ray_tpu_torch.dag import InputNode
            with InputNode() as inp:
                out = replica.pipeline_step.bind(inp)
            dag = out.experimental_compile(capacity=16)
        except Exception:
            with self._lock:
                self._pipe_failed[k] = time.time()
            return None
        ent = (dag, threading.Lock(), skip)
        with self._lock:
            self._pipe_failed.pop(k, None)
            cur = self._pipes.get(k)
            if cur is None and k in self._outstanding:
                self._pipes[k] = ent
                return ent
        # Lost the race (or the replica vanished mid-compile).
        self._teardown_pipe_async(ent)
        return cur

    def _count_route(self, piped: bool, moved: bool = False) -> None:
        """Count a request with the switch on: into the pipe, or down
        the task path (`moved`: out of the pipe onto the task path)."""
        with self._lock:
            if moved:
                self._pipe_counts["pipe"] -= 1
            self._pipe_counts["pipe" if piped else "task"] += 1

    def pipe_stats(self) -> Dict[str, int]:
        """With `serve_compiled_pipeline` on: requests sent through a
        replica's pipe, and requests sent down the task path instead
        (a pipe that failed to build, a skipped method, a retry after
        a replica's death)."""
        with self._lock:
            return dict(self._pipe_counts)

    def _drop_pipe(self, actor_id: bytes) -> None:
        with self._lock:
            ent = (self._pipes.pop(actor_id, None)
                   or self._retired_pipes.pop(actor_id, None))
        if ent is not None:
            self._teardown_pipe_async(ent)

    @staticmethod
    def _teardown_pipe_async(ent) -> None:
        """Teardown waits for the executor loop to exit — never on the
        request path."""
        threading.Thread(target=ent[0].teardown, daemon=True,
                         name="rtpu-serve-pipe-td").start()

    def _watch_pipe(self, relay_ref, dag_ref, replica, method: str,
                    args: tuple, kwargs: dict, model_id: str,
                    release=None) -> None:
        """Compiled-path waiter: read the pipe's ("ok"|"err", value)
        envelope and bridge it onto the relay.  The graph itself is
        at-most-once; requests it LOSES on a replica death (envelope
        neither returned nor salvaged from the out ring) retry once
        through the ordinary task path on another replica — the same
        replay window actor max_task_retries accepts.  Either way the
        pipe is dropped, so later requests compile a fresh one on the
        controller's replacement replica.  `release` (the admission
        slot) fires when the request reaches a terminal outcome here,
        or is FORWARDED to the task-path waiter on failover."""
        relay = relay_ref.binary()

        def waiter() -> None:
            from ray_tpu_torch import exceptions as exc
            _pin = relay_ref     # hold until the bridge lands
            delegated = False
            try:
                try:
                    # No deadline: one slow request must not tear down
                    # the SHARED pipe (a TimeoutError here would close
                    # the channels under up-to-capacity unrelated
                    # in-flight requests).  Matches the task path's
                    # indefinite wait; a dead replica still surfaces
                    # via the loop-death check inside get().
                    status, value = dag_ref.get()
                except BaseException as e:  # noqa: BLE001
                    self.done(replica)
                    self._drop_pipe(replica._actor_id)
                    death = isinstance(e, (exc.ActorDiedError,
                                           exc.WorkerCrashedError,
                                           exc.ActorUnavailableError))
                    if death:
                        self._note_replica_failure(replica, e)
                        failed = (set()
                                  if isinstance(
                                      e, exc.ActorUnavailableError)
                                  else {replica._actor_id})
                        nxt = self._pick_for_failover(failed, model_id)
                        if nxt is not None:
                            self._count_failover()
                            self._count_route(False, moved=True)
                            try:
                                ref2 = nxt.handle_request.remote(
                                    method, args, kwargs, model_id)
                            except Exception:
                                self.done(nxt)
                                self._bridge(relay, e, as_error=True)
                                return
                            # Hand the second attempt to the ordinary
                            # waiter (it owns bridge + one more
                            # failover — and the admission slot).
                            self._watch(relay_ref, ref2, nxt, method,
                                        args, kwargs, model_id,
                                        release)
                            delegated = True
                            return
                    self._bridge(relay, e, as_error=True)
                    return
                self.done(replica)
                if status == "ok":
                    self._record_success(replica._actor_id)
                self._bridge(relay, value, as_error=(status != "ok"))
            finally:
                if release is not None and not delegated:
                    release()

        threading.Thread(target=waiter, daemon=True,
                         name="rtpu-serve-pipe").start()

    # -- request assignment + failover ----------------------------------
    def assign(self, method: str, args: tuple, kwargs: dict,
               model_id: str = "", priority: str = "normal",
               tenant_id: str = ""):
        """Submit one request; returns (ObjectRef, replica).  The ref
        is a RELAY object: the per-request waiter bridges the replica
        call's outcome onto it, retrying an un-started request once on
        a different replica when the first assignment dies.  The span
        covers replica choice + submission, and the actor-call spec
        inherits its trace context — the cross-process link between
        the proxy's root span and the replica's execute span.

        Admission runs FIRST, against purely local state: an
        overloaded deployment sheds here with a typed
        RequestRejectedError in microseconds instead of parking the
        request behind a saturated queue."""
        from ray_tpu_torch._private.chaos import chaos
        from ray_tpu_torch.object_ref import ObjectRef
        from ray_tpu_torch.util import profiling
        release = self._gate.acquire(priority, tenant_id,
                                     self._total_depth())
        try:
            with profiling.span("router.assign", deployment=self._name,
                                method=method):
                relay = os.urandom(16)
                # ONE shared ObjectRef instance for the caller AND the
                # waiter closure: its GC-time remove_ref must fire after
                # BOTH are done with it.  A caller-only ref dropped
                # before the bridge would decref a not-yet-existing
                # entry (no-op) and the bridged response would then be
                # pinned node-side forever.
                relay_ref = ObjectRef(relay, owned=True)
                replica = self.pick(model_id)
                self._maybe_chaos_kill(chaos, replica)
                if self._compiled_enabled():
                    ent = self._try_pipe(replica)
                    self._count_route(ent is not None
                                      and method not in ent[2])
                    if ent is not None and method not in ent[2]:
                        dag, plock, _ = ent
                        dag_ref = None
                        try:
                            with plock:
                                # Router handoff: the request goes
                                # straight into the graph's input
                                # channel — no scheduled task on the
                                # hot path.
                                dag_ref = dag.execute(
                                    (method, args, kwargs, model_id))
                        except BaseException:  # noqa: BLE001
                            # Pipe broken before the request entered
                            # the graph: safe to fall through to the
                            # task path.
                            self._drop_pipe(replica._actor_id)
                            self._count_route(False, moved=True)
                        if dag_ref is not None:
                            self._watch_pipe(relay_ref, dag_ref,
                                             replica, method, args,
                                             kwargs, model_id, release)
                            return relay_ref, replica
                ref = replica.handle_request.remote(method, args,
                                                    kwargs, model_id)
        except BaseException:
            release()   # admitted but never submitted: free the slot
            raise
        self._watch(relay_ref, ref, replica, method, args, kwargs,
                    model_id, release)
        return relay_ref, replica

    @staticmethod
    def _maybe_chaos_kill(chaos, replica) -> None:
        """Chaos kind=kill_replica at site 'serve.assign': kill the
        replica the router just picked, so the request lands on a dead
        actor and must fail over."""
        if not chaos.fire("serve.assign", "kill_replica"):
            return
        try:
            import ray_tpu_torch
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def _watch(self, relay_ref, ref, replica, method: str,
               args: tuple, kwargs: dict, model_id: str,
               release=None) -> None:
        """Per-request waiter thread: awaits the attempt, retries an
        un-started request once on another replica, and bridges the
        final outcome (value or error) onto the relay object.  One
        short-lived thread per request — same cost shape as the old
        done-callback waiter, now also carrying the failover.  The
        closure's hold on `relay_ref` keeps the relay's GC decref
        ordered after the bridge (see assign).  `release` frees the
        request's admission slot once the outcome is terminal (every
        path below bridges or returns a final result before the
        waiter exits, so the finally covers them all)."""
        relay = relay_ref.binary()

        def waiter() -> None:
            _pin = relay_ref     # hold until the bridge lands
            try:
                self._watch_attempts(relay, ref, replica, method, args,
                                     kwargs, model_id)
            finally:
                if release is not None:
                    release()

        threading.Thread(target=waiter, daemon=True,
                         name="rtpu-serve-request").start()

    def _watch_attempts(self, relay: bytes, ref, replica, method: str,
                        args: tuple, kwargs: dict,
                        model_id: str) -> None:
        """The waiter body: up to two attempts, then bridge."""
        import ray_tpu_torch
        from ray_tpu_torch import exceptions as exc
        from ray_tpu_torch._private.client import get_global_client
        attempt_ref, attempt_replica = ref, replica
        failed_ids: set = set()
        for attempt in range(2):
            try:
                ray_tpu_torch.wait([attempt_ref], timeout=None)
                # Fast path: alias the completed inline outcome
                # onto the relay NODE-SIDE — the response payload
                # never re-enters this process (no deserialize +
                # reserialize on the serving hot path).  A failure
                # of this control rpc must NOT become the
                # request's outcome: the result is sitting READY
                # in the store — fall through and read it.
                rep = {}
                try:
                    client = get_global_client()
                    if client is not None:
                        rep = client.conn.call(
                            {"type": "relay_result",
                             "src": attempt_ref.binary(),
                             "dst": relay})
                except Exception:
                    rep = {}
                if rep.get("done"):
                    self.done(attempt_replica)
                    self._record_success(attempt_replica._actor_id)
                    return
                # Error outcome (classify below) or shm-sized
                # value (bridge by value — rare for serve).
                value = ray_tpu_torch.get(attempt_ref)
            except (exc.ActorDiedError, exc.WorkerCrashedError,
                    exc.ActorUnavailableError) as e:
                self.done(attempt_replica)
                self._note_replica_failure(attempt_replica, e)
                if not isinstance(e, exc.ActorUnavailableError):
                    # A restarting (unavailable) replica keeps its
                    # actor id and is NOT excluded from the retry
                    # pick: the resubmission queues on it and runs
                    # once it's back.  Dead replicas are excluded.
                    failed_ids.add(attempt_replica._actor_id)
                # Retry ONLY a provably un-started request
                # (task_started is False).  None means unknown —
                # e.g. a node-death ActorDiedError where the
                # request may have been mid-execution with side
                # effects already emitted; re-running it could
                # double them.
                started = getattr(e, "task_started", None)
                if attempt == 0 and started is False:
                    nxt = self._pick_for_failover(failed_ids,
                                                  model_id)
                    if nxt is not None:
                        self._count_failover()
                        try:
                            attempt_ref = \
                                nxt.handle_request.remote(
                                    method, args, kwargs,
                                    model_id)
                        except Exception:
                            # Resubmit itself failed (replica torn
                            # down in the window): the relay MUST
                            # still resolve.
                            self.done(nxt)
                            self._bridge(relay, e, as_error=True)
                            return
                        attempt_replica = nxt
                        continue
                self._bridge(relay, e, as_error=True)
                return
            except BaseException as e:  # noqa: BLE001
                # Application error (or shutdown): no failover —
                # surface it to the caller unchanged.
                self.done(attempt_replica)
                self._bridge(relay, e, as_error=True)
                return
            else:
                self.done(attempt_replica)
                self._record_success(attempt_replica._actor_id)
                self._bridge(relay, value, as_error=False)
                return

    def _pick_for_failover(self, exclude: set, model_id: str):
        """Pick a retry replica, waiting briefly for the controller to
        backfill when the dead one was the only replica."""
        deadline = time.time() + _FAILOVER_WAIT_S
        while time.time() < deadline and not self._closed.is_set():
            try:
                return self.pick(model_id, exclude=exclude)
            except NoReplicasError:
                pass
            except Exception:
                return None
            try:
                self._refresh(force=True)
            except Exception:
                pass
            if self._closed.wait(0.2):
                return None
        return None

    @staticmethod
    def _count_failover() -> None:
        try:
            from ray_tpu_torch.util.metrics import (TASK_RETRIES_METRIC,
                                              shared_counter)
            shared_counter(
                TASK_RETRIES_METRIC,
                description="task retries, by failure reason",
                tag_keys=("reason",)).inc(
                    tags={"reason": "serve_failover"})
        except Exception:
            pass

    def _bridge(self, relay: bytes, outcome, as_error: bool) -> None:
        """Publish the final outcome under the relay object id.  The
        relay MUST resolve or its reader hangs forever: a failed value
        publish (store full, unserializable response) degrades to
        publishing that failure as the relay's error instead."""
        from ray_tpu_torch._private.client import get_global_client
        client = get_global_client()
        if client is None:
            return      # session gone: nobody is left to read the relay
        try:
            client.put_with_id(relay, outcome, as_error=as_error)
            return
        except Exception as publish_err:
            if as_error:
                return  # error publish failed: connection is gone
            fallback = publish_err
        try:
            client.put_with_id(relay, fallback, as_error=True)
        except Exception:
            pass

    def assign_stream(self, method: str, args: tuple, kwargs: dict,
                      priority: str = "normal", tenant_id: str = ""):
        """Submit one STREAMING request; returns (ObjectRefGenerator,
        replica, release).  Items ride the core streaming-generator
        plane (reference: streaming replica calls, proxy.py:779).  No
        failover: a partially-consumed stream must not replay.
        `release` is the admission slot — the stream's done-callback
        must call it when the drain completes."""
        from ray_tpu_torch.util import profiling
        release = self._gate.acquire(priority, tenant_id,
                                     self._total_depth())
        try:
            with profiling.span("router.assign", deployment=self._name,
                                method=method, stream=True):
                replica = self.pick()
                gen = replica.handle_request_stream.options(
                    num_returns="streaming").remote(method, args,
                                                    kwargs)
        except BaseException:
            release()
            raise
        return gen, replica, release

    def report_failure(self, replica) -> None:
        """A request errored with a dead replica: tell the controller,
        drop local state, force a refresh."""
        import ray_tpu_torch
        try:
            ray_tpu_torch.get(self._controller().report_replica_failure.remote(
                self._name, replica._actor_id), timeout=30)
        except Exception:
            pass
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r._actor_id != replica._actor_id]
        try:
            self._refresh(force=True)
        except Exception:
            pass

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            pipes = (list(self._pipes.values())
                     + list(self._retired_pipes.values()))
            self._pipes.clear()
            self._retired_pipes.clear()
        for ent in pipes:
            self._teardown_pipe_async(ent)

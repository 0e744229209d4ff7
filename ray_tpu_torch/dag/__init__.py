"""Compiled graphs (aDAG): pre-wired actor pipelines over channels.

The port's copy of `ray_tpu/dag/__init__.py`, over the port's
`experimental/channel.py` and `experimental/dag_executor.py`.

Reference surface: python/ray/dag/ — InputNode/MultiOutputNode
(input_node.py, output_node.py), `.bind` on actor methods
(class_node.py), `experimental_compile` → CompiledDAG
(compiled_dag_node.py:549) executing via shared-memory channels instead
of per-call task RPCs, and CollectiveOutputNode
(dag/collective_node.py:134) for in-DAG allreduce.

Why it matters: a decode step or pipeline stage dispatched through
the normal task path pays ms-scale scheduling; a compiled DAG
pays one shm ring-buffer hop (µs) locally, or one bounded node-queue
hop across hosts.  Usage:

    with InputNode() as inp:
        x = preproc.step.bind(inp)
        y = model.infer.bind(x)
    dag = y.experimental_compile()
    out = dag.execute(batch).get()
    dag.teardown()

Compilation groups nodes by actor (one long-lived loop task per actor,
dispatched once and pinned to its own executor thread, ops in
topological order; same-actor edges stay in-process), allocates one
transport per cross-process edge — an mmap SPSC ring when both
endpoints live on the submitting node, a bounded node queue fed by a
PERSISTENT streamed edge on the binary transfer plane when they don't
(the cross-host path: one socket write + ack per item; reference:
experimental/channel/shared_memory_channel.py vs the NCCL channels) —
and returns a CompiledDAG whose `execute` writes the driver→graph
edges and returns a ref that reads the graph→driver edges.  Pipelined:
up to `capacity` executes may be in flight before the first `get`;
beyond that, execute() blocks on ring backpressure.  At-most-once: an
actor death mid-graph tears the graph down (completed rows salvaged,
lost rows surface ActorDiedError); retries belong to the caller."""

from __future__ import annotations

import atexit
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed

__all__ = ["InputNode", "MultiOutputNode", "CompiledDAG",
           "CompiledDAGRef", "DAGNode", "CollectiveOutputNode",
           "allreduce_bind"]

# Every live CompiledDAG, for the driver-exit sweep: an abnormal exit
# (exception past the user's teardown, SIGTERM-atexit, shutdown())
# must still unlink the /dev/shm-backed channel files — they are not
# session-scoped temp files the OS cleans up.
_live_dags: "weakref.WeakSet" = weakref.WeakSet()


def _teardown_all() -> None:
    """Tear down (and unlink the channel files of) every DAG still
    live — called from ray_tpu_torch.shutdown() and at interpreter exit."""
    for dag in list(_live_dags):
        try:
            dag.teardown()
        except Exception:
            pass


atexit.register(_teardown_all)


class DAGNode:
    def experimental_compile(self, capacity: int = 8,
                             buffer_size_bytes: int = 1 << 20
                             ) -> "CompiledDAG":
        return CompiledDAG(self, capacity, buffer_size_bytes)


class InputNode(DAGNode):
    """The placeholder for `execute()`'s argument (input_node.py)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *a) -> None:
        pass


class ClassMethodNode(DAGNode):
    def __init__(self, handle, method_name: str, args: tuple,
                 kwargs: dict) -> None:
        self.handle = handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def __repr__(self) -> str:
        return (f"{self.handle._class_name}.{self.method_name}"
                f".bind(...)")


class _CollectiveGroup:
    def __init__(self, nodes: List[ClassMethodNode], op: str) -> None:
        self.nodes = list(nodes)
        self.op = op


class CollectiveOutputNode(DAGNode):
    """Per-rank output of an in-DAG collective
    (dag/collective_node.py:134).  Belongs to the same actor as its
    source node; downstream ops on that actor consume the reduced
    value."""

    def __init__(self, src: ClassMethodNode,
                 group: _CollectiveGroup) -> None:
        self.src = src
        self.group = group

    @property
    def handle(self):
        return self.src.handle


def allreduce_bind(nodes: List[DAGNode],
                   op: str = "sum") -> List[CollectiveOutputNode]:
    """Bind an allreduce across one node per participating actor
    (reference: ray.dag.collective_node — `collective.allreduce.bind`).
    Returns one CollectiveOutputNode per input, in rank order."""
    if not nodes:
        raise ValueError("allreduce_bind needs at least one node")
    for n in nodes:
        if not isinstance(n, ClassMethodNode):
            raise TypeError("allreduce_bind takes actor-method nodes, "
                            f"got {n!r}")
    from ray_tpu_torch.util.collective import _REDUCERS
    if op not in _REDUCERS:
        raise ValueError(f"unknown reduce op {op!r} "
                         f"(have {sorted(_REDUCERS)})")
    group = _CollectiveGroup(nodes, op)
    members = [CollectiveOutputNode(n, group) for n in nodes]
    group._members = members
    return members


class MultiOutputNode(DAGNode):
    """Terminal fan-in: execute() refs resolve to a list
    (output_node.py)."""

    def __init__(self, outputs: List[DAGNode]) -> None:
        self.outputs = list(outputs)


def _topo(root: DAGNode) -> List[DAGNode]:
    order: List[DAGNode] = []
    seen: set = set()

    def visit(n) -> None:
        if id(n) in seen:
            return
        if isinstance(n, CollectiveOutputNode):
            # The whole collective group enters the schedule together:
            # every rank's source is scheduled before any rank's
            # collective op, and every member op is scheduled even when
            # only some members are consumed downstream — otherwise the
            # scheduled ranks would block forever waiting for peers.
            members = getattr(n.group, "_members", [n])
            for peer in members:
                seen.add(id(peer))
            for peer_src in n.group.nodes:
                visit(peer_src)
            order.extend(members)
            return
        if not isinstance(n, ClassMethodNode):
            return
        seen.add(id(n))
        for a in list(n.args) + list(n.kwargs.values()):
            visit(a)
        order.append(n)

    if isinstance(root, MultiOutputNode):
        for o in root.outputs:
            visit(o)
    else:
        visit(root)
    return order


class CompiledDAGRef:
    def __init__(self, dag: "CompiledDAG", seq: int) -> None:
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None):
        return self._dag._read_result(self._seq, timeout)


class CompiledDAG:
    def __init__(self, root: DAGNode, capacity: int,
                 slot_size: int) -> None:
        nodes = _topo(root)
        if not any(isinstance(n, ClassMethodNode) for n in nodes):
            raise ValueError("compiled DAG needs at least one "
                             "actor-method node")
        self._root = root
        client = ray_tpu_torch._ensure_connected()
        self._client = client
        self._chan_dir = os.path.join(client.session_dir, "channels")
        os.makedirs(self._chan_dir, exist_ok=True)
        self._dag_id = os.urandom(4).hex()
        self._capacity = capacity
        self._edge_n = 0
        self._channels: List[Channel] = []
        # driver-side input edges: ("mmap", Channel) | ("rchan", key, dst)
        self._in_edges: List[tuple] = []
        # (key, resident_node) of every rchan queue, for teardown
        self._rchans: List[Tuple[bytes, bytes]] = []
        self._torn_down = False
        self._td_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._loop_refs: List[Any] = []

        ninfo = client.node_info()
        drv_node: bytes = ninfo["node_id"]
        self._drv_node = drv_node
        node_of_actor: Dict[bytes, bytes] = {}

        def actor_node(aid: bytes) -> bytes:
            nid = node_of_actor.get(aid)
            if nid is None:
                nid = client.actor_node(aid)
                node_of_actor[aid] = nid
            return nid

        # node -> where its output lives, per consumer kind
        out_slots: Dict[int, List[tuple]] = {id(n): [] for n in nodes}

        def new_mmap() -> Tuple[str, Channel]:
            self._edge_n += 1
            path = os.path.join(
                self._chan_dir, f"dag-{self._dag_id}-e{self._edge_n}")
            ch = Channel(path, capacity=capacity, slot_size=slot_size,
                         create=True)
            self._channels.append(ch)
            return path, ch

        def new_rchan(resident: bytes) -> bytes:
            self._edge_n += 1
            key = f"dag-{self._dag_id}-e{self._edge_n}".encode()
            self._rchans.append((key, resident))
            return key

        actor_of = {id(n): n.handle._actor_id for n in nodes}
        local_n = 0

        def local_slot(producer) -> tuple:
            nonlocal local_n
            for kind, *rest in out_slots[id(producer)]:
                if kind == "local":
                    return ("local", rest[0])
            local_n += 1
            key = f"v{local_n}"
            out_slots[id(producer)].append(("local", key))
            return ("local", key)

        def slot_for_arg(consumer, arg) -> tuple:
            cons_node = actor_node(actor_of[id(consumer)])
            if isinstance(arg, InputNode):
                if cons_node == drv_node:
                    path, ch = new_mmap()
                    self._in_edges.append(("mmap", ch))
                    return ("chan", path)
                key = new_rchan(cons_node)
                self._in_edges.append(("rchan", key, cons_node))
                return ("rchan_in", key)
            if isinstance(arg, (ClassMethodNode, CollectiveOutputNode)):
                if actor_of[id(arg)] == actor_of[id(consumer)]:
                    return local_slot(arg)
                prod_node = actor_node(actor_of[id(arg)])
                if prod_node == drv_node and cons_node == drv_node:
                    path, _ = new_mmap()
                    out_slots[id(arg)].append(("chan", path))
                    return ("chan", path)
                key = new_rchan(cons_node)
                out_slots[id(arg)].append(
                    ("rchan_out", key, cons_node.hex()))
                return ("rchan_in", key)
            if isinstance(arg, MultiOutputNode):
                raise TypeError("MultiOutputNode can only be the root")
            return ("const", arg)

        # assign collective channel keys per group
        coll_keys: Dict[int, bytes] = {}
        coll_n = 0

        def coll_spec(n: CollectiveOutputNode) -> dict:
            nonlocal coll_n
            g = n.group
            key = coll_keys.get(id(g))
            ranks = [actor_node(m.handle._actor_id).hex()
                     for m in g.nodes]
            if key is None:
                coll_n += 1
                key = f"dag-{self._dag_id}-c{coll_n}".encode()
                coll_keys[id(g)] = key
                root_node = bytes.fromhex(ranks[0])
                world = len(g.nodes)
                # root's per-rank in-queues + each rank's out-queue
                for r in range(1, world):
                    self._rchans.append((key + b"/in/%d" % r,
                                         root_node))
                    self._rchans.append(
                        (key + b"/out/%d" % r,
                         bytes.fromhex(ranks[r])))
            rank = next(i for i, m in enumerate(g.nodes)
                        if m is n.src)
            return {"op": g.op, "key": key, "rank": rank,
                    "world": len(g.nodes), "nodes": ranks}

        ops_by_actor: Dict[bytes, List[dict]] = {}
        handles: Dict[bytes, Any] = {}
        for n in nodes:
            aid = n.handle._actor_id
            handles[aid] = n.handle
            if isinstance(n, CollectiveOutputNode):
                ops_by_actor.setdefault(aid, []).append(
                    {"collective": coll_spec(n),
                     "ins": [slot_for_arg(n, n.src)],
                     "kwargs": {},
                     "outs": out_slots[id(n)]})
                continue
            ins = [slot_for_arg(n, a) for a in n.args]
            kw = {k: slot_for_arg(n, v) for k, v in n.kwargs.items()}
            ops_by_actor.setdefault(aid, []).append(
                {"method": n.method_name, "ins": ins, "kwargs": kw,
                 "outs": out_slots[id(n)]})

        # terminal outputs -> driver edges
        terminals = (root.outputs if isinstance(root, MultiOutputNode)
                     else [root])
        self._out_edges: List[tuple] = []
        for t in terminals:
            if not isinstance(t, (ClassMethodNode, CollectiveOutputNode)):
                raise TypeError(f"DAG output must be an actor-method "
                                f"node, got {t!r}")
            t_node = actor_node(actor_of[id(t)])
            if t_node == drv_node:
                path, ch = new_mmap()
                out_slots[id(t)].append(("chan", path))
                self._out_edges.append(("mmap", ch))
            else:
                key = new_rchan(drv_node)
                out_slots[id(t)].append(
                    ("rchan_out", key, drv_node.hex()))
                self._out_edges.append(("rchan", key))

        # launch one loop per actor (ops in topo order).  The loop is
        # dispatched ONCE here at compile time; worker_main pins it to
        # a dedicated executor thread so the actor keeps answering
        # normal calls (health probes, queue_len) while the graph runs.
        self._loop_refs = []
        for aid, ops in ops_by_actor.items():
            h = handles[aid]
            refs = client.submit_actor_task(
                aid, h._class_id, "__rtpu_dag_loop__", (ops,), {}, 1)
            self._loop_refs.append(refs[0])

        self._exec_seq = 0
        self._read_seq = 0
        self._buffer: Dict[int, Any] = {}
        self._partial: List[Any] = []
        # Separate locks: execute() must stay non-blocking while a
        # get() holds the read lock waiting on results (pipelining).
        self._exec_lock = threading.Lock()
        self._read_lock = threading.Lock()
        # seq -> (wall start, trace ctx) for the dag.execute lifecycle
        # span recorded when the row's results land.
        self._exec_meta: Dict[int, tuple] = {}
        self._last_span_ts = 0.0
        from ray_tpu_torch.util.metrics import (DAG_EXECUTIONS_METRIC,
                                          DAG_HOP_BUCKETS,
                                          DAG_HOP_SECONDS_METRIC,
                                          shared_counter,
                                          shared_histogram)
        self._m_execs = shared_counter(
            DAG_EXECUTIONS_METRIC,
            description="compiled-DAG executions submitted")
        self._observe_hop = shared_histogram(
            DAG_HOP_SECONDS_METRIC,
            description="compiled-DAG per-edge hop duration",
            boundaries=DAG_HOP_BUCKETS,
            tag_keys=("edge",)).observer({"edge": "local"})
        _live_dags.add(self)

    # -- execution -----------------------------------------------------
    def execute(self, *args) -> CompiledDAGRef:
        self._check_usable()
        value = args[0] if len(args) == 1 else tuple(args)
        from ray_tpu_torch._private import tracing
        with self._exec_lock:
            # Edge writes are ordered under the lock: the input rings
            # are SPSC, so two racing execute() calls must not
            # interleave their slot writes.
            try:
                for edge in self._in_edges:
                    if edge[0] == "mmap":
                        t0 = time.perf_counter()
                        edge[1].write(value)
                        self._observe_hop(time.perf_counter() - t0)
                    else:
                        self._client.chan_send(edge[2], edge[1], value,
                                               cap=self._capacity)
            except ChannelClosed:
                self._check_usable()
                raise
            seq = self._exec_seq
            self._exec_seq += 1
            self._exec_meta[seq] = (time.time(), tracing.current())
        self._m_execs.inc()
        return CompiledDAGRef(self, seq)

    def _check_usable(self) -> None:
        if self._error is not None:
            raise self._error
        if self._torn_down:
            raise RuntimeError("DAG was torn down")

    def _check_loops(self) -> None:
        """Surface a dead loop task (a user-method exception, an actor
        death, a chaos-killed worker) as an error on the caller — and
        tear the graph down cleanly — instead of an indefinite hang."""
        if self._torn_down:
            return
        done, _ = ray_tpu_torch.wait(self._loop_refs,
                               num_returns=len(self._loop_refs),
                               timeout=0)
        if not done or self._torn_down:
            return
        try:
            ray_tpu_torch.get(done)   # raises the loop's error if it failed
            err: BaseException = RuntimeError(
                "compiled DAG loop task(s) exited mid-run")
        except BaseException as e:  # noqa: BLE001
            err = e
        # Rows that fully completed before the death are still sitting
        # in the driver-side out rings — salvage them so their refs
        # resolve to values, not to the death error (the serve pipe's
        # retry logic keys off "salvaged vs lost").  Caller holds the
        # read lock.
        try:
            while True:
                out = self._partial
                while len(out) < len(self._out_edges):
                    out.append(self._read_edge_once(
                        self._out_edges[len(out)]))
                self._partial = []
                self._buffer[self._read_seq] = (
                    out if isinstance(self._root, MultiOutputNode)
                    else out[0])
                self._record_execute_span(self._read_seq)
                self._read_seq += 1
        except Exception:
            pass        # half-written rows stay lost (at-most-once)
        if self._error is None:
            self._error = err
        # At-most-once contract: a mid-graph death invalidates every
        # outstanding execute (in-flight rows may be half-processed) —
        # tear down now so all readers fail fast, not at timeout.
        self.teardown()
        raise err

    def _read_edge_once(self, edge: tuple) -> Any:
        """Single near-non-blocking edge read (salvage path only)."""
        if edge[0] == "mmap":
            return edge[1].read(timeout=0.05)
        return self._client.chan_recv(edge[1], timeout=0.05)

    def _read_edge(self, edge: tuple,
                   deadline: Optional[float]) -> Any:
        while True:
            step = 0.2
            if deadline is not None:
                step = min(step, max(0.001, deadline - time.monotonic()))
            try:
                if edge[0] == "mmap":
                    return edge[1].read(timeout=step)
                return self._client.chan_recv(edge[1], timeout=step)
            except ChannelClosed:
                self._check_usable()
                raise RuntimeError("DAG was torn down")
            except TimeoutError:
                self._check_loops()
                if (deadline is not None
                        and time.monotonic() > deadline):
                    raise

    def _read_result(self, seq: int, timeout: Optional[float]):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._read_lock:
            if self._read_seq > seq:
                return self._pop_buffered(seq)
            self._check_usable()
            while self._read_seq <= seq:
                try:
                    # Edge reads CONSUME; keep partial progress in
                    # self._partial so a get() that times out mid-row
                    # can be retried without pairing edge 0's next row
                    # with edge 1's current one.
                    out = self._partial
                    while len(out) < len(self._out_edges):
                        out.append(self._read_edge(
                            self._out_edges[len(out)], deadline))
                    self._partial = []
                    self._buffer[self._read_seq] = (
                        out if isinstance(self._root, MultiOutputNode)
                        else out[0])
                    self._record_execute_span(self._read_seq)
                    self._read_seq += 1
                except TimeoutError:
                    raise
                except BaseException:
                    if self._read_seq > seq:
                        break   # this row was salvaged before the death
                    raise
            return self._pop_buffered(seq)

    def _pop_buffered(self, seq: int):
        if seq not in self._buffer:
            raise RuntimeError(
                f"compiled DAG result {seq} was already consumed")
        return self._buffer.pop(seq)

    def _record_execute_span(self, seq: int) -> None:
        """dag.execute lifecycle span (execute() -> results read),
        carrying the submitter's trace_ctx so compiled executions
        appear in profiling.timeline() like task executions do.
        Traced executions (a request span is active — the serve
        pipeline) always emit; untraced ones are rate-limited to ~50/s
        per DAG — at µs-scale execution rates a per-item notify would
        both flood the event ring and dominate the hop budget
        (measured: ~300 µs/item of socket backpressure)."""
        meta = self._exec_meta.pop(seq, None)
        if meta is None:
            return
        t0, ctx = meta
        if ctx is None:
            now = time.monotonic()
            if now - self._last_span_ts < 0.02:
                return
            self._last_span_ts = now
        try:
            from ray_tpu_torch.util import profiling
            profiling.record_span("dag.execute", t0, time.time(),
                                  trace_ctx=ctx,
                                  dag_id=self._dag_id, seq=seq)
        except Exception:
            pass

    # -- teardown ------------------------------------------------------
    def teardown(self) -> None:
        """Idempotent (and thread-safe) teardown: close + UNLINK every
        mmap channel file this driver owns, close the cross-node
        queues, then collect the loop tasks (they exit via
        ChannelClosed; their return value is the tick count)."""
        with self._td_lock:
            if self._torn_down:
                return
            self._torn_down = True
        _live_dags.discard(self)
        for ch in self._channels:
            ch.close(unlink=True)
        for key, resident in self._rchans:
            try:
                self._client.chan_close(resident, key)
            except Exception:
                pass
        try:
            ray_tpu_torch.get(self._loop_refs,
                        timeout=2 if self._error is not None else 10)
        except Exception:
            pass

    def __del__(self) -> None:
        try:
            self.teardown()
        except Exception:
            pass


def _bind(self, *args, **kwargs) -> ClassMethodNode:
    """`actor.method.bind(...)` — dag/class_node.py."""
    return ClassMethodNode(self._handle, self._name, args, kwargs)


# Attach to ActorMethod (kept here so the core actor module stays free
# of DAG concerns; importing ray_tpu_torch.dag activates .bind).
from ray_tpu_torch.actor import ActorMethod  # noqa: E402

ActorMethod.bind = _bind

"""Worker-side compiled-DAG execution loop.

Reference: python/ray/dag/compiled_dag_node.py `_execute_task` loops —
each participating actor runs one long-lived loop task that reads its
input channels, executes its ops in compiled order, and writes output
channels, until a channel is torn down.

`ops` wire format (built by ray_tpu_torch.dag compile):
    [{"method": name,
      "ins":  [("chan", path) | ("rchan_in", key) | ("local", key)
               | ("const", value)...],
      "kwargs": {k: slot},
      "outs": [("chan", path) | ("rchan_out", key, dst_hex)
               | ("local", key)...]},
     {"collective": {"op": "sum", "key": bytes, "rank": r, "world": n,
                     "nodes": [node_hex per rank]},
      "ins": [slot], "outs": [...]}, ...]

Same-actor edges ride `local` (an in-process dict — zero IPC);
same-node cross-process edges ride mmap `chan` rings (µs); cross-node
edges ride `rchan` — bounded queues on the consumer's node service,
fed over the persistent peer connections (the reference's
shared-memory/NCCL channel split, shared_memory_channel.py vs
torch_tensor_nccl_channel.py).

Collective ops (reference: dag/collective_node.py:134
CollectiveOutputNode) run a rank-0-rooted reduce over the rchan plane:
per-rank root in-queues keep ticks separated even when the DAG is
pipelined (each sender's per-queue order is FIFO)."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.experimental.channel import Channel, ChannelClosed
from ray_tpu_torch.util.collective import _REDUCERS


def _run_collective(spec: dict, val: Any, client) -> Any:
    base: bytes = spec["key"]
    rank, world = spec["rank"], spec["world"]
    arr = np.asarray(val)
    if world == 1:
        return _REDUCERS[spec["op"]](np.stack([arr]))
    if rank == 0:
        parts = [arr]
        for r in range(1, world):
            parts.append(np.asarray(
                client.chan_recv(base + b"/in/%d" % r)))
        out = _REDUCERS[spec["op"]](np.stack(parts))
        for r in range(1, world):
            client.chan_send(bytes.fromhex(spec["nodes"][r]),
                             base + b"/out/%d" % r, out)
        return out
    client.chan_send(bytes.fromhex(spec["nodes"][0]),
                     base + b"/in/%d" % rank, arr)
    return np.asarray(client.chan_recv(base + b"/out/%d" % rank))


def run_dag_loop(instance: Any, ops: List[dict],
                 client: Optional[Any] = None) -> int:
    if client is None:
        from ray_tpu_torch._private.client import get_global_client
        client = get_global_client()
    from ray_tpu_torch.util.metrics import (DAG_HOP_BUCKETS,
                                      DAG_HOP_SECONDS_METRIC,
                                      shared_histogram)
    observe_hop = shared_histogram(
        DAG_HOP_SECONDS_METRIC,
        description="compiled-DAG per-edge hop duration",
        boundaries=DAG_HOP_BUCKETS,
        tag_keys=("edge",)).observer({"edge": "local"})
    chans: Dict[str, Channel] = {}

    def chan(path: str) -> Channel:
        c = chans.get(path)
        if c is None:
            c = Channel(path)
            chans[path] = c
        return c

    def resolve(slot, local):
        kind, *rest = slot
        if kind == "chan":
            return chan(rest[0]).read()
        if kind == "rchan_in":
            return client.chan_recv(rest[0])
        if kind == "local":
            return local[rest[0]]
        return rest[0]

    def emit(slot, out, local) -> None:
        kind, *rest = slot
        if kind == "chan":
            # Local hop = the sender-side mmap write (serialize into
            # the slot + publish, incl. any backpressure wait).  The
            # remote hop is observed node-side on the streamed edge.
            t0 = time.perf_counter()
            chan(rest[0]).write(out)
            observe_hop(time.perf_counter() - t0)
        elif kind == "rchan_out":
            client.chan_send(bytes.fromhex(rest[1]), rest[0], out)
        else:
            local[rest[0]] = out

    # Pre-bound tick plan: the per-tick loop is the hot path, so
    # method lookups and kwargs-shape checks happen once here, not
    # per item.
    plan = []
    for op in ops:
        method = (None if "collective" in op
                  else getattr(instance, op["method"]))
        plan.append((op.get("collective"), method, op["ins"],
                     list((op.get("kwargs") or {}).items()),
                     op["outs"]))

    ticks = 0
    try:
        while True:
            local: Dict[str, Any] = {}
            for coll, method, ins, kw_items, outs in plan:
                args = [resolve(s, local) for s in ins]
                if coll is not None:
                    out = _run_collective(coll, args[0], client)
                elif kw_items:
                    out = method(*args, **{k: resolve(s, local)
                                           for k, s in kw_items})
                else:
                    out = method(*args)
                for slot in outs:
                    emit(slot, out, local)
            ticks += 1
    except ChannelClosed:
        return ticks
    finally:
        for c in chans.values():
            c.close()

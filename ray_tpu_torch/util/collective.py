"""Process-level collectives: the `ray.util.collective` analog.

Reference surface: python/ray/util/collective/collective.py:258-594
(init_collective_group, declare_collective_group, allreduce, barrier,
reducescatter, allgather, broadcast, send, recv, get_rank,
get_collective_group_size, destroy_collective_group).

GPU split of responsibilities:

* INSIDE a training step, collectives are torch.distributed's job —
  DTensor redistributions and NCCL all-reduces over a `DeviceMesh`
  (parallel/mesh.py, parallel/mesh_group.py) ride NVLink.  Nothing here
  is for that path.
* BETWEEN processes (actors coordinating outside jit — parameter
  exchange in Tune/PBT, rollout aggregation, eval fan-in), the
  reference stands up NCCL/gloo rings.  Here the transport IS the
  runtime's native object plane: each rank `put`s its shard into the
  zero-copy shm store and peers `get` it (cross-node gets ride the
  object-transfer plane), with GCS KV as the rendezvous/sequencing
  board.  No second networking stack to configure, and payloads move
  through the same spill/transfer machinery as everything else.

Semantics notes vs the reference:
* Arrays (numpy, or torch tensors on the CPU or a card) are reduced
  with f-order-preserving numpy ops on the host; numpy arrays and
  torch tensors are ALSO updated in place (reference mutates tensors in
  place), and the result is returned on the input's device (a CUDA
  tensor crosses as two host copies: to the host before the op, back
  into the input after it).  bf16 has no numpy dtype: bf16 tensors are
  reduced in f32 and cast back to bf16.
* Every rank must call the same collectives in the same order (standard
  collective contract) — a per-group operation counter sequences keys.
* Garbage: each rank remembers exactly which keys it published per op.
  Completing a *synchronizing* op at seq S (one whose completion proves
  every rank has entered S: barrier, allreduce, allgather,
  reducescatter) makes every key with seq < S dead, so they are deleted
  at the next op.  Broadcast does NOT synchronize (the src publishes
  and returns without waiting), so it never advances the horizon — its
  keys are reaped by the next synchronizing op or at destroy.
"""

from __future__ import annotations

import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.client import get_global_client

_NS = "collective"
_POLL_S = 0.002
# Finite default so a protocol bug (mismatched op order, dead peer)
# fails loudly instead of deadlocking the caller forever.
_DEFAULT_TIMEOUT_S = 300.0

_lock = threading.RLock()
_groups: Dict[str, "_Group"] = {}


class _Group:
    def __init__(self, name: str, world_size: int, rank: int) -> None:
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.seq = 0           # collective op counter
        self.p2p_seq: Dict[tuple, int] = {}   # (src, dst) -> counter
        self._refs: List[tuple] = []          # (seq, ObjectRef) pins
        # p2p pins live on their own ledger: p2p sequencing is per-pair
        # and independent of the collective counter, so the seq-horizon
        # GC must not touch them.  Released on receiver ack or destroy.
        self._p2p_refs: Dict[tuple, Any] = {}   # (dst, seq) -> ObjectRef
        # GC bookkeeping: exact keys this rank published per op, the
        # proven-safe horizon (all ranks have finished every op < this),
        # and how far deletion has already run.
        self._published: Dict[int, List[bytes]] = {}   # seq -> kv keys
        self._safe_below = 0
        self._gc_done_below = 0


def _client():
    c = get_global_client()
    if c is None:
        raise RuntimeError("ray_tpu_torch is not initialized in this process")
    return c


def _key(group: str, seq: int, tag: str) -> bytes:
    return f"{group}/{seq:09d}/{tag}".encode()


def _put_blob(group: _Group, seq: int, tag: str, value: Any,
              p2p_dst: Optional[int] = None) -> None:
    """Publish a value on the op board.  Small values inline into KV;
    big arrays go through the object store and only the ref id lands in
    KV (zero-copy within a node, transfer plane across nodes)."""
    blob = pickle.dumps(value, protocol=5)
    if len(blob) > 64 * 1024:
        ref = ray_tpu_torch.put(value)
        if p2p_dst is not None:
            group._p2p_refs[(p2p_dst, seq)] = ref
        else:
            group._refs.append((seq, ref))    # pin until GC horizon
        payload = b"R" + ref.binary()
    else:
        payload = b"I" + blob
    key = _key(group.name, seq, tag)
    if p2p_dst is None:
        group._published.setdefault(seq, []).append(key)
    _client().kv_put(_NS, key, payload)


def _get_blob(group: _Group, seq: int, tag: str,
              timeout: Optional[float] = _DEFAULT_TIMEOUT_S) -> Any:
    """Blocking read via the node's parked kv_wait (long-poll): no
    2ms client polling, no latency floor — the value arrives on the
    same push that stores it."""
    key = _key(group.name, seq, tag)
    deadline = None if timeout is None else time.monotonic() + timeout
    c = _client()
    while True:
        step = 30.0
        if deadline is not None:
            step = min(step, deadline - time.monotonic())
            if step <= 0:
                raise TimeoutError(
                    f"collective {tag} (group={group.name!r} seq={seq}) "
                    f"timed out after {timeout}s")
        raw = c.kv_wait(_NS, key, max(step, 0.001))
        if raw is not None:
            break
    if raw[:1] == b"R":
        from ray_tpu_torch.object_ref import ObjectRef
        return ray_tpu_torch.get(ObjectRef._from_wire(raw[1:]))
    return pickle.loads(raw[1:])


def _gc(group: _Group) -> None:
    """Delete this rank's published keys for every op that is provably
    finished on all ranks (seq < _safe_below).  Exact-key deletion —
    no prefix matching, so rank 1 can never clobber rank 12's data."""
    if group._gc_done_below >= group._safe_below:
        return
    c = _client()
    for s in range(group._gc_done_below, group._safe_below):
        for key in group._published.pop(s, ()):
            c.kv_del(_NS, key)
    group._gc_done_below = group._safe_below
    group._refs = [(s, r) for (s, r) in group._refs
                   if s >= group._safe_below]


def _mark_synced(group: _Group, seq: int) -> None:
    """Record that the op at `seq` synchronized all ranks: its
    completion proves every rank entered op `seq`, so every op < seq is
    finished everywhere and its keys are dead."""
    group._safe_below = max(group._safe_below, seq)


# ---------------------------------------------------------------------------
# group management
# ---------------------------------------------------------------------------
def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join `group_name` as `rank` of `world_size`.  Called inside each
    participating actor/task (reference: collective.py:258)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized "
                               f"in this process")
        _groups[group_name] = _Group(group_name, world_size, rank)
    # Rendezvous: every rank registers, all wait for a full roster.
    _client().kv_put(_NS, f"{group_name}/roster/{rank}".encode(),
                     str(world_size).encode())
    g = _groups[group_name]
    deadline = time.monotonic() + 120.0
    while True:
        n = len(_client().kv_keys(_NS, f"{group_name}/roster/".encode()))
        if n >= world_size:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"collective group {group_name!r}: only {n}/{world_size} "
                f"ranks joined within 120s")
        time.sleep(_POLL_S)


def declare_collective_group(actors, world_size: Optional[int] = None,
                             ranks: Optional[List[int]] = None,
                             group_name: str = "default") -> None:
    """Declare a group FROM THE DRIVER for a set of actors (reference:
    collective.py declare_collective_group): each actor's first
    collective op auto-joins with the rank declared for its actor id —
    no explicit init_collective_group call inside the actors."""
    world = world_size if world_size is not None else len(actors)
    rank_list = ranks if ranks is not None else list(range(len(actors)))
    if sorted(rank_list) != list(range(world)):
        raise ValueError(f"ranks {rank_list} must cover 0..{world - 1}")
    c = _client()
    for actor, rank in zip(actors, rank_list):
        c.kv_put(_NS, f"{group_name}/declared/"
                      f"{actor._actor_id.hex()}".encode(),
                 f"{rank}/{world}".encode())


def _maybe_auto_init(name: str) -> Optional[_Group]:
    """Join a driver-declared group using this actor's identity."""
    import ray_tpu_torch
    ctx = ray_tpu_torch.get_runtime_context()
    aid = ctx.get_actor_id()
    if aid is None:
        return None
    raw = _client().kv_get(_NS, f"{name}/declared/{aid}".encode())
    if raw is None:
        return None
    rank_s, _, world_s = raw.decode().partition("/")
    init_collective_group(int(world_s), int(rank_s), group_name=name)
    with _lock:
        return _groups.get(name)


def is_group_initialized(group_name: str = "default") -> bool:
    with _lock:
        return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group.  Deletes only THIS rank's keys — peers may not
    have read the last op's data yet — except the final leaver, who
    sweeps the whole prefix once the roster is empty."""
    with _lock:
        g = _groups.pop(group_name, None)
    if g is None:
        return
    c = _client()
    c.kv_del(_NS, f"{group_name}/roster/{g.rank}".encode())
    # Exact-key deletion from the published ledger (covers broadcast
    # "result" keys from any src rank, never touches peers' keys).
    for keys in g._published.values():
        for key in keys:
            c.kv_del(_NS, key)
    g._published.clear()
    prefix = f"{group_name}/".encode()
    for key in c.kv_keys(_NS, prefix):
        # p2p keys aren't in the ledger; parse the tag exactly —
        # substring matching would let rank 1 delete rank 12's data.
        parts = key[len(prefix):].split(b"/", 1)
        if len(parts) != 2:
            continue
        tag = parts[1].decode(errors="replace")
        if (tag.startswith(f"p2p/{g.rank}->")
                or tag.startswith(f"p2pack/{g.rank}->")):
            c.kv_del(_NS, key)
    if not c.kv_keys(_NS, f"{group_name}/roster/".encode()):
        for key in c.kv_keys(_NS, prefix):
            c.kv_del(_NS, key)


def _group(name: str) -> _Group:
    with _lock:
        g = _groups.get(name)
    if g is None:
        g = _maybe_auto_init(name)
    if g is None:
        raise RuntimeError(
            f"collective group {name!r} is not initialized in this "
            f"process (call init_collective_group, or declare it from "
            f"the driver with declare_collective_group)")
    return g


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
_REDUCERS = {
    "sum": lambda stack: np.sum(stack, axis=0),
    "prod": lambda stack: np.prod(stack, axis=0),
    "max": lambda stack: np.max(stack, axis=0),
    "min": lambda stack: np.min(stack, axis=0),
    "mean": lambda stack: np.mean(stack, axis=0),
}


def _tensor(x) -> bool:
    """Whether `x` is a torch tensor (without importing torch: none can
    exist before it is imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _host(arr) -> np.ndarray:
    """The input as a host numpy array: a tensor is copied off its
    device, bf16 as f32 (numpy has no bf16)."""
    if _tensor(arr):
        import torch
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(arr)


def _like(arr, out):
    """`out` as a tensor of `arr`'s dtype on `arr`'s device (a new one);
    other inputs get the numpy result."""
    if not _tensor(arr):
        return out
    import torch
    return torch.from_numpy(np.ascontiguousarray(out)).to(
        device=arr.device, dtype=arr.dtype)


def _finish(arr, out):
    """In-place update for numpy and tensor inputs (a tensor keeps its
    device and dtype) + always return the result."""
    if isinstance(arr, np.ndarray):
        arr[...] = out
        return arr
    if _tensor(arr):
        import torch
        with torch.no_grad():
            arr.copy_(torch.from_numpy(np.ascontiguousarray(out)))
        return arr
    return out


def _unchanged(arr):
    """The result of an op that leaves the input as it is (one rank, or
    the broadcast's source): a tensor itself, without host copies."""
    return arr if _tensor(arr) else _finish(arr, np.asarray(arr))


def allreduce(arr, op: str = "sum", group_name: str = "default"):
    """Reduce across ranks (rank-0 root reduce + broadcast over the
    object plane).  Reference: collective.py:327."""
    g = _group(group_name)
    seq = g.seq
    g.seq += 1
    _gc(g)
    reducer = _REDUCERS.get(op)
    if reducer is None:
        raise ValueError(f"unknown reduce op {op!r} "
                         f"(have {sorted(_REDUCERS)})")
    if g.world_size == 1:
        _mark_synced(g, seq + 1)
        return _unchanged(arr)
    local = _host(arr)
    _put_blob(g, seq, f"r{g.rank}", local)
    if g.rank == 0:
        parts = [_get_blob(g, seq, f"r{r}") for r in range(g.world_size)]
        out = reducer(np.stack([np.asarray(p) for p in parts]))
        out = out.astype(local.dtype) if op != "mean" else out
        _put_blob(g, seq, "result", out)
    else:
        out = np.asarray(_get_blob(g, seq, "result"))
    # Root read every rank's input; non-roots read the root's result,
    # which implies the same — everyone has entered this op.
    _mark_synced(g, seq)
    return _finish(arr, out)


def barrier(group_name: str = "default") -> None:
    """All ranks wait until every rank arrives (collective.py:367)."""
    g = _group(group_name)
    seq = g.seq
    g.seq += 1
    _gc(g)
    if g.world_size == 1:
        _mark_synced(g, seq + 1)
        return
    _put_blob(g, seq, f"r{g.rank}", True)
    for r in range(g.world_size):
        _get_blob(g, seq, f"r{r}")
    _mark_synced(g, seq)


def broadcast(arr, src_rank: int = 0, group_name: str = "default"):
    """Copy src_rank's array to every rank (collective.py:389)."""
    g = _group(group_name)
    seq = g.seq
    g.seq += 1
    _gc(g)
    if g.world_size == 1:
        _mark_synced(g, seq + 1)
        return _unchanged(arr)
    if g.rank == src_rank:
        _put_blob(g, seq, "result", _host(arr))
        return _unchanged(arr)
    out = np.asarray(_get_blob(g, seq, "result"))
    # NOT synced: the src published and moved on without waiting, and a
    # non-src rank only proved the src entered this op — a slow peer may
    # still be reading earlier keys, so the horizon must not advance.
    return _finish(arr, out)


def allgather(arr, group_name: str = "default") -> List[Any]:
    """Every rank receives [arr_0, ..., arr_{n-1}] (collective.py:433),
    as tensors on the input's device when the input is a tensor."""
    g = _group(group_name)
    seq = g.seq
    g.seq += 1
    _gc(g)
    local = _host(arr)
    if g.world_size == 1:
        _mark_synced(g, seq + 1)
        return [_like(arr, local)]
    _put_blob(g, seq, f"r{g.rank}", local)
    out = [np.asarray(_get_blob(g, seq, f"r{r}"))
           for r in range(g.world_size)]
    _mark_synced(g, seq)
    return [_like(arr, o) for o in out]


def reducescatter(arr, op: str = "sum",
                  group_name: str = "default"):
    """Reduce then scatter row-shards: rank i gets the i-th 1/n slice
    along axis 0 of the reduction (collective.py:469), as a tensor on
    the input's device when the input is a tensor."""
    g = _group(group_name)
    reducer = _REDUCERS.get(op)
    if reducer is None:
        raise ValueError(f"unknown reduce op {op!r}")
    local = _host(arr)
    if local.shape[0] % g.world_size:
        raise ValueError(
            f"reducescatter needs dim0 ({local.shape[0]}) divisible by "
            f"world_size ({g.world_size})")
    seq = g.seq
    g.seq += 1
    _gc(g)
    if g.world_size == 1:
        _mark_synced(g, seq + 1)
        return _like(arr, reducer(np.stack([local])))
    # Scatter-then-reduce: each rank publishes only the slice destined
    # for each peer, so no rank ever holds the full stacked array.
    shards = np.split(local, g.world_size, axis=0)
    for r, shard in enumerate(shards):
        if r != g.rank:
            _put_blob(g, seq, f"r{g.rank}:{r}", shard)
    parts = [shards[g.rank] if r == g.rank
             else np.asarray(_get_blob(g, seq, f"r{r}:{g.rank}"))
             for r in range(g.world_size)]
    out = reducer(np.stack(parts))
    _mark_synced(g, seq)
    return _like(arr, out if op == "mean" else out.astype(local.dtype))


def send(arr, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send (collective.py:551).  Pairwise FIFO.
    Large-payload pins are released when the receiver acks (or at
    destroy_collective_group)."""
    g = _group(group_name)
    if dst_rank == g.rank:
        raise ValueError("send to self")
    pair = (g.rank, dst_rank)
    seq = g.p2p_seq.get(pair, 0)
    g.p2p_seq[pair] = seq + 1
    # Release pins the receiver has acked.
    c = _client()
    for (dst, s) in list(g._p2p_refs):
        if dst != dst_rank:
            continue
        ack = _key(g.name, s, f"p2pack/{g.rank}->{dst}")
        if c.kv_get(_NS, ack) is not None:
            del g._p2p_refs[(dst, s)]
            c.kv_del(_NS, ack)
    _put_blob(g, seq, f"p2p/{g.rank}->{dst_rank}", _host(arr),
              p2p_dst=dst_rank)


def recv(arr, src_rank: int, group_name: str = "default"):
    """Point-to-point receive matching `send` (collective.py:571)."""
    g = _group(group_name)
    if src_rank == g.rank:
        raise ValueError("recv from self")
    pair = (src_rank, g.rank)
    seq = g.p2p_seq.get(pair, 0)
    g.p2p_seq[pair] = seq + 1
    out = np.asarray(_get_blob(g, seq, f"p2p/{src_rank}->{g.rank}"))
    c = _client()
    c.kv_del(_NS, _key(g.name, seq, f"p2p/{src_rank}->{g.rank}"))
    # Ack so the sender can release its object-store pin.
    c.kv_put(_NS, _key(g.name, seq, f"p2pack/{src_rank}->{g.rank}"),
             b"1")
    return _finish(arr, out)

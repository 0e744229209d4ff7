"""Elastic gang training: resize-in-place on preemptible capacity.

The port's copy of `ray_tpu/train/elastic.py`.  Where the JAX package
shards numpy arrays, the port shards torch tensors directly (bf16 has
no numpy dtype); shards cross the object store as CPU tensors, which
the runtime's serializer carries with their dtype.  The allreduce sums
in float64 and casts each leaf back to its own dtype.  torch is never
imported here: a tree holds tensors only where the caller already
imported it, so the trainer's driver stays torch-free.

The fixed-world train path (trainer.py) treats a preempted worker as a
restart: kill the gang, restore from the last DISK checkpoint at the
same world size, and wait for replacement hardware.  On preemptible
fleets that wait can be minutes of dead time.  This module decouples
the job from its hardware (the VirtualFlow virtual-node idea) and
reshards optimizer state across survivors (ZeRO-style sharded state):

1. **In-cluster sharded checkpoints** — each worker asynchronously
   snapshots ITS shard of params/opt_state into the object store on a
   cadence (``train_ckpt_interval_s``).  A per-run *checkpoint keeper*
   actor collects the shard ObjectRefs and, once every member's shard
   for a step has arrived, registers a manifest (run, step, mesh
   shape, shard -> ObjectRef map) in the control-plane KV — so the
   latest CONSISTENT step is discoverable after any failure.

   Ref-pinning contract (the "last borrow drops the replica" trap):
   the keeper is the live owner pinning every committed shard;
   an old manifest's blocks are released only AFTER the new manifest
   is registered, and the publishing worker keeps its own put refs
   alive across the handoff so the keeper's borrow always lands on a
   live entry.

2. **Resize on preemption** — when a ``preempt`` notice (or a hard
   kill) removes a worker, the driver bumps the gang *epoch* in the
   gang record; survivors observe the epoch change at their next
   ``sync()``, pull the missing shards from the in-cluster checkpoint
   (ZERO disk reads — counted by the telemetry ckpt-read accounting),
   reshard to the new world size, and continue at reduced throughput.

3. **Grow-back** — when capacity heals the driver spawns a
   replacement worker (telemetry ``recovery_class="resize_recovery"``)
   and bumps the epoch again; resharding runs in reverse.

4. **Accounting** — resize dead time is charged to the goodput
   ledger's ``resize_recovery`` class (distinct from
   ``restart_recovery``), ``ray_tpu_train_resizes_total{direction}`` /
   ``ray_tpu_train_world_size`` move, and resize events are recorded
   in the run meta, which ``state.train_summary()``, the CLI's ``train
   status`` and ``state.doctor()``'s GANG_RESIZE_THRASH read once the
   state API and CLI are ported (ROADMAP A2d, A2e).

Enable with ``train_elastic_enabled`` (or
``ScalingConfig(elastic=True)``).  The worker-side surface is
``session.get_context().elastic()`` -> :class:`ElasticSession`.
"""

from __future__ import annotations

import json
import pickle
import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.config import config
from ray_tpu_torch.devtools import leaksan

# Control-plane KV namespaces.
KV_CKPT_NS = "__train_ckpt__"     # run -> pickled shard manifest
KV_GANG_NS = "__train_gang__"     # run -> json gang record
KV_REDUCE_NS = "__train_reduce__"  # per-(epoch, step, rank) reduce slots

_SEP = "\x1f"


class ResizeInterrupt(Exception):
    """Raised out of a collective when the gang epoch changed under it
    (a member died or joined); the caller re-syncs, reshards from the
    in-cluster checkpoint, and continues."""


def keeper_name(run: str) -> str:
    """The per-run checkpoint keeper's GCS actor-directory name."""
    return f"elastic_keeper:{run}"


# ---------------------------------------------------------------------------
# pytree shard/reshard helpers (pure, unit-testable)
# ---------------------------------------------------------------------------
def _is_tensor(x: Any) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def shard_pytree(tree: Any, index: int, nshards: int) -> Any:
    """This shard's slice of a pytree: every tensor or array leaf is
    split along axis 0 into ``nshards`` near-equal parts
    (torch.tensor_split / np.array_split, so any leading dim works); 0-d
    leaves are replicated.  Exact round-trip with
    :func:`unshard_pytree` for ANY nshards — which is what makes
    4 -> 3 -> 4 resharding a pure unshard+reshard."""
    if not 0 <= index < nshards:
        raise ValueError(f"shard index {index} not in [0, {nshards})")
    if isinstance(tree, dict):
        return {k: shard_pytree(v, index, nshards)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_pytree(v, index, nshards)
                          for v in tree)
    if _is_tensor(tree):
        if tree.ndim == 0:
            return tree
        return tree.detach().tensor_split(nshards, dim=0)[index]
    arr = np.asarray(tree)
    if arr.ndim == 0:
        return arr
    return np.array_split(arr, nshards, axis=0)[index]


def unshard_pytree(shards: List[Any]) -> Any:
    """Inverse of :func:`shard_pytree`: concatenate the ordered shard
    list back into the full pytree."""
    if not shards:
        raise ValueError("no shards to unshard")
    first = shards[0]
    if isinstance(first, dict):
        return {k: unshard_pytree([s[k] for s in shards])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            unshard_pytree([s[i] for s in shards])
            for i in range(len(first)))
    if _is_tensor(first):
        if first.ndim == 0:
            return first
        return sys.modules["torch"].cat(list(shards), dim=0)
    arr = np.asarray(first)
    if arr.ndim == 0:
        return arr
    parts = [np.asarray(s) for s in shards]
    return np.concatenate([p for p in parts if p.size or p.ndim],
                          axis=0)


def _tree_scale_add(acc: Any, tree: Any, w: float) -> Any:
    """acc + w * tree, leafwise in float64 (acc may be None = zero)."""
    if isinstance(tree, dict):
        return {k: _tree_scale_add(None if acc is None else acc[k],
                                   v, w)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _tree_scale_add(None if acc is None else acc[i], v, w)
            for i, v in enumerate(tree))
    if _is_tensor(tree):
        leaf = tree.detach().double() * w
    else:
        leaf = np.asarray(tree, dtype=np.float64) * w
    return leaf if acc is None else acc + leaf


def _tree_scale(tree: Any, s: float, like: Any) -> Any:
    """tree * s, each tensor leaf cast back to the dtype of `like`'s
    (array leaves stay float64, as in the JAX package)."""
    if isinstance(tree, dict):
        return {k: _tree_scale(v, s, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_scale(v, s, like[i])
                          for i, v in enumerate(tree))
    if _is_tensor(tree):
        return (tree * s).to(like.dtype)
    return np.asarray(tree) * s


# ---------------------------------------------------------------------------
# manifest store (the keeper's brain; plain class so the ref-pinning
# order is unit-testable in process)
# ---------------------------------------------------------------------------
class ManifestStore:
    """Collects per-member shard refs per step and commits a manifest
    to the control-plane KV once a step is complete.

    Ordering contract (the last-borrow trap demands it): a step's
    shard refs are released only AFTER a NEWER manifest has been
    registered in the KV — a reader that resolved the latest manifest
    always finds its blocks pinned by this store.  ``log`` records
    every ("register", step) / ("release", step) transition so tests
    can assert the order outright.

    Epoch freeze (:meth:`freeze`): the first restore request for a
    gang epoch pins that epoch's restore point and drops every
    publish tagged with an older epoch from then on.  Without it, a
    stale pre-resize publish could complete a slot BETWEEN two
    survivors' restores — they'd resume at different steps and the
    KV allreduce would never complete."""

    def __init__(self, run: str, client: Any = None,
                 keep: Optional[int] = None) -> None:
        self.run = run
        self._client = client
        self.keep = max(int(keep if keep is not None
                            else config.train_ckpt_keep), 1)
        # {(step, nshards): {idx: ref}} awaiting completion.
        self._pending: Dict[Tuple[int, int], Dict[int, Any]] = {}
        # Committed steps oldest-first: [(step, {idx: ref}, nshards)].
        self._committed: List[Tuple[int, Dict[int, Any], int]] = []
        self.log: List[Tuple[str, int]] = []
        self.commits = 0
        self.releases = 0
        self._min_epoch = 0
        # {epoch: manifest-or-None} — only the newest epoch is cached.
        self._frozen: Dict[int, Optional[Dict[str, Any]]] = {}

    # -- publish/commit -------------------------------------------------
    def publish(self, step: int, index: int, nshards: int,
                ref: Any, meta: Optional[Dict[str, Any]] = None,
                epoch: int = 0) -> Optional[int]:
        """Record one member's shard for (step, nshards).  Returns the
        step just committed when this shard completed it, else None.
        Recomputed steps at or below the latest commit (post-resize
        rollback replay) and publishes from a pre-freeze epoch are
        ignored."""
        step = int(step)
        if int(epoch) < self._min_epoch:
            return None
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return None
        slot = self._pending.setdefault((step, int(nshards)), {})
        old = slot.get(int(index))
        slot[int(index)] = ref
        if old is None:
            leaksan.register("ckpt_shard",
                            (self.run, step, int(nshards), int(index)),
                            detail=f"elastic shard {self.run} s{step}")
        if len(slot) == int(nshards):
            self._commit(step, int(nshards), meta or {})
            return step
        return None

    def _commit(self, step: int, nshards: int,
                meta: Dict[str, Any]) -> None:
        shards = self._pending.pop((step, nshards))
        manifest = {
            "run": self.run,
            "step": step,
            "world_size": nshards,
            "mesh_shape": list(meta.get("mesh_shape") or [nshards]),
            "ts": time.time(),
            "shards": {i: shards[i] for i in range(nshards)},
        }
        # REGISTER FIRST: the new manifest must be discoverable (and
        # its blocks pinned here) before any older step is let go.
        if self._client is not None:
            self._client.kv_put(KV_CKPT_NS, self.run.encode(),
                                pickle.dumps(manifest))
        self._committed.append((step, shards, nshards))
        self._committed.sort(key=lambda c: c[0])
        self.log.append(("register", step))
        self.commits += 1
        # ONLY NOW release anything older than the retention window,
        # plus stale pending slots a resize orphaned mid-step.
        while len(self._committed) > self.keep:
            old_step, old_shards, old_n = self._committed.pop(0)
            for idx in list(old_shards):
                leaksan.discharge(
                    "ckpt_shard", (self.run, old_step, old_n, idx))
                del old_shards[idx]
            self.log.append(("release", old_step))
            self.releases += 1
        for key in [k for k in self._pending if k[0] <= step]:
            pstep, pn = key
            slot = self._pending.pop(key)
            for idx in list(slot):
                leaksan.discharge("ckpt_shard",
                                  (self.run, pstep, pn, idx))
                del slot[idx]

    def _manifest_dict(self, step: int, shards: Dict[int, Any],
                       nshards: int) -> Dict[str, Any]:
        return {
            "run": self.run,
            "step": step,
            "world_size": nshards,
            "mesh_shape": [nshards],
            "ts": time.time(),
            # Copy: retention mutates the committed dict in place.
            "shards": dict(shards),
        }

    def freeze(self, epoch: int) -> Optional[Dict[str, Any]]:
        """Pin epoch ``epoch``'s restore point: the first call for a
        new epoch snapshots the latest committed manifest, discards
        every partial pending slot (their writers' epoch is dead),
        and rejects publishes tagged with an older epoch from now on.
        Every member restoring for the same epoch gets the SAME
        manifest — which is what keeps the resharded gang in lockstep.
        Returns the manifest, or None when nothing has committed."""
        epoch = int(epoch)
        if epoch in self._frozen:
            return self._frozen[epoch]
        if epoch < self._min_epoch:
            # Laggard asking about a superseded epoch: hand back the
            # current restore point without disturbing the freeze.
            if self._committed:
                step, shards, nshards = self._committed[-1]
                return self._manifest_dict(step, shards, nshards)
            return None
        self._min_epoch = epoch
        for (pstep, pn), slot in list(self._pending.items()):
            for idx in list(slot):
                leaksan.discharge("ckpt_shard",
                                  (self.run, pstep, pn, idx))
                del slot[idx]
            self._pending.pop((pstep, pn), None)
        man = None
        if self._committed:
            step, shards, nshards = self._committed[-1]
            man = self._manifest_dict(step, shards, nshards)
        self._frozen = {epoch: man}
        return man

    # -- queries ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return self._committed[-1][0] if self._committed else None

    def stats(self) -> Dict[str, Any]:
        return {
            "run": self.run,
            "latest_step": self.latest_step(),
            "committed_steps": [c[0] for c in self._committed],
            "pending_slots": {f"{s}/{n}": len(v) for (s, n), v
                              in self._pending.items()},
            "refs_live": (sum(len(c[1]) for c in self._committed)
                          + sum(len(v)
                                for v in self._pending.values())),
            "commits": self.commits,
            "releases": self.releases,
            "log": list(self.log),
        }

    def release_all(self) -> int:
        """Drop every held ref (teardown).  The KV manifest entry is
        removed too — a manifest whose blocks are gone is a trap, not
        a checkpoint."""
        n = 0
        for step, shards, nshards in self._committed:
            for idx in list(shards):
                leaksan.discharge("ckpt_shard",
                                  (self.run, step, nshards, idx))
                del shards[idx]
                n += 1
        self._committed = []
        for (pstep, pn), slot in list(self._pending.items()):
            for idx in list(slot):
                leaksan.discharge("ckpt_shard",
                                  (self.run, pstep, pn, idx))
                del slot[idx]
                n += 1
        self._pending = {}
        if self._client is not None:
            try:
                self._client.kv_del(KV_CKPT_NS, self.run.encode())
            except Exception:
                pass
        return n


@ray_tpu_torch.remote
class _CheckpointKeeper:
    """The per-run live owner of the in-cluster checkpoint: a named
    actor holding every committed shard ref (pinning the object-store
    blocks) and writing the step manifest to the KV.  One per run,
    spawned by the elastic coordinator; ``stop()`` releases the refs
    and discharges the leak ledger BEFORE the driver kills it (a
    SIGKILLed process dumps no ledger)."""

    def __init__(self, run: str, keep: int = 0) -> None:
        from ray_tpu_torch._private.client import get_global_client
        self._store = ManifestStore(
            run, client=get_global_client(),
            keep=keep or None)

    def publish(self, step: int, index: int, nshards: int,
                ref_list: List[Any],
                meta: Optional[Dict[str, Any]] = None,
                epoch: int = 0) -> Optional[int]:
        # The shard ref travels INSIDE a list so it arrives as a ref
        # (a bare ObjectRef argument is materialized at the callee);
        # holding it in the store is what pins the block.
        return self._store.publish(step, index, nshards, ref_list[0],
                                   meta, epoch=epoch)

    def manifest_for_epoch(self, epoch: int
                           ) -> Optional[Dict[str, Any]]:
        # The returned manifest carries the shard ObjectRefs; the
        # caller borrows them on deserialize while this actor keeps
        # the blocks pinned.
        return self._store.freeze(epoch)

    def latest_step(self) -> Optional[int]:
        return self._store.latest_step()

    def stats(self) -> Dict[str, Any]:
        return self._store.stats()

    def stop(self) -> int:
        return self._store.release_all()


# ---------------------------------------------------------------------------
# gang record (driver writes, workers poll)
# ---------------------------------------------------------------------------
def read_gang(client, run: str) -> Optional[Dict[str, Any]]:
    try:
        blob = client.kv_get(KV_GANG_NS, run.encode())
    except Exception:
        return None
    if not blob:
        return None
    try:
        return json.loads(blob)
    except ValueError:
        return None


def write_gang(client, run: str, epoch: int, members: List[int],
               restore_step: Optional[int],
               notices: Optional[Dict[str, float]] = None) -> None:
    client.kv_put(KV_GANG_NS, run.encode(), json.dumps({
        "epoch": int(epoch),
        "members": sorted(int(m) for m in members),
        "world_size": len(members),
        "restore_step": restore_step,
        "notices": notices or {},
        "updated_ts": time.time(),
    }).encode())


def latest_manifest_step(client, run: str) -> Optional[int]:
    """The latest committed in-cluster checkpoint step (driver-side
    peek; the full manifest stays pickled for the workers)."""
    try:
        blob = client.kv_get(KV_CKPT_NS, run.encode())
        return int(pickle.loads(blob)["step"]) if blob else None
    except Exception:
        return None


def cleanup_run(client, run: str) -> None:
    """Delete a run's gang record and reduce slots (fit start/end).
    The manifest entry is the keeper's to remove (release_all) — it
    must not outlive the pinned blocks, nor be deleted while a reader
    may still resolve it."""
    try:
        client.kv_del(KV_GANG_NS, run.encode())
        for key in client.kv_keys(KV_REDUCE_NS,
                                  prefix=f"{run}{_SEP}".encode()):
            client.kv_del(KV_REDUCE_NS, key)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# worker-side session
# ---------------------------------------------------------------------------
class ElasticSession:
    """A train worker's handle on the elastic plane: gang membership,
    sharded checkpoint save/restore, and a resize-aware allreduce.

    Typical loop (see tests/test_torch_mesh_group.py)::

        es = session.get_context().elastic()
        es.join()
        t, state = 0, init_state()
        got = es.restore()
        if got:
            t, state = got[0] + 1, got[1]
        while t < total_steps:
            ev = es.sync()
            if ev and ev["resized"]:
                with tel.resize():
                    t, state = es.restore_or(t, state)
                continue
            if ev and ev["notice_deadline"]:
                es.save_shard(t - 1, state, force=True)
                return                      # graceful preempt exit
            grad = ...                      # this member's shard of work
            grad = es.allreduce(t, grad, weight=my_batch_len)
            state = apply(state, grad)
            es.save_shard(t, state)
            t += 1
    """

    def __init__(self, run: str, rank: int, client: Any = None,
                 telemetry_provider: Optional[Callable[[], Any]] = None
                 ) -> None:
        if client is None:
            from ray_tpu_torch._private.client import get_global_client
            client = get_global_client()
        self._client = client
        self._run = run
        self._rank = int(rank)
        self._tel = telemetry_provider or (lambda: None)
        self._keeper = None
        self._epoch = -1
        self._members: List[int] = []
        self._last_save = 0.0
        self._last_sync = 0.0
        # Pin the last few put refs: the keeper's borrow lands only
        # when it DESERIALIZES the publish args, and the publisher
        # dropping its owned ref first would strand the handoff (the
        # last-borrow trap, on the write side).
        self._recent_refs: deque = deque(maxlen=4)

    # -- membership ------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def members(self) -> List[int]:
        return list(self._members)

    def shard_index(self) -> int:
        return self._members.index(self._rank)

    def _keeper_handle(self):
        if self._keeper is None:
            self._keeper = ray_tpu_torch.get_actor(keeper_name(self._run))
        return self._keeper

    def join(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Block until the gang record exists; adopt its epoch."""
        deadline = time.monotonic() + timeout
        while True:
            g = read_gang(self._client, self._run)
            if g is not None:
                self._epoch = int(g["epoch"])
                self._members = [int(m) for m in g["members"]]
                return g
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no gang record for run {self._run!r}")
            time.sleep(0.02)

    def sync(self, force: bool = True) -> Optional[Dict[str, Any]]:
        """Poll the gang record.  Returns None when rate-limited
        (force=False) or the record is missing; otherwise a dict with
        ``resized`` (the epoch moved — reshard before continuing),
        the new ``epoch``/``members``/``restore_step``, and this
        rank's ``notice_deadline`` (a preemption notice: save a final
        shard and exit gracefully)."""
        now = time.monotonic()
        if not force and now - self._last_sync < float(
                config.train_elastic_poll_s):
            return None
        self._last_sync = now
        g = read_gang(self._client, self._run)
        if g is None:
            return None
        resized = int(g["epoch"]) != self._epoch
        if resized:
            self._epoch = int(g["epoch"])
            self._members = [int(m) for m in g["members"]]
        notice = (g.get("notices") or {}).get(str(self._rank))
        return {"resized": resized, "epoch": self._epoch,
                "members": list(self._members),
                "restore_step": g.get("restore_step"),
                "notice_deadline": notice}

    # -- sharded checkpoint ---------------------------------------------
    def save_shard(self, step: int, state: Any,
                   force: bool = False) -> bool:
        """Snapshot this member's shard of ``state`` into the object
        store and hand the ref to the keeper.  Cadence-gated by
        ``train_ckpt_interval_s`` unless forced (0 = every call).
        Returns True when a shard was published."""
        interval = float(config.train_ckpt_interval_s)
        now = time.monotonic()
        if not force and interval > 0 and (
                now - self._last_save < interval):
            return False
        if self._rank not in self._members:
            return False
        idx = self.shard_index()
        n = len(self._members)
        tel = self._tel()
        timer = tel.checkpoint() if tel is not None else None
        if timer is not None:
            timer.__enter__()
        try:
            ref = ray_tpu_torch.put(shard_pytree(state, idx, n))
            self._recent_refs.append(ref)
            # Fire-and-forget: the snapshot is asynchronous by design;
            # commit consistency is the keeper's job.  The epoch tag
            # lets the keeper drop publishes that raced a resize.
            self._keeper_handle().publish.remote(  # ray-tpu: noqa[RT006]
                int(step), idx, n, [ref], {"mesh_shape": [n]},
                self._epoch)
        finally:
            if timer is not None:
                timer.__exit__(None, None, None)
        self._last_save = now
        return True

    def restore(self) -> Optional[Tuple[int, Any]]:
        """Pull this epoch's consistent in-cluster checkpoint from the
        keeper and reassemble the FULL state: (step, state), or None
        when no manifest has been committed yet.  The keeper freezes
        the epoch's restore point on first ask, so every member of
        the epoch restores the SAME step.  Counts as a 'memory'
        checkpoint read — never touches disk."""
        try:
            man = ray_tpu_torch.get(
                self._keeper_handle().manifest_for_epoch.remote(
                    self._epoch), timeout=60)
        except Exception:
            return None
        if man is None:
            return None
        refs = [man["shards"][i] for i in range(int(man["world_size"]))]
        shards = [ray_tpu_torch.get(r) for r in refs]
        state = unshard_pytree(shards)
        tel = self._tel()
        if tel is not None:
            tel.note_ckpt_read("memory")
        return int(man["step"]), state

    def restore_or(self, step: int, state: Any
                   ) -> Tuple[int, Any]:
        """restore(), falling back to the caller's current (step,
        state) when no manifest exists yet (resize before the first
        commit).  Returns the NEXT step to run."""
        got = self.restore()
        if got is None:
            return step, state
        return got[0] + 1, got[1]

    # -- resize-aware collective ----------------------------------------
    def allreduce(self, step: int, tree: Any,
                  weight: float = 1.0,
                  timeout: float = 60.0) -> Any:
        """Weighted-mean allreduce over the CURRENT members through
        the control-plane KV: post (weight, tree), wait for every
        member's contribution for (epoch, step), return
        sum(w_i * tree_i) / sum(w_i).

        With weight = this member's shard size, the weighted mean of
        per-shard gradients IS the full-batch gradient at any world
        size — the loss-curve-equivalence invariant.  Raises
        :class:`ResizeInterrupt` when the epoch moves mid-wait (a
        member died): the caller reshards and replays the step."""
        epoch = self._epoch
        mine = self._reduce_key(epoch, step, self._rank)
        self._client.kv_put(KV_REDUCE_NS, mine,
                            pickle.dumps((float(weight), tree)))
        members = list(self._members)
        poll = min(float(config.train_elastic_poll_s), 0.02)
        deadline = time.monotonic() + timeout
        got: Dict[int, Any] = {}
        while True:
            for m in members:
                if m in got:
                    continue
                blob = self._client.kv_get(
                    KV_REDUCE_NS, self._reduce_key(epoch, step, m))
                if blob:
                    got[m] = pickle.loads(blob)
            if len(got) == len(members):
                break
            g = read_gang(self._client, self._run)
            if g is not None and int(g["epoch"]) != epoch:
                raise ResizeInterrupt(
                    f"epoch {epoch} -> {g['epoch']} during allreduce "
                    f"at step {step}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"allreduce step {step}: "
                    f"{sorted(set(members) - set(got))} missing")
            time.sleep(poll)
        total_w = sum(w for w, _ in got.values())
        acc = None
        for m in members:
            w, t = got[m]
            acc = _tree_scale_add(acc, t, w)
        # Everyone posted (epoch, step), so everyone has FINISHED
        # reading (epoch, step-1) — this rank's previous slot can go.
        if step > 0:
            try:
                self._client.kv_del(
                    KV_REDUCE_NS,
                    self._reduce_key(epoch, step - 1, self._rank))
            except Exception:
                pass
        return _tree_scale(acc, 1.0 / max(total_w, 1e-12), tree)

    def _reduce_key(self, epoch: int, step: int, rank: int) -> bytes:
        return (f"{self._run}{_SEP}{epoch}{_SEP}{step}"
                f"{_SEP}{rank}").encode()


# ---------------------------------------------------------------------------
# driver-side coordinator
# ---------------------------------------------------------------------------
def run_elastic_attempt(trainer, trial_dir: str, manager, restore,
                        attempt: int, history: List[Dict[str, Any]],
                        actor_opts: Dict[str, Any],
                        report_ns: str) -> Dict[str, Any]:
    """The elastic replacement for GpuTrainer._run_attempt: spawn the
    keeper + gang, then drive the wait/drain loop with shrink-on-
    preempt and grow-back instead of fail-the-attempt.  Falls through
    to the caller's restart path (by re-raising the worker death) only
    when a shrink would cross ``train_min_world_size``."""
    import os

    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private.chaos import chaos
    from ray_tpu_torch.train import telemetry as telemetry_mod
    from ray_tpu_torch.train.trainer import _TrainWorker

    client = ray_tpu_torch._ensure_connected()
    run_name = os.path.basename(trial_dir.rstrip("/"))
    world0 = trainer._scaling.num_workers
    min_world = max(int(config.train_min_world_size), 1)
    poll_s = max(float(config.train_elastic_poll_s), 0.05)
    grow_retry_s = max(float(config.train_grow_retry_s), 0.1)

    cleanup_run(client, run_name)
    keeper = _CheckpointKeeper.options(
        name=keeper_name(run_name)).remote(run_name)
    # The keeper must be resolvable by name before any worker's first
    # save_shard; ping synchronously.
    ray_tpu_torch.get(keeper.latest_step.remote(), timeout=60)

    epoch = 0
    members = list(range(world0))
    notices: Dict[str, float] = {}
    write_gang(client, run_name, epoch, members, None, notices)
    telemetry_mod.set_world_size_gauge(run_name, len(members))

    def _spawn(rank: int, recovery_class: str):
        cls = (_TrainWorker.options(**actor_opts) if actor_opts
               else _TrainWorker)
        w = cls.remote(rank, world0, trial_dir,
                       trainer._config or {}, restore, report_ns,
                       None, recovery_class)
        return w, w.run.remote((trainer._fn, trainer._config))

    workers: Dict[int, Any] = {}
    pending: Dict[Any, int] = {}         # run ref -> rank
    for rank in members:
        w, ref = _spawn(rank, "restart_recovery")
        workers[rank] = w
        pending[ref] = rank

    straggler_check_s = float(config.train_straggler_check_s)
    next_straggler = time.time() + straggler_check_s
    kill_at: Dict[int, float] = {}       # noticed rank -> hard deadline
    next_grow = 0.0
    last_resize_start = 0.0
    done_ranks: set = set()

    def _shrink(victim: int) -> None:
        nonlocal epoch, last_resize_start, next_grow
        t0 = time.time()
        members.remove(victim)
        notices.pop(str(victim), None)
        kill_at.pop(victim, None)
        w = workers.pop(victim, None)
        if w is not None:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        epoch += 1
        step = latest_manifest_step(client, run_name)
        write_gang(client, run_name, epoch, members, step, notices)
        telemetry_mod.record_resize(
            client, run_name, "shrink", len(members) + 1,
            len(members), step if step is not None else -1,
            dead_s=time.time() - t0)
        last_resize_start = time.monotonic()
        next_grow = time.monotonic() + grow_retry_s

    def _grow() -> None:
        nonlocal epoch, next_grow
        missing = sorted(set(range(world0)) - set(members)
                         - done_ranks)
        if not missing:
            return
        # A replacement can only join in lockstep by resharding from a
        # committed manifest; until one exists it would start at step
        # 0 while survivors are ahead, and the gang would never agree
        # on a step again.  Re-probe on the grow cadence.
        if latest_manifest_step(client, run_name) is None:
            next_grow = time.monotonic() + grow_retry_s
            return
        rank = missing[0]
        t0 = time.time()
        # The replacement's telemetry session charges its restore gap
        # to resize_recovery, not restart_recovery.
        w, ref = _spawn(rank, "resize_recovery")
        workers[rank] = w
        pending[ref] = rank
        members.append(rank)
        members.sort()
        epoch += 1
        step = latest_manifest_step(client, run_name)
        write_gang(client, run_name, epoch, members, step, notices)
        telemetry_mod.record_resize(
            client, run_name, "grow", len(members) - 1,
            len(members), step if step is not None else -1,
            dead_s=time.time() - t0)
        next_grow = time.monotonic() + grow_retry_s

    try:
        while pending:
            ready, _ = ray_tpu_torch.wait(
                list(pending), num_returns=len(pending),
                timeout=min(poll_s, 0.25))
            trainer._drain(report_ns, manager, history)
            if (straggler_check_s > 0
                    and time.time() >= next_straggler):
                next_straggler = time.time() + straggler_check_s
                trainer._check_stragglers(run_name)

            # Preemption storm: the chaos schedule delivers a notice
            # (deadline_s of grace, then a hard kill) to the HIGHEST
            # active rank — deterministic victim choice keeps the
            # seeded trace a replay witness.
            spec = chaos.fire_spec("train.worker", "preempt")
            if spec is not None and members:
                victim = max(members)
                if len(members) - 1 >= min_world:
                    grace = float(spec.get("deadline_s") or 0.0)
                    if grace > 0:
                        notices[str(victim)] = time.time() + grace
                        kill_at[victim] = time.monotonic() + grace
                        write_gang(client, run_name, epoch, members,
                                   None, notices)
                    else:
                        kill_at[victim] = time.monotonic()

            # Hard-kill noticed workers whose grace expired.
            for rank, due in list(kill_at.items()):
                if time.monotonic() >= due:
                    kill_at.pop(rank, None)
                    w = workers.get(rank)
                    if w is not None:
                        try:
                            ray_tpu_torch.kill(w)
                        except Exception:
                            pass

            for r in ready:
                rank = pending.pop(r)
                try:
                    tb = ray_tpu_torch.get(r)
                except (exc.ActorDiedError,
                        exc.WorkerCrashedError,
                        exc.ActorUnavailableError) as death:
                    if (rank in members
                            and len(members) - 1 >= min_world):
                        _shrink(rank)
                        continue
                    raise death
                if tb is not None:
                    raise exc.TaskError("train_loop_per_worker", tb)
                if str(rank) in notices or rank in kill_at:
                    # Graceful preempt exit: the worker saved a final
                    # shard and returned — a shrink, not a completion.
                    _shrink(rank)
                else:
                    done_ranks.add(rank)

            # Grow-back: capacity "heals" when the scheduler can place
            # a replacement; probe on a cadence after the last resize.
            if (set(range(world0)) - set(members) - done_ranks
                    and time.monotonic() >= next_grow
                    and next_grow > 0):
                _grow()

        trainer._drain(report_ns, manager, history)
        return history[-1] if history else {}
    except (exc.ActorDiedError, exc.WorkerCrashedError):
        trainer._drain(report_ns, manager, history)
        raise
    finally:
        for w in workers.values():
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        # Release the pinned shard blocks BEFORE killing the keeper:
        # a SIGKILLed keeper dumps no leak ledger and strands its
        # borrows until GC notices the dead process.
        try:
            ray_tpu_torch.get(keeper.stop.remote(), timeout=30)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(keeper)
        except Exception:
            pass
        cleanup_run(client, run_name)

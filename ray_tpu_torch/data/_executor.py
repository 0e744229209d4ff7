"""Streaming operator execution for Dataset.

Analog of the reference's StreamingExecutor
(data/_internal/execution/streaming_executor.py:48, scheduling loop
:222): the logical plan is a chain of operators; each operator streams
block refs from its upstream through a BOUNDED in-flight window
(concurrency-cap backpressure,
backpressure_policy/concurrency_cap_backpressure_policy.py) and yields
completed refs downstream.  Because operators are chained lazily, a
slow consumer stalls the whole pipeline — no unbounded buffering
anywhere.  Shuffle-family operators (sort/groupby/random_shuffle/
repartition) are stage breaks executed as distributed map-partition +
reduce tasks (data/_internal/planner/exchange), not driver-side
concats; actor-pool map runs UDFs on a pool of reusable actors
(execution/operators/actor_pool_map_operator.py).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import itertools

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B

MAX_IN_FLIGHT = 8


# ---------------------------------------------------------------------------
# remote kernels
# ---------------------------------------------------------------------------
def _apply_stages_local(block: B.Block, stages: List[Callable],
                        index: int = 0) -> B.Block:
    for stage in stages:
        # Stages tagged _wants_index receive the block's position in
        # the stream (e.g. random_sample decorrelates per-block RNG
        # streams positionally — content-identical blocks must not
        # share a keep mask).
        if getattr(stage, "_wants_index", False):
            outs = stage(block, index)
        else:
            outs = stage(block)
        block = B.block_concat(outs) if len(outs) != 1 else outs[0]
    return block


@ray_tpu_torch.remote
def _apply_stages(block: B.Block, stages: List[Callable],
                  index: int = 0) -> B.Block:
    return _apply_stages_local(block, stages, index)


@ray_tpu_torch.remote
def _read_source(read_fn) -> B.Block:
    return read_fn()


@ray_tpu_torch.remote
def _partition_block(block: B.Block, mode: str, P: int,
                     key: Optional[str], bounds, seed) -> List[B.Block]:
    """Map side of every shuffle: split one block into P partitions.
    mode: 'hash' (groupby) | 'range' (sort) | 'random' (shuffle) |
    'rr' (repartition round-robin)."""
    n = B.block_num_rows(block)
    if n == 0:
        return [B.block_slice(block, 0, 0) for _ in range(P)]
    if mode == "hash":
        col = np.asarray(block[key])
        if col.dtype.kind in "OUS":
            # Deterministic across worker processes — Python's hash()
            # is salted per interpreter and would scatter one key over
            # several partitions (silently wrong groupbys).  crc32 runs
            # per UNIQUE key, not per row: string columns are usually
            # low-cardinality and the python-loop hash was the dominant
            # cost of string groupbys.
            import zlib
            uniq, inv = np.unique(col, return_inverse=True)
            upart = np.asarray(
                [zlib.crc32(str(x).encode()) % P for x in uniq])
            part = upart[inv]
        else:
            part = (col.astype(np.int64, copy=False) % P + P) % P
    elif mode == "range":
        col = np.asarray(block[key])
        part = np.searchsorted(bounds, col, side="right")
    elif mode == "random":
        part = np.random.RandomState(seed).randint(0, P, size=n)
    elif mode == "rr":
        part = np.arange(n) % P
    else:
        raise ValueError(mode)
    return [B.block_take(block, np.nonzero(part == p)[0])
            for p in range(P)]


@ray_tpu_torch.remote
def _reduce_concat(*parts: B.Block) -> B.Block:
    return B.block_concat(list(parts))


@ray_tpu_torch.remote
def _reduce_sorted(key: str, descending: bool, *parts: B.Block
                   ) -> B.Block:
    whole = B.block_concat(list(parts))
    if not whole:                 # every shard empty for this partition
        return {}
    col = np.asarray(whole[key])
    order = np.argsort(col, kind="stable")
    if descending:
        order = order[::-1]
    return B.block_take(whole, order)


@ray_tpu_torch.remote
def _reduce_shuffled(seed, *parts: B.Block) -> B.Block:
    whole = B.block_concat(list(parts))
    n = B.block_num_rows(whole)
    if n == 0:
        return {}
    return B.block_take(whole, np.random.RandomState(seed).permutation(n))


def _arrow_grouped(table, key: str,
                   aggs: List[Tuple[str, str, str]]):
    """Arrow-native groupby: C++ hash aggregation (pa.TableGroupBy) —
    the columnar fast path that skips the numpy-object round-trip for
    string keys (reference: Arrow-block aggregations,
    data/_internal/arrow_block.py)."""
    import pyarrow.compute as pc
    spec, renames = [], {}
    for agg, c, out_name in aggs:
        if agg == "count":
            spec.append((key, "count"))
            renames[f"{key}_count"] = out_name
        elif agg == "std":
            # ddof=1 to match the numpy path / pandas default.
            spec.append((c, "stddev", pc.VarianceOptions(ddof=1)))
            renames[f"{c}_stddev"] = out_name
        else:
            spec.append((c, agg))
            renames[f"{c}_{agg}"] = out_name
    res = table.group_by(key).aggregate(spec)
    res = res.sort_by(key)      # numpy path emits sorted-unique keys
    cols = []
    names = []
    for name in res.column_names:
        col = res[name]
        out_name = renames.get(name, name)
        if name.endswith("_stddev"):
            # Singleton groups: arrow yields null, the numpy path 0.0.
            col = pc.fill_null(col, 0.0)
        names.append(out_name)
        cols.append(col)
    import pyarrow as pa
    return pa.table(cols, names=names)


@ray_tpu_torch.remote
def _reduce_grouped(key: str, aggs: List[Tuple[str, str, str]],
                    *parts: B.Block) -> B.Block:
    """Group one hash partition and compute aggregates.
    aggs: [(agg_name, column, out_name)]; every key lands in exactly
    one partition, so partition-local grouping is globally correct.
    Arrow-table partitions take the C++ hash-aggregation path."""
    whole = B.block_concat(list(parts))
    if not B.block_num_rows(whole):  # every shard empty
        return {}
    if B.is_arrow_block(whole):
        return _arrow_grouped(whole, key, aggs)
    col = np.asarray(whole[key])
    uniq, inv = np.unique(col, return_inverse=True)
    out: Dict[str, np.ndarray] = {key: uniq}
    counts = np.bincount(inv, minlength=len(uniq))
    for agg, c, out_name in aggs:
        if agg == "count":
            out[out_name] = counts
            continue
        vals = np.asarray(whole[c], dtype=np.float64)
        if agg == "sum":
            out[out_name] = np.bincount(inv, weights=vals,
                                        minlength=len(uniq))
        elif agg == "mean":
            s = np.bincount(inv, weights=vals, minlength=len(uniq))
            out[out_name] = s / np.maximum(counts, 1)
        elif agg in ("min", "max"):
            red = (np.minimum if agg == "min" else np.maximum)
            acc = np.full(len(uniq),
                          np.inf if agg == "min" else -np.inf)
            red.at(acc, inv, vals)
            out[out_name] = acc
        elif agg == "std":
            # Sample std (ddof=1), matching Ray Data / pandas defaults;
            # singleton groups get 0.
            s = np.bincount(inv, weights=vals, minlength=len(uniq))
            s2 = np.bincount(inv, weights=vals * vals,
                             minlength=len(uniq))
            mean = s / np.maximum(counts, 1)
            ss = np.maximum(s2 - counts * mean * mean, 0.0)
            out[out_name] = np.where(
                counts > 1, np.sqrt(ss / np.maximum(counts - 1, 1)),
                0.0)
        else:
            raise ValueError(f"unknown aggregate {agg!r}")
    return out


@ray_tpu_torch.remote
def _block_rows_of(block: B.Block) -> int:
    return B.block_num_rows(block)


@ray_tpu_torch.remote
def _slice_block(block: B.Block, start: int, end: int) -> B.Block:
    return B.block_slice(block, start, end)


@ray_tpu_torch.remote
def _reduce_group_mapped(key: str, fn, *parts: B.Block) -> B.Block:
    """Apply a user fn to each key-group of one hash partition
    (reference: grouped_data.py map_groups).  Every row of a key lives
    in exactly one partition, so per-partition grouping is globally
    correct.  fn: columnar group batch -> columnar batch (scalars are
    broadcast to length-1 columns)."""
    whole = [p for p in parts if p and B.block_num_rows(p)]
    if not whole:
        return {}
    blk = B.block_concat(whole)
    keys = np.asarray(blk[key])
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    boundaries = np.nonzero(keys_sorted[1:] != keys_sorted[:-1])[0] + 1
    out_blocks: list = []
    for ix in np.split(order, boundaries):
        # User map_groups fns receive the documented dict-of-numpy
        # batch regardless of the pipeline's block format.
        group = B.block_to_numpy(B.block_take(blk, ix))
        res = fn(group)
        out_blocks.append({
            k: (np.asarray(v) if np.ndim(v) else np.asarray([v]))
            for k, v in res.items()})
    return B.block_concat(out_blocks)


@ray_tpu_torch.remote
def _zip_blocks(left_refs, right_refs) -> B.Block:
    """Row-aligned column merge of two block lists (Dataset.zip).
    Duplicate right-side column names get a `_1` suffix."""
    left = B.block_concat([ray_tpu_torch.get(r) for r in left_refs])
    right = B.block_concat([ray_tpu_torch.get(r) for r in right_refs])
    ln, rn = B.block_num_rows(left), B.block_num_rows(right)
    if ln != rn:
        raise ValueError(f"zip() requires equal row counts "
                         f"({ln} vs {rn})")
    out = dict(left)
    for k, v in right.items():
        out[f"{k}_1" if k in out else k] = v
    return out


@ray_tpu_torch.remote
def _sample_column(block: B.Block, key: str, k: int) -> np.ndarray:
    col = np.asarray(block[key])
    if len(col) <= k:
        return col
    ix = np.random.RandomState(0).choice(len(col), size=k,
                                         replace=False)
    return col[ix]


class _MapActor:
    """Reusable UDF worker for actor-pool map (reference:
    actor_pool_map_operator; class UDFs construct once per actor)."""

    def __init__(self, fn_or_cls, fn_args: tuple, fn_kwargs: dict):
        if isinstance(fn_or_cls, type):
            self._fn = fn_or_cls(*fn_args, **(fn_kwargs or {}))
        else:
            self._fn = fn_or_cls

    def apply(self, block: B.Block, stages_before: List[Callable],
              index: int = 0) -> B.Block:
        block = _apply_stages_local(block, stages_before, index)
        out = self._fn(block)
        return out


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
class MemoryBudget:
    """Byte-budget backpressure state shared by one operator's stream
    (reference role: ResourceManager object-store budgeting +
    backpressure_policy/).  Tracks the mean size of COMPLETED blocks
    (sizes come from the node's object directory, no fetch) and turns
    the byte budget into an effective window size.  `peak_bytes` is
    observable for tests/ops dashboards."""

    def __init__(self, max_bytes: Optional[int]) -> None:
        self.max_bytes = max_bytes
        self._sized: Dict[bytes, int] = {}
        self.avg_block_bytes: float = 0.0
        self._n = 0
        self.peak_bytes = 0
        self.throttled = 0          # submissions deferred by the budget

    def observe(self, window: List[ray_tpu_torch.ObjectRef]) -> None:
        if self.max_bytes is None or not window:
            return
        unknown = [r for r in window if r.binary() not in self._sized]
        if unknown:
            try:
                client = ray_tpu_torch._ensure_connected()
                for r, s in zip(unknown, client.object_sizes(unknown)):
                    if s:
                        self._sized[r.binary()] = s
                        self._n += 1
                        self.avg_block_bytes += (
                            s - self.avg_block_bytes) / self._n
            except Exception:
                return
        held = sum(self._sized.get(r.binary(), 0) for r in window)
        self.peak_bytes = max(self.peak_bytes, held)

    def effective_cap(self, cap: int) -> int:
        if self.max_bytes is None:
            return cap
        if self.avg_block_bytes <= 0:
            # Cold start: no completed block has told us sizes yet.
            # Ramp conservatively so one window of surprise-fat blocks
            # can't blow the budget; the window widens as soon as the
            # first (fast, small) completions prove blocks are skinny.
            return min(cap, 2)
        by_bytes = max(int(self.max_bytes // self.avg_block_bytes), 1)
        return min(cap, by_bytes)

    def note_deferred(self) -> None:
        """A submission was actually held back by the byte cap (the
        count cap alone would have admitted it)."""
        self.throttled += 1

    def refill(self, window: List[ray_tpu_torch.ObjectRef], up,
               submit: Callable[[ray_tpu_torch.ObjectRef], None],
               cap: int) -> tuple:
        """Shared refill stanza: observe sizes, top the window up to
        the byte-limited cap, account real deferrals.  Returns
        (exhausted, effective_cap) — effective_cap < cap tells callers
        the BYTE budget (not capacity) is the current limiter."""
        self.observe(window)
        ecap = self.effective_cap(cap)
        exhausted = False
        while len(window) < ecap:
            try:
                ref = next(up)
            except StopIteration:
                exhausted = True
                break
            submit(ref)
        if not exhausted and self.avg_block_bytes > 0 \
                and ecap <= len(window) < cap:
            self.note_deferred()
        return exhausted, ecap

    def forget(self, ref: ray_tpu_torch.ObjectRef) -> None:
        self._sized.pop(ref.binary(), None)


def _windowed(upstream: Iterator[ray_tpu_torch.ObjectRef],
              submit: Callable[[ray_tpu_torch.ObjectRef], ray_tpu_torch.ObjectRef],
              cap: int, preserve_order: bool,
              budget: Optional[MemoryBudget] = None,
              stats=None) -> Iterator[ray_tpu_torch.ObjectRef]:
    """Shared operator inner loop: keep up to `cap` submitted refs in
    flight (concurrency-cap backpressure), shrunk further so in-flight
    block BYTES stay under the DataContext budget (byte backpressure),
    yielding in submission order or whichever completes first.
    `stats` (data/_stats.OpStats) observes submissions/completions."""
    from ray_tpu_torch.data.context import DataContext
    if budget is None:
        budget = MemoryBudget(
            DataContext.get_current().max_bytes_in_flight)
    window: List[ray_tpu_torch.ObjectRef] = []
    up = iter(upstream)
    exhausted = False

    def _submit(ref) -> None:
        window.append(submit(ref))
        if stats is not None:
            stats.on_submit(len(window))

    while not exhausted or window:
        if not exhausted:
            exhausted, _ = budget.refill(window, up, _submit, cap)
        if not window:
            continue
        if preserve_order:
            got = window.pop(0)
        else:
            ready, _ = ray_tpu_torch.wait(window, num_returns=1,
                                    timeout=None)
            window.remove(ready[0])
            got = ready[0]
        budget.observe([got])
        size = budget._sized.get(got.binary())
        budget.forget(got)
        if stats is not None:
            # Only probe the directory for a size when byte
            # backpressure is on (documented contract; avoids a per-
            # block RPC on budget-disabled pipelines).
            stats.on_complete(
                size, len(window),
                ref=got if budget.max_bytes is not None else None)
        yield got


class FusedMapOp:
    """Chained per-block transforms fused into ONE task per block
    (reference: operator fusion, logical/rules/operator_fusion.py)."""

    def __init__(self, stages: Optional[List[Callable]] = None) -> None:
        self.stages = list(stages or [])
        self.last_budget: Optional[MemoryBudget] = None  # observable
        self._stats = None          # OpStats, set by the pipeline

    def stream(self, upstream: Iterator[ray_tpu_torch.ObjectRef],
               preserve_order: bool = True
               ) -> Iterator[ray_tpu_torch.ObjectRef]:
        if not self.stages:
            yield from upstream
            return
        from ray_tpu_torch.data.context import DataContext
        ctx = DataContext.get_current()
        self.last_budget = MemoryBudget(ctx.max_bytes_in_flight)
        counter = itertools.count()
        yield from _windowed(
            upstream,
            lambda ref: _apply_stages.remote(ref, self.stages,
                                             next(counter)),
            min(MAX_IN_FLIGHT, ctx.max_blocks_in_flight),
            preserve_order, self.last_budget, stats=self._stats)


class ActorPoolMapOp:
    """map_batches(compute='actors'): blocks run on a pool of actors —
    stateful/expensive UDF setup happens once per actor, not once per
    block.  `size` may be an int (fixed pool) or (min, max): the pool
    then AUTOSCALES on backlog — a saturated window that makes no
    progress for `scale_up_after_s` grows the pool; sustained instant
    completions shrink it back toward min (reference:
    data/_internal/execution/autoscaler/default_autoscaler.py)."""

    def __init__(self, fn_or_cls, size=1,
                 fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                 num_cpus: float = 1.0,
                 stages_before: Optional[List[Callable]] = None,
                 scale_up_after_s: float = 0.5) -> None:
        self.fn_or_cls = fn_or_cls
        if isinstance(size, (tuple, list)):
            self.min_size = max(int(size[0]), 1)
            self.max_size = max(int(size[1]), self.min_size)
        else:
            self.min_size = self.max_size = max(int(size), 1)
        self.fn_args = fn_args
        self.fn_kwargs = fn_kwargs or {}
        self.num_cpus = num_cpus
        self.stages_before = list(stages_before or [])
        self.scale_up_after_s = scale_up_after_s
        # Observable pool size (peak within the last stream()).
        self.current_size = 0
        self.peak_size = 0
        self.last_budget: Optional[MemoryBudget] = None
        self._stats = None          # OpStats, set by the pipeline

    def stream(self, upstream: Iterator[ray_tpu_torch.ObjectRef],
               preserve_order: bool = True
               ) -> Iterator[ray_tpu_torch.ObjectRef]:
        from ray_tpu_torch.data.context import DataContext
        budget = MemoryBudget(
            DataContext.get_current().max_bytes_in_flight)
        self.last_budget = budget
        cls = ray_tpu_torch.remote(_MapActor)
        actors: List[Any] = []

        def spawn() -> None:
            actors.append(cls.options(num_cpus=self.num_cpus).remote(
                self.fn_or_cls, self.fn_args, self.fn_kwargs))
            self.current_size = len(actors)
            self.peak_size = max(self.peak_size, len(actors))

        for _ in range(self.min_size):
            spawn()
        counter = [0]
        window: List[ray_tpu_torch.ObjectRef] = []
        owner: dict = {}              # result ref id -> actor
        up = iter(upstream)
        exhausted = False
        fast_completions = 0

        def submit(ref) -> None:
            actor = actors[counter[0] % len(actors)]
            # counter doubles as the block's stream index for
            # _wants_index stages (random_sample decorrelation).
            out = actor.apply.remote(ref, self.stages_before,
                                     counter[0])
            counter[0] += 1
            owner[out.binary()] = actor
            window.append(out)
            if self._stats is not None:
                self._stats.on_submit(len(window))

        try:
            ecap = 2 * len(actors)
            while not exhausted or window:
                cap = 2 * len(actors)
                if not exhausted:
                    exhausted, ecap = budget.refill(window, up, submit,
                                                    cap)
                if not window:
                    continue
                targets = [window[0]] if preserve_order else window
                # Instant-readiness probe FIRST: only completions that
                # were already done when we looked count as "fast" for
                # the downscale heuristic.
                ready, _ = ray_tpu_torch.wait(targets, num_returns=1,
                                        timeout=0)
                if ready:
                    fast_completions += 1
                else:
                    fast_completions = 0
                    ready, _ = ray_tpu_torch.wait(
                        targets, num_returns=1,
                        timeout=self.scale_up_after_s)
                if not ready:
                    # Saturated and stalled: add an actor (helps the
                    # blocks still waiting in the upstream) — but only
                    # when CAPACITY is the limiter; a byte-capped
                    # window (ecap < cap) can't feed more actors, so
                    # growing the pool would just park idle actors on
                    # reserved CPUs.
                    if (len(actors) < self.max_size
                            and not exhausted and ecap >= cap):
                        spawn()
                    continue
                if preserve_order:
                    got = window.pop(0)
                else:
                    window.remove(ready[0])
                    got = ready[0]
                owner.pop(got.binary(), None)
                budget.observe([got])
                size = budget._sized.get(got.binary())
                budget.forget(got)
                if self._stats is not None:
                    self._stats.on_complete(
                        size, len(window),
                        ref=got if budget.max_bytes is not None
                        else None)
                yield got
                # Sustained instant completions: the pool is oversized;
                # retire an actor that owns none of the in-flight work.
                if (fast_completions >= 4 * len(actors)
                        and len(actors) > self.min_size):
                    busy = {id(a) for a in owner.values()}
                    for idx in range(len(actors) - 1, -1, -1):
                        if id(actors[idx]) not in busy:
                            victim = actors.pop(idx)
                            self.current_size = len(actors)
                            fast_completions = 0
                            try:
                                ray_tpu_torch.kill(victim)
                            except Exception:
                                pass
                            break
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


class ShuffleOp:
    """Stage break: all-to-all exchange as distributed map-partition +
    reduce tasks (reference: planner/exchange push-based shuffle).
    kind: 'random' | 'sort' | 'groupby' | 'repartition'."""

    def __init__(self, kind: str, num_partitions: Optional[int] = None,
                 key: Optional[str] = None, descending: bool = False,
                 seed: Optional[int] = None,
                 aggs: Optional[List[Tuple[str, str, str]]] = None,
                 group_fn=None) -> None:
        self.kind = kind
        self.P = num_partitions
        self.key = key
        self.descending = descending
        self.seed = seed          # None => fresh randomness per run
        self.aggs = aggs or []
        self.group_fn = group_fn  # kind="groupmap": per-group batch fn
        self._stats = None        # OpStats, set by the pipeline

    def stream(self, upstream: Iterator[ray_tpu_torch.ObjectRef],
               preserve_order: bool = True
               ) -> Iterator[ray_tpu_torch.ObjectRef]:
        if self._stats is not None:
            self._stats.on_start()
        inputs = list(upstream)          # stage break: need all blocks
        if not inputs:
            return
        P = self.P or len(inputs)
        # seed=None means random per EXECUTION (an unseeded shuffle must
        # differ between epochs), drawn here so map+reduce agree.
        import random as _random
        seed = (self.seed if self.seed is not None
                else _random.randrange(1 << 31))
        bounds = None
        if self.kind == "sort":
            # Sample-based range boundaries (reference: sort sampling).
            samples = ray_tpu_torch.get(
                [_sample_column.remote(r, self.key, 64) for r in inputs])
            nonempty = [s for s in samples if len(s)]
            if not nonempty:          # every block empty: one partition
                bounds = np.array([])
            else:
                allv = np.sort(np.concatenate(nonempty))
                ix = (np.arange(1, P) * len(allv)) // P
                bounds = allv[np.minimum(ix, len(allv) - 1)]
        mode = {"random": "random", "sort": "range",
                "groupby": "hash", "groupmap": "hash",
                "repartition": "rr"}[self.kind]
        if P == 1:
            # Single output partition: no exchange needed — every input
            # block IS that partition's shard.
            parts = [[ref] for ref in inputs]
        else:
            parts = [
                _partition_block.options(num_returns=P).remote(
                    ref, mode, P, self.key, bounds,
                    (seed + i) & 0x7FFFFFFF)
                for i, ref in enumerate(inputs)
            ]
        # Range partitions are ascending; a descending sort must emit
        # them in reverse so the concatenation is globally ordered.
        order = (reversed(range(P))
                 if self.kind == "sort" and self.descending
                 else range(P))
        for p in order:
            shard = [m[p] for m in parts]
            if self.kind == "sort":
                out = _reduce_sorted.remote(self.key, self.descending,
                                            *shard)
            elif self.kind == "random":
                out = _reduce_shuffled.remote(
                    (seed + p) & 0x7FFFFFFF, *shard)
            elif self.kind == "groupby":
                out = _reduce_grouped.remote(self.key, self.aggs,
                                             *shard)
            elif self.kind == "groupmap":
                out = _reduce_group_mapped.remote(self.key,
                                                  self.group_fn,
                                                  *shard)
            else:
                out = _reduce_concat.remote(*shard)
            if self._stats is not None:
                # Stage break: reduce refs hand off downstream
                # immediately; depth tracks un-pulled partitions.
                self._stats.on_submit(1)
                self._stats.on_complete(None, 0)
            yield out


@ray_tpu_torch.remote
def _reduce_join(key: str, n_left: int, *parts: B.Block) -> B.Block:
    """Inner hash-join of one partition: the first n_left blocks are the
    left side's shards, the rest the right's (reference:
    data/grouped_data.py join exchange).  Overlapping non-key right
    columns get a `_right` suffix."""
    left = B.block_to_numpy(B.block_concat(list(parts[:n_left])))
    right = B.block_to_numpy(B.block_concat(list(parts[n_left:])))
    if not left or not right:
        return {}
    lk = np.asarray(left[key])
    rk = np.asarray(right[key])
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(lk)), counts)
    if len(li) == 0:
        return {}
    ri = order[np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi) if b > a])]
    out = {c: np.asarray(v)[li] for c, v in left.items()}
    for c, v in right.items():
        if c == key:
            continue
        out[f"{c}_right" if c in out else c] = np.asarray(v)[ri]
    return out


class JoinOp:
    """Stage break: distributed inner hash-join against a second
    dataset (reference: join exchange in data/grouped_data.py).  Left
    side streams in from upstream (stage-break collect, same as every
    shuffle); the right side materializes at execution time.  Reduce
    refs yield lazily, so downstream pull provides the backpressure."""

    def __init__(self, right_ds, on: str,
                 num_partitions: Optional[int] = None) -> None:
        self.right_ds = right_ds
        self.on = on
        self.P = num_partitions
        self._stats = None          # OpStats, set by the pipeline

    def stream(self, upstream: Iterator[ray_tpu_torch.ObjectRef],
               preserve_order: bool = True
               ) -> Iterator[ray_tpu_torch.ObjectRef]:
        if self._stats is not None:
            self._stats.on_start()
        left = list(upstream)
        right = self.right_ds._block_refs()
        if not left or not right:
            return
        P = self.P or max(len(left), len(right))
        if P == 1:
            lparts = [[r] for r in left]
            rparts = [[r] for r in right]
        else:
            lparts = [_partition_block.options(num_returns=P).remote(
                r, "hash", P, self.on, None, 0) for r in left]
            rparts = [_partition_block.options(num_returns=P).remote(
                r, "hash", P, self.on, None, 0) for r in right]
        for p in range(P):
            lshard = [m[p] for m in lparts]
            rshard = [m[p] for m in rparts]
            out = _reduce_join.remote(self.on, len(lshard),
                                      *lshard, *rshard)
            if self._stats is not None:
                self._stats.on_submit(1)
                self._stats.on_complete(None, 0)
            yield out


@ray_tpu_torch.remote
def _write_block(block: B.Block, path: str, fmt: str,
                 index: int) -> str:
    """Write one block as `part-{index}` under `path` through the
    filesystem layer (reference: per-block write tasks in
    data/datasource/ writers).  Runs where the block lives."""
    from ray_tpu_torch.data.filesystem import open_file
    sep = "" if path.endswith("/") else "/"
    ext = {"parquet": "parquet", "csv": "csv", "json": "jsonl"}[fmt]
    out = f"{path}{sep}part-{index:05d}.{ext}"
    table = B.block_to_arrow(block)
    if fmt == "parquet":
        import pyarrow.parquet as pq
        with open_file(out, "wb") as f:
            pq.write_table(table, f)
    elif fmt == "csv":
        import pyarrow.csv as pacsv
        with open_file(out, "wb") as f:
            pacsv.write_csv(table, f)
    else:
        import json as _json
        with open_file(out, "wb") as f:
            for row in B.block_rows(block):
                f.write(_json.dumps(
                    {k: (v.item() if hasattr(v, "item") else v)
                     for k, v in row.items()}).encode() + b"\n")
    return out

"""Dataset: lazy, distributed, streaming-executed column datasets.

Analog of the reference's Ray Data Dataset (data/dataset.py:141): a lazy
logical plan over blocks (stored as ObjectRefs in the shm store),
executed by a streaming pull loop that keeps a bounded number of block
tasks in flight (the round-1 stand-in for the reference's
StreamingExecutor, _internal/execution/streaming_executor.py:48, with
concurrency-cap backpressure).  Chained row/batch transforms are FUSED
into one task per block (reference: operator fusion in
_internal/logical/rules/operator_fusion.py).

GPU addition: `iter_device_batches` pipelines host->card copies with
double buffering through pinned staging buffers and a side CUDA stream
(data/_device.py; the input-pipeline role the reference leaves to
torch DataLoader).

pyarrow, pandas and PIL are optional: the package imports without
them, and only the calls that need one (the parquet/CSV/JSON readers
and writers, Arrow and pandas conversion, read_images) raise an
ImportError naming it.
"""

from __future__ import annotations

import glob as globlib
import importlib
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import _executor as X
from ray_tpu_torch.data._executor import _read_source

Batch = Dict[str, np.ndarray]

_DEFAULT_BLOCK_ROWS = 4096


def _require(pkg: str, what: str) -> None:
    """Raise an ImportError naming `pkg` when the optional package is
    missing, before any task is submitted."""
    try:
        importlib.import_module(pkg)
    except ImportError as e:
        raise ImportError(
            f"{what} needs the optional package {pkg!r}, which is not "
            f"installed") from e


def _ctx_block_rows() -> int:
    from ray_tpu_torch.data.context import DataContext
    return DataContext.get_current().block_rows or _DEFAULT_BLOCK_ROWS


# Block-transform stages are plain functions Block -> List[Block]
# (list so filter/flat ops can drop/split).
Stage = Callable[[B.Block], List[B.Block]]


def _coerce_stage(batch_format: Optional[str]) -> List[Stage]:
    """Stage list converting each block into the form map_batches' fn
    receives: "numpy" a dict of numpy arrays, "pyarrow" an Arrow
    Table, None the pipeline's native block unconverted."""
    if batch_format is None:
        return []
    if batch_format == "numpy":
        return [lambda b: [B.block_to_numpy(b)]]
    if batch_format == "pyarrow":
        return [lambda b: [B.block_to_arrow(b)]]
    raise ValueError(f"unknown batch_format {batch_format!r}")


class Dataset:
    """Lazy dataset = input block sources + an operator plan.

    The plan is a chain of streaming operators (fused per-block maps,
    actor-pool maps, shuffle stage breaks) executed by pull with
    bounded per-operator in-flight windows — see data/_executor.py."""

    def __init__(self, sources: List[Any], stages_or_plan=None,
                 materialized: Optional[List[ray_tpu_torch.ObjectRef]] = None):
        # sources: list of either ObjectRef (ready block) or zero-arg
        # callables (deferred reads, executed as tasks).
        self._sources = sources
        plan = list(stages_or_plan or [])
        if plan and not hasattr(plan[0], "stream"):
            plan = [X.FusedMapOp(plan)]      # legacy: raw stage list
        self._plan: List[Any] = plan
        self._materialized = materialized

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_items(items: Sequence[Any],
                   block_rows: Optional[int] = None) -> "Dataset":
        block_rows = block_rows or _ctx_block_rows()
        refs = []
        for i in range(0, len(items), block_rows):
            refs.append(ray_tpu_torch.put(
                B.block_from_items(items[i:i + block_rows])))
        return Dataset(refs, [])

    @staticmethod
    def range(n: int, block_rows: Optional[int] = None) -> "Dataset":
        block_rows = block_rows or _ctx_block_rows()
        refs = []
        for i in range(0, n, block_rows):
            hi = min(i + block_rows, n)
            refs.append(ray_tpu_torch.put({"id": np.arange(i, hi)}))
        return Dataset(refs, [])

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray],
                   block_rows: Optional[int] = None) -> "Dataset":
        block_rows = block_rows or _ctx_block_rows()
        n = len(next(iter(arrays.values())))
        refs = []
        for i in range(0, n, block_rows):
            refs.append(ray_tpu_torch.put(
                {k: v[i:i + block_rows] for k, v in arrays.items()}))
        return Dataset(refs, [])

    @staticmethod
    def from_pandas(df, block_rows: Optional[int] = None) -> "Dataset":
        return Dataset.from_numpy(B.block_from_pandas(df), block_rows)

    @staticmethod
    def read_parquet(paths: Union[str, List[str]]) -> "Dataset":
        """One block per file; paths may be local, globs, dirs, or any
        fsspec URI (memory://, s3://, gs://, ... — reference:
        data/read_api.py over pyarrow/fsspec filesystems)."""
        _require("pyarrow", "read_parquet")
        files = _expand_paths(paths, (".parquet",))

        from ray_tpu_torch.data.context import DataContext
        fmt = DataContext.get_current().block_format

        def make_reader(path):
            def read():
                import pyarrow.parquet as pq
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    t = pq.read_table(f)
                return t if fmt == "arrow" else B.block_from_arrow(t)
            return read

        return Dataset([make_reader(f) for f in files], [])

    @staticmethod
    def read_csv(paths: Union[str, List[str]]) -> "Dataset":
        _require("pyarrow", "read_csv")
        files = _expand_paths(paths, (".csv",))

        from ray_tpu_torch.data.context import DataContext
        fmt = DataContext.get_current().block_format

        def make_reader(path):
            def read():
                import pyarrow.csv as pacsv
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    t = pacsv.read_csv(f)
                return t if fmt == "arrow" else B.block_from_arrow(t)
            return read

        return Dataset([make_reader(f) for f in files], [])

    @staticmethod
    def read_json(paths: Union[str, List[str]]) -> "Dataset":
        _require("pyarrow", "read_json")
        files = _expand_paths(paths, (".json", ".jsonl"))

        def make_reader(path):
            def read():
                import pyarrow.json as pajson
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    return B.block_from_arrow(pajson.read_json(f))
            return read

        return Dataset([make_reader(f) for f in files], [])

    @staticmethod
    def read_text(paths: Union[str, List[str]],
                  encoding: str = "utf-8") -> "Dataset":
        """One row per line, column `text` (reference: read_text,
        data/read_api.py)."""
        files = _expand_paths(paths, (".txt", ".text", ".log"))

        def make_reader(path):
            def read():
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    lines = f.read().decode(encoding).splitlines()
                return {"text": np.asarray(lines, dtype=object)}
            return read

        return Dataset([make_reader(f) for f in files], [])

    @staticmethod
    def read_binary_files(paths: Union[str, List[str]],
                          include_paths: bool = False) -> "Dataset":
        """One row per file, column `bytes` (reference:
        read_binary_files, data/read_api.py) — the raw-ingest path for
        formats with no dedicated reader (audio, pickles, ...)."""
        files = _expand_paths(paths, None)

        def make_reader(path):
            def read():
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    blob = f.read()
                col = np.empty(1, dtype=object)
                col[0] = blob
                out = {"bytes": col}
                if include_paths:
                    out["path"] = np.asarray([path])
                return out
            return read

        return Dataset([make_reader(f) for f in files], [])

    @staticmethod
    def read_sql(sql: str, connection_factory,
                 rows_per_block: int = 4096) -> "Dataset":
        """Execute a DBAPI query into a dataset (reference: read_sql,
        data/read_api.py:523-class readers).  `connection_factory` is a
        zero-arg callable returning a DBAPI connection (e.g.
        `lambda: sqlite3.connect(path)`) — it runs INSIDE the read
        task, so the connection itself never pickles.

        The query executes EXACTLY ONCE, in one read task: SQL result
        order is not stable across executions (parallel scans, missing
        ORDER BY) and the data may change between runs, so offset-based
        multi-task splits silently duplicate/drop rows.  The single
        result is materialized as rows_per_block-sized blocks via an
        eager split after the fetch; `.repartition(n)` redistributes
        if downstream parallelism matters more than ingest locality."""
        def read():
            conn = connection_factory()
            try:
                cur = conn.cursor()
                cur.execute(sql)
                cols = ([d[0] for d in cur.description]
                        if cur.description else [])
                rows: List[tuple] = []
                while True:
                    chunk = cur.fetchmany(rows_per_block)
                    if not chunk:
                        break
                    rows.extend(chunk)
            finally:
                conn.close()
            if not rows:
                return {}
            arrs = list(zip(*rows))
            return {c: np.asarray(a) for c, a in zip(cols, arrs)}

        ds = Dataset([read], [])
        # Eager one-pass split so num_blocks reflects rows_per_block.
        whole = ds._block_refs()
        import ray_tpu_torch as _rt
        from ray_tpu_torch.data import _executor as _X
        counts = _rt.get([_X._block_rows_of.remote(r) for r in whole])
        out: List[Any] = []
        for ref, n in zip(whole, counts):
            if n <= rows_per_block:
                out.append(ref)
            else:
                out.extend(_X._slice_block.remote(
                    ref, s, min(s + rows_per_block, n))
                    for s in range(0, n, rows_per_block))
        return Dataset([], [], materialized=out)

    @staticmethod
    def read_images(paths: Union[str, List[str]],
                    size: Optional[Tuple[int, int]] = None,
                    mode: Optional[str] = None,
                    include_paths: bool = False,
                    files_per_block: Optional[int] = None) -> "Dataset":
        """Decode an image directory/glob into blocks (reference:
        read_images, data/read_api.py:775 over ImageDatasource).

        `size=(h, w)` resizes at decode time; with BOTH size and mode
        set the `image` column is one dense [N, h, w, C] uint8 tensor
        (the device input-pipeline shape) — mode pins the channel count,
        so every block of the dataset has the same representation.
        Without both, rows are per-image arrays (object column).
        `mode` is a PIL conversion ("RGB", "L", ...).
        """
        _require("PIL", "read_images")
        from ray_tpu_torch.data.context import DataContext
        files = _expand_paths(
            paths, (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"))
        per = files_per_block or DataContext.get_current().\
            images_per_block

        def make_reader(chunk):
            def read():
                from PIL import Image
                from ray_tpu_torch.data.filesystem import open_file
                imgs, kept = [], []
                for p in chunk:
                    with open_file(p, "rb") as f:
                        im = Image.open(f)
                        im.load()
                    if mode:
                        im = im.convert(mode)
                    if size is not None:
                        im = im.resize((size[1], size[0]))
                    imgs.append(np.asarray(im))
                    kept.append(p)
                # Dense iff size AND mode are both pinned: the decision
                # must be DATASET-level (mode fixes channels), or two
                # blocks of one dataset could disagree on the column
                # representation and break cross-block concatenation.
                if size is not None and mode is not None:
                    col = np.stack(imgs) if imgs else \
                        np.zeros((0,) + tuple(size), np.uint8)
                else:
                    col = np.empty(len(imgs), dtype=object)
                    for i, im in enumerate(imgs):
                        col[i] = im
                out = {"image": col}
                if include_paths:
                    out["path"] = np.asarray(kept)
                return out
            return read

        chunks = [files[i:i + per] for i in range(0, len(files), per)]
        return Dataset([make_reader(c) for c in chunks], [])

    @staticmethod
    def read_tfrecords(paths: Union[str, List[str]]) -> "Dataset":
        """Read TFRecord files of tf.train.Example protos (reference:
        read_tfrecords, data/read_api.py).  The record framing
        (length + crc) and the Example wire format are parsed natively
        — no tensorflow dependency; bytes/int64/float features become
        columns (scalar features unwrap, fixed-width lists become 2-D
        columns, ragged ones object arrays)."""
        files = _expand_paths(paths, (".tfrecord", ".tfrecords"))

        def make_reader(path):
            def read():
                from ray_tpu_torch.data import tfrecords as T
                from ray_tpu_torch.data.filesystem import open_file
                with open_file(path, "rb") as f:
                    return T.examples_to_block(
                        T.parse_example(rec)
                        for rec in T.read_records(f))
            return read

        return Dataset([make_reader(f) for f in files], [])

    # ------------------------------------------------------------------
    # transforms (lazy, fused per block)
    # ------------------------------------------------------------------
    def _with_stage(self, stage: Stage) -> "Dataset":
        """Append a per-block transform, FUSING into the trailing map
        operator when possible (one task per block regardless of chain
        length — reference: operator fusion)."""
        plan = list(self._plan)
        if plan and isinstance(plan[-1], X.FusedMapOp):
            plan[-1] = X.FusedMapOp(plan[-1].stages + [stage])
        else:
            plan.append(X.FusedMapOp([stage]))
        return Dataset(self._sources, plan, self._materialized)

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._sources, self._plan + [op],
                       self._materialized)

    def map_batches(self, fn, *, compute: str = "tasks",
                    concurrency: Union[int, Tuple[int, int]] = 2,
                    num_cpus: float = 1.0,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    batch_format: Optional[str] = "numpy"
                    ) -> "Dataset":
        """Per-block batch transform.  compute='actors' (or a class fn)
        runs on a reusable actor pool: stateful/expensive setup happens
        once per actor (reference: actor_pool_map_operator.py).
        `concurrency` may be (min, max) for an autoscaling pool that
        grows on backlog and shrinks when oversized (reference:
        execution/autoscaler/default_autoscaler.py).

        `batch_format` is what `fn` RECEIVES (reference:
        map_batches(batch_format=...)): "numpy" (default) a dict of
        numpy arrays, "pyarrow" an Arrow Table, None the pipeline's
        native block unconverted.  fn may return either format."""
        coerce = _coerce_stage(batch_format)
        if compute == "actors" or isinstance(fn, type):
            # Fold any pending fused stages into the actor op so the
            # pool applies them in the same task.
            plan = list(self._plan)
            before: List[Stage] = []
            if plan and isinstance(plan[-1], X.FusedMapOp):
                before = plan.pop().stages
            plan.append(X.ActorPoolMapOp(
                fn, concurrency, fn_constructor_args,
                fn_constructor_kwargs, num_cpus, before + coerce))
            return Dataset(self._sources, plan, self._materialized)
        if coerce:
            conv = coerce[0]
            return self._with_stage(lambda b: [fn(conv(b)[0])])
        return self._with_stage(lambda b: [fn(b)])

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]
            ) -> "Dataset":
        def stage(b: B.Block) -> List[B.Block]:
            return [B.block_from_rows([fn(r) for r in B.block_rows(b)])]
        return self._with_stage(stage)

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        def stage(b: B.Block) -> List[B.Block]:
            keep = np.asarray([bool(fn(r)) for r in B.block_rows(b)])
            return [B.block_take(b, np.nonzero(keep)[0])]
        return self._with_stage(stage)

    def flat_map(self, fn: Callable[[Dict[str, Any]],
                                    List[Dict[str, Any]]]) -> "Dataset":
        """Row -> list of rows (reference: Dataset.flat_map)."""
        def stage(b: B.Block) -> List[B.Block]:
            rows: List[Dict[str, Any]] = []
            for r in B.block_rows(b):
                rows.extend(fn(r))
            return [B.block_from_rows(rows)]
        return self._with_stage(stage)

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample).
        Unseeded sampling differs per execution, like random_shuffle."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")

        def stage(b: B.Block, index: int) -> List[B.Block]:
            import os as _os
            n = B.block_num_rows(b)
            if seed is None:
                # Fresh entropy per task => different sample every
                # execution of the same lazy dataset (epoch semantics,
                # like an unseeded random_shuffle).
                rng = np.random.RandomState(
                    int.from_bytes(_os.urandom(4), "little") &
                    0x7FFFFFFF)
            else:
                # Positional per-block stream: content-identical
                # blocks must not share a keep mask (the executor
                # passes each block's stream index to _wants_index
                # stages).
                rng = np.random.RandomState(
                    (seed + index * 2654435761) & 0x7FFFFFFF)
            keep = rng.random_sample(n) < fraction
            return [B.block_take(b, np.nonzero(keep)[0])]
        stage._wants_index = True
        return self._with_stage(stage)

    def add_column(self, name: str,
                   fn: Callable[[Batch], np.ndarray]) -> "Dataset":
        def stage(b: B.Block) -> List[B.Block]:
            out = dict(b)
            out[name] = np.asarray(fn(b))
            return [out]
        return self._with_stage(stage)

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._with_stage(
            lambda b: [{k: b[k] for k in cols}])

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        """Rename columns (reference: Dataset.rename_columns)."""
        def stage(b: B.Block) -> List[B.Block]:
            out = {}
            for k, v in b.items():
                nk = mapping.get(k, k)
                if nk in out:
                    raise ValueError(
                        f"rename_columns collision: two columns map "
                        f"to {nk!r}")
                out[nk] = v
            return [out]
        return self._with_stage(stage)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference: Dataset.unique).
        Projects to the one column before shipping blocks to the
        driver; a missing column raises (empty shuffle-reducer blocks
        are tolerated)."""
        def project(b: B.Block) -> List[B.Block]:
            if not b:
                return [b]          # empty reducer partition
            if column not in b:
                raise KeyError(
                    f"no column {column!r} (have {sorted(b)})")
            return [{column: np.unique(b[column])}]

        seen: set = set()
        for blk in self._with_stage(project)._iter_blocks():
            if column in blk:
                seen.update(blk[column].tolist())
        return sorted(seen)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._with_stage(
            lambda b: [{k: v for k, v in b.items() if k not in cols}])

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _source_ref_iter(self) -> Iterator[ray_tpu_torch.ObjectRef]:
        """Stream source blocks as refs (reads become tasks lazily,
        bounded by the first operator's window)."""
        if self._materialized is not None:
            yield from self._materialized
            return
        for src in self._sources:
            yield _read_source.remote(src) if callable(src) else src

    def _iter_block_refs(self, preserve_order: bool = True
                         ) -> Iterator[ray_tpu_torch.ObjectRef]:
        """Chain every operator's streaming window over the sources —
        the whole pipeline advances by downstream pull (backpressure by
        laziness + per-op in-flight caps).  Each execution builds a
        fresh PipelineStats; per-op counters surface via stats() and
        util.metrics (reference: data/_internal/stats.py)."""
        from ray_tpu_torch.data._stats import OpStats, PipelineStats

        it: Iterator[ray_tpu_torch.ObjectRef] = self._source_ref_iter()
        if not self._plan:
            # No operator window pulls ahead of the consumer — wrap the
            # sources in a pass-through window so read tasks stay
            # submitted MAX_IN_FLIGHT deep instead of one at a time.
            ps = PipelineStats(["Read"])
            self._pipeline_stats = ps
            return X._windowed(it, lambda ref: ref, X.MAX_IN_FLIGHT,
                               preserve_order, stats=ps.ops[0])
        ps = PipelineStats([type(op).__name__ for op in self._plan])
        self._pipeline_stats = ps
        for op, ost in zip(self._plan, ps.ops):
            op._stats = ost
            it = op.stream(it, preserve_order=preserve_order)
        return it

    def _block_refs(self) -> List[ray_tpu_torch.ObjectRef]:
        return list(self._iter_block_refs())

    def _iter_blocks(self, preserve_order: bool = True
                     ) -> Iterator[B.Block]:
        """Streaming pull.  preserve_order=False yields whichever block
        finishes first (no head-of-line blocking on a slow block).
        Records execution stats for `stats()`."""
        import time as _time
        t0 = _time.perf_counter()
        st = {"blocks": 0, "rows": 0, "bytes": 0, "wall_s": 0.0,
              "plan": " -> ".join(type(op).__name__
                                  for op in self._plan) or "<read>"}
        self._last_stats = st
        for ref in self._iter_block_refs(preserve_order):
            blk = ray_tpu_torch.get(ref)
            st["blocks"] += 1
            st["rows"] += B.block_num_rows(blk)
            st["bytes"] += sum(v.nbytes for v in blk.values()
                               if hasattr(v, "nbytes"))
            st["wall_s"] = _time.perf_counter() - t0
            yield blk

    def stats(self) -> str:
        """Execution summary of the most recent full/partial iteration,
        including per-operator counters (reference: Dataset.stats /
        _internal/stats.py)."""
        st = getattr(self, "_last_stats", None)
        if st is None:
            return "Dataset has not been executed yet"
        mb = st["bytes"] / 1e6
        thru = st["rows"] / st["wall_s"] if st["wall_s"] > 0 else 0.0
        out = (f"plan: {st['plan']}\n"
               f"blocks: {st['blocks']}, rows: {st['rows']}, "
               f"bytes: {mb:.1f} MB\n"
               f"wall: {st['wall_s']:.3f}s, throughput: "
               f"{thru:,.0f} rows/s")
        ps = getattr(self, "_pipeline_stats", None)
        if ps is not None and ps.ops:
            out += "\nper-op:\n" + ps.summary()
        return out

    def stats_dict(self) -> dict:
        """Machine-readable per-op stats of the most recent execution
        (the same numbers flow to /api/metrics.json via util.metrics)."""
        ps = getattr(self, "_pipeline_stats", None)
        return ps.to_dict() if ps is not None else {}

    def materialize(self) -> "Dataset":
        refs = self._block_refs()
        if refs:
            ray_tpu_torch.wait(refs, num_returns=len(refs))
        return Dataset([], [], materialized=refs)

    # ------------------------------------------------------------------
    # global ops (distributed shuffles — stage breaks in the plan)
    # ------------------------------------------------------------------
    def random_shuffle(self, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """Distributed shuffle: map tasks scatter each block into random
        partitions, reduce tasks permute each partition — no block ever
        lands in the driver (reference: push-based shuffle exchange)."""
        return self._with_op(X.ShuffleOp(
            "random", num_partitions=num_blocks, seed=seed))

    def sort(self, key: str, descending: bool = False,
             num_blocks: Optional[int] = None) -> "Dataset":
        """Distributed sample-partition sort (reference:
        data/grouped_data.py sort exchange)."""
        return self._with_op(X.ShuffleOp(
            "sort", num_partitions=num_blocks, key=key,
            descending=descending))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str,
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed inner hash-join on column `on` (reference:
        Dataset.join): a lazy stage break — both sides hash-partition
        by key at execution time, one join task per partition, no block
        ever landing in the driver.  Overlapping right columns get a
        `_right` suffix."""
        return self._with_op(X.JoinOp(other, on, num_partitions))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(X.ShuffleOp("repartition",
                                         num_partitions=num_blocks))

    def split(self, n: int) -> List["Dataset"]:
        """Split into n sub-datasets by block round-robin (reference:
        Dataset.split for per-worker shards)."""
        refs = self._block_refs()
        parts: List[List[ray_tpu_torch.ObjectRef]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            parts[i % n].append(ref)
        return [Dataset([], [], materialized=p) for p in parts]

    def union(self, other: "Dataset") -> "Dataset":
        a = self._block_refs()
        b = other._block_refs()
        return Dataset([], [], materialized=a + b)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two same-length datasets (reference:
        Dataset.zip; duplicate column names get a _1 suffix).

        When the two sides have identical per-block row counts (e.g.
        same block_rows), blocks zip pairwise as parallel tasks; ragged
        block boundaries fall back to one realignment task."""
        left = self._block_refs()
        right = other._block_refs()
        lrows = ray_tpu_torch.get([X._block_rows_of.remote(r) for r in left])
        rrows = ray_tpu_torch.get([X._block_rows_of.remote(r) for r in right])
        if lrows == rrows:
            return Dataset([], [], materialized=[
                X._zip_blocks.remote([lr], [rr])
                for lr, rr in zip(left, right)])
        if sum(lrows) != sum(rrows):
            raise ValueError(f"zip() requires equal row counts "
                             f"({sum(lrows)} vs {sum(rrows)})")
        return Dataset([], [], materialized=[
            X._zip_blocks.remote(left, right)])

    # ------------------------------------------------------------------
    # writes (reference: Dataset.write_parquet/write_csv/write_json in
    # python/ray/data/dataset.py over data/datasource/ writers):
    # distributed — one file per block, written by the task/actor that
    # holds the block, through the fsspec filesystem layer (so
    # memory:// / s3:// / gs:// URIs work like local dirs).
    # ------------------------------------------------------------------
    def _write(self, path: str, fmt: str,
               concurrency: int = 8) -> List[str]:
        _require("pyarrow", f"write_{fmt}")
        from ray_tpu_torch.data import _executor as _X
        out: List[str] = []
        window: List[ray_tpu_torch.ObjectRef] = []
        for i, block_ref in enumerate(self._iter_block_refs()):
            window.append(_X._write_block.remote(block_ref, path,
                                                 fmt, i))
            if len(window) >= concurrency:   # bounded in-flight writes
                out.append(ray_tpu_torch.get(window.pop(0)))
        out.extend(ray_tpu_torch.get(window))
        return out

    def write_parquet(self, path: str) -> List[str]:
        """Write one parquet file per block into `path` (dir or URI);
        returns the written file paths."""
        return self._write(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        """JSON-lines, one file per block."""
        return self._write(path, "json")

    def streaming_split(self, n: int, equal: bool = False
                        ) -> List["DataIterator"]:
        """n iterators fed from ONE streaming execution via a
        coordinator actor — per-worker shards for Train without
        materializing (reference: Dataset.streaming_split ->
        SplitCoordinator, stream_split_iterator.py:124)."""
        coord = _SplitCoordinator.options(max_concurrency=n + 1).remote(
            self, n, equal)
        return [DataIterator(coord, i) for i in range(n)]

    def limit(self, n: int) -> "Dataset":
        out: List[ray_tpu_torch.ObjectRef] = []
        taken = 0
        for ref in self._iter_block_refs():   # lazy: stop pulling early
            blk = ray_tpu_torch.get(ref)
            rows = B.block_num_rows(blk)
            if taken + rows > n:
                # Boundary block: slice and re-store.
                out.append(ray_tpu_torch.put(B.block_slice(blk, 0, n - taken)))
                taken = n
            else:
                out.append(ref)  # whole block kept: reuse its ref
                taken += rows
            if taken >= n:
                break
        return Dataset([], [], materialized=out)

    # ------------------------------------------------------------------
    # consumption
    # ------------------------------------------------------------------
    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Batch]:
        """Streaming batches; `local_shuffle_buffer_size` maintains a
        row reservoir and samples each batch from it uniformly
        (reference: iter_batches local shuffling — randomization
        without a full distributed shuffle per epoch)."""
        yield from _batches_over(
            self._iter_blocks(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed)

    @staticmethod
    def _format(blk: B.Block, fmt: str):
        if fmt == "numpy":
            return blk
        if fmt == "pandas":
            return B.block_to_pandas(blk)
        if fmt == "pyarrow":
            return B.block_to_arrow(blk)
        raise ValueError(f"unknown batch_format {fmt!r}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for blk in self._iter_blocks():
            yield from B.block_rows(blk)

    def iter_torch_batches(self, batch_size: int = 256,
                           drop_last: bool = False,
                           device: Optional[str] = None):
        """Batches as {col: torch.Tensor} (reference:
        Dataset.iter_torch_batches).  Zero-copy from the block arrays
        when dtypes allow (torch.from_numpy)."""
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                try:
                    t = torch.from_numpy(np.ascontiguousarray(v))
                except TypeError:
                    t = torch.tensor(v.tolist())
                out[k] = t.to(device) if device else t
            yield out

    def iter_device_batches(self, batch_size: int, sharding=None,
                            prefetch: int = 2, drop_last: bool = True,
                            device=None) -> Iterator[Dict[str, Any]]:
        """Double-buffered host->card pipeline: the next `prefetch`
        batches are already on the card (or in flight) while the caller
        consumes the current one.  Each column is staged in a pinned
        buffer and copied with non_blocking on a side CUDA stream
        (data/_device.py).  `device=None` is the current CUDA device
        and raises without one; `device="cpu"` yields CPU tensors (no
        pinning, no stream).  `sharding=(mesh, placements)` places each
        column as a DTensor, as CompiledTrainStep.shard_batch does."""
        from ray_tpu_torch.data import _device
        yield from _device.device_batches(
            self.iter_batches(batch_size, drop_last=drop_last), device,
            prefetch, sharding)

    # ------------------------------------------------------------------
    # info
    # ------------------------------------------------------------------
    def count(self) -> int:
        return sum(B.block_num_rows(b) for b in self._iter_blocks())

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self, limit: Optional[int] = 100_000
                 ) -> List[Dict[str, Any]]:
        """Every row as a list (reference: Dataset.take_all — the
        limit guards against accidentally materializing a huge
        dataset in the driver)."""
        out = []
        for row in self.iter_rows():
            out.append(row)
            if limit is not None and len(out) > limit:
                raise ValueError(
                    f"take_all: dataset exceeds limit={limit}; raise "
                    f"the limit or use iter_rows()")
        return out

    def take_batch(self, batch_size: int = 20) -> Batch:
        """First `batch_size` rows as one columnar batch (reference:
        Dataset.take_batch)."""
        blocks: List[B.Block] = []
        got = 0
        for b in self._iter_blocks():
            n = B.block_num_rows(b)
            if not n:
                continue
            take = min(n, batch_size - got)
            blocks.append(B.block_slice(b, 0, take))
            got += take
            if got >= batch_size:
                break
        if not blocks:
            return {}
        return B.block_concat(blocks)

    def show(self, limit: int = 20) -> None:
        """Print rows (reference: Dataset.show)."""
        for row in self.take(limit):
            print(row)

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        """Row-exact splits at global row offsets (reference:
        Dataset.split_at_indices): len(indices)+1 datasets."""
        if any(i < 0 for i in indices) or list(indices) != sorted(
                indices):
            raise ValueError("indices must be sorted and non-negative")
        refs = self._block_refs()
        rows = ray_tpu_torch.get([X._block_rows_of.remote(r) for r in refs])
        starts = np.cumsum([0] + rows[:-1]).tolist()
        out: List[List[ray_tpu_torch.ObjectRef]] = [
            [] for _ in range(len(indices) + 1)]
        bounds = [0] + list(indices) + [sum(rows)]
        for ref, n, s in zip(refs, rows, starts):
            e = s + n
            for part in range(len(bounds) - 1):
                lo, hi = max(s, bounds[part]), min(e, bounds[part + 1])
                if lo >= hi:
                    continue
                if lo == s and hi == e:
                    out[part].append(ref)        # whole block, no copy
                else:
                    out[part].append(X._slice_block.remote(
                        ref, lo - s, hi - s))
        return [Dataset([], [], materialized=p) for p in out]

    @staticmethod
    def from_arrow(table) -> "Dataset":
        """One pyarrow Table -> one-block dataset (reference:
        data/read_api.py from_arrow)."""
        return Dataset([], [], materialized=[
            ray_tpu_torch.put(B.block_from_arrow(table))])

    def to_arrow(self):
        """Materialize into one pyarrow Table (reference:
        Dataset.to_arrow_refs + concat; driver-side, test-scale)."""
        _require("pyarrow", "to_arrow")
        blocks = [b for b in self._iter_blocks()
                  if B.block_num_rows(b)]
        if not blocks:
            import pyarrow as pa
            return pa.table({})
        return B.block_to_arrow(B.block_concat(blocks))

    def to_pandas(self):
        """Materialize into one pandas DataFrame (reference:
        Dataset.to_pandas).  Pulls every block to the driver — for
        small/test datasets; use iter_batches for anything big."""
        _require("pandas", "to_pandas")
        blocks = [b for b in self._iter_blocks()
                  if B.block_num_rows(b)]
        if not blocks:
            import pandas as pd
            return pd.DataFrame()
        return B.block_to_pandas(B.block_concat(blocks))

    def schema(self) -> Dict[str, str]:
        for b in self._iter_blocks():
            # Skip empty blocks: shuffle reducers legitimately emit {}
            # for partitions no rows hashed into.
            if b:
                return {k: str(v.dtype) for k, v in b.items()}
        return {}

    # Whole-dataset aggregates (reference: Dataset.sum/min/max/mean/std
    # — streaming per-block partials, no driver materialization).
    def sum(self, col: str):
        """Column sum, dtype-preserving: integer columns accumulate as
        exact Python ints (no 2^53 float truncation, no int64
        overflow); float columns in float64."""
        total: Any = None
        for b in self._iter_blocks():
            if not B.block_num_rows(b):
                continue
            a = np.asarray(b[col])
            part = (int(np.sum(a, dtype=object))
                    if a.dtype.kind in "iub"
                    else float(np.sum(a, dtype=np.float64)))
            total = part if total is None else total + part
        return 0 if total is None else total

    def min(self, col: str):
        """Native-dtype minimum (strings compare lexicographically,
        like the reference's Dataset.min)."""
        vals = [np.min(np.asarray(b[col]))
                for b in self._iter_blocks() if B.block_num_rows(b)]
        if not vals:
            raise ValueError("min() on an empty dataset")
        out = vals[0]
        for v in vals[1:]:
            if v < out:
                out = v
        return out.item() if hasattr(out, "item") else out

    def max(self, col: str):
        vals = [np.max(np.asarray(b[col]))
                for b in self._iter_blocks() if B.block_num_rows(b)]
        if not vals:
            raise ValueError("max() on an empty dataset")
        out = vals[0]
        for v in vals[1:]:
            if v > out:
                out = v
        return out.item() if hasattr(out, "item") else out

    def _moments(self, col: str):
        """Chan-style parallel merge of per-block (n, mean, M2): the
        numerically stable route to mean/std (the naive E[x^2]-mean^2
        form cancels catastrophically when |mean| >> std, e.g. unix
        timestamps)."""
        n, mean, m2 = 0, 0.0, 0.0
        for b in self._iter_blocks():
            if not B.block_num_rows(b):
                continue
            a = np.asarray(b[col], np.float64)
            nb = a.size
            mb = float(np.mean(a))
            m2b = float(np.sum((a - mb) ** 2))
            delta = mb - mean
            tot = n + nb
            m2 = m2 + m2b + delta * delta * n * nb / tot
            mean = mean + delta * nb / tot
            n = tot
        return n, mean, m2

    def mean(self, col: str) -> float:
        n, mean, _ = self._moments(col)
        if not n:
            raise ValueError("mean() on an empty dataset")
        return mean

    def std(self, col: str, ddof: int = 1) -> float:
        n, _, m2 = self._moments(col)
        if n <= ddof:
            raise ValueError("std() needs more rows than ddof")
        return float(np.sqrt(m2 / (n - ddof)))

    def num_blocks(self) -> int:
        if self._materialized is not None:
            return len(self._materialized)
        n = len(self._sources)
        for op in self._plan:
            if isinstance(op, X.ShuffleOp):
                n = op.P or n
        return n

    def __repr__(self) -> str:
        return (f"Dataset(blocks={self.num_blocks()}, "
                f"ops={len(self._plan)})")


@ray_tpu_torch.remote
class _SplitCoordinator:
    """One streaming execution, n consumers (reference:
    SplitCoordinator actor, stream_split_iterator.py:124).

    equal=False: work-stealing — any next_block() claims the next block
    (fast consumers get more).  equal=True: deterministic round-robin
    BLOCK assignment — every split sees the same number of blocks
    (row-exact equality, which the reference achieves by splitting
    blocks, is approximated at block granularity)."""

    def __init__(self, ds: "Dataset", n: int, equal: bool) -> None:
        import threading
        from collections import deque
        self._it = ds._iter_block_refs(preserve_order=True)
        self._lock = threading.Lock()
        self._n = n
        self._equal = equal
        self._done = False
        # equal mode: per-split ready queues + a global RR cursor
        self._queues = [deque() for _ in range(n)]
        self._rr = 0

    def _pull(self):
        try:
            return next(self._it)
        except StopIteration:
            self._done = True
            return None

    def next_block(self, split_index: int):
        if not 0 <= split_index < self._n:
            raise ValueError(f"split index {split_index} out of range "
                             f"[0, {self._n})")
        with self._lock:
            if not self._equal:
                return None if self._done else self._pull()
            q = self._queues[split_index]
            while not q and not self._done:
                ref = self._pull()
                if ref is None:
                    break
                self._queues[self._rr].append(ref)
                self._rr = (self._rr + 1) % self._n
            return q.popleft() if q else None


class DataIterator:
    """Per-consumer handle from `streaming_split` (reference:
    DataIterator / stream_split_iterator)."""

    def __init__(self, coord, index: int) -> None:
        self._coord = coord
        self._index = index

    def _iter_blocks(self) -> Iterator[B.Block]:
        while True:
            ref = ray_tpu_torch.get(
                self._coord.next_block.remote(self._index))
            if ref is None:
                return
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Batch]:
        yield from _batches_over(
            self._iter_blocks(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for blk in self._iter_blocks():
            yield from B.block_rows(blk)


class GroupedData:
    """ds.groupby(key) -> aggregations as a distributed hash-shuffle
    (reference: data/grouped_data.py; aggregate fns data/aggregate.py).
    Each key hashes to exactly one partition, so the reduce side groups
    partition-locally with global correctness."""

    def __init__(self, ds: Dataset, key: str) -> None:
        self._ds = ds
        self._key = key

    def _agg(self, aggs: List[Tuple[str, str, str]]) -> Dataset:
        return self._ds._with_op(X.ShuffleOp(
            "groupby", key=self._key, aggs=aggs))

    def count(self) -> Dataset:
        return self._agg([("count", self._key, "count()")])

    def sum(self, col: str) -> Dataset:
        return self._agg([("sum", col, f"sum({col})")])

    def mean(self, col: str) -> Dataset:
        return self._agg([("mean", col, f"mean({col})")])

    def min(self, col: str) -> Dataset:
        return self._agg([("min", col, f"min({col})")])

    def max(self, col: str) -> Dataset:
        return self._agg([("max", col, f"max({col})")])

    def std(self, col: str) -> Dataset:
        return self._agg([("std", col, f"std({col})")])

    def map_groups(self, fn: Callable[[Batch], Batch]) -> Dataset:
        """Apply `fn` to each key-group as one columnar batch
        (reference: grouped_data.py GroupedData.map_groups)."""
        return self._ds._with_op(X.ShuffleOp(
            "groupmap", key=self._key, group_fn=fn))

    def aggregate(self, **aggs: Tuple[str, str]) -> Dataset:
        """aggregate(out_name=("sum", "col"), ...)"""
        return self._agg([(agg, col, out)
                          for out, (agg, col) in aggs.items()])


def _batches_over(blocks: Iterator[B.Block], batch_size: int,
                  batch_format: str, drop_last: bool,
                  shuffle_buffer: Optional[int],
                  shuffle_seed: Optional[int]) -> Iterator[Batch]:
    """Shared batching core for Dataset.iter_batches and
    DataIterator.iter_batches (one implementation, two entry points).

    Without shuffling: a carry block re-aligns ragged block
    boundaries.  With `shuffle_buffer`: a row reservoir emits
    uniformly-sampled batches once it holds max(buffer, batch) rows,
    then drains shuffled — exactly-once delivery either way."""
    if shuffle_buffer:
        rng = np.random.RandomState(shuffle_seed)
        buf: Optional[B.Block] = None
        low = max(shuffle_buffer, batch_size)
        for blk in blocks:
            if not B.block_num_rows(blk):
                continue
            buf = blk if buf is None else B.block_concat([buf, blk])
            while B.block_num_rows(buf) >= low:
                n = B.block_num_rows(buf)
                pick = rng.choice(n, size=batch_size, replace=False)
                mask = np.ones(n, bool)
                mask[pick] = False
                yield Dataset._format(B.block_take(buf, pick),
                                      batch_format)
                buf = B.block_take(buf, np.nonzero(mask)[0])
        while buf is not None and B.block_num_rows(buf):
            n = B.block_num_rows(buf)
            take = min(batch_size, n)
            if take < batch_size and drop_last:
                break
            pick = rng.choice(n, size=take, replace=False)
            mask = np.ones(n, bool)
            mask[pick] = False
            yield Dataset._format(B.block_take(buf, pick),
                                  batch_format)
            buf = B.block_take(buf, np.nonzero(mask)[0])
        return
    carry: Optional[B.Block] = None
    for blk in blocks:
        if carry is not None:
            blk = B.block_concat([carry, blk])
            carry = None
        n = B.block_num_rows(blk)
        i = 0
        while n - i >= batch_size:
            yield Dataset._format(B.block_slice(blk, i, i + batch_size),
                                  batch_format)
            i += batch_size
        if i < n:
            carry = B.block_slice(blk, i, n)
    if carry is not None and not drop_last:
        yield Dataset._format(carry, batch_format)


def _expand_paths(paths: Union[str, List[str]],
                  exts: Tuple[str, ...]) -> List[str]:
    from ray_tpu_torch.data.filesystem import expand
    return expand(paths, exts)


# Module-level constructors mirroring ray.data.* entry points.
from_items = Dataset.from_items
range_ = Dataset.range
from_numpy = Dataset.from_numpy
from_pandas = Dataset.from_pandas
read_parquet = Dataset.read_parquet
read_csv = Dataset.read_csv
read_json = Dataset.read_json
read_images = Dataset.read_images
read_tfrecords = Dataset.read_tfrecords

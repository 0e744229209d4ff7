"""Block model: a block is a column batch — dict-of-numpy OR an Arrow
Table, accessor-dispatched.

Analog of the reference's Block/BlockAccessor (data/block.py:196/221)
where a block is an Arrow/Pandas chunk in plasma.  dict-of-numpy is the
canonical tensor-path format — it serializes zero-copy through the shm
object store (pickle-5 buffers) and becomes a torch tensor without a
copy (`torch.from_numpy`); blocks hold no tensors, so Data's tasks
never import torch.  ``pyarrow.Table`` is the native COLUMNAR format
(DataContext.block_format="arrow" or Dataset.from_arrow): string/nested
columns skip the numpy-object round-trip, slices are zero-copy views,
and groupbys run Arrow's C++ hash aggregation (_executor._reduce_grouped
fast path).  Every ``block_*`` accessor below dispatches on type, so
operators never care which format flows through (reference:
BlockAccessor.for_block, data/block.py:221).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], "pyarrow.Table"]  # noqa: F821


def is_arrow_block(block) -> bool:
    """True when the block is a pyarrow.Table (cheap: no pyarrow import
    unless the object plausibly is one)."""
    if type(block).__module__.split(".")[0] != "pyarrow":
        return False
    import pyarrow as pa
    return isinstance(block, pa.Table)


def block_from_rows(rows: Sequence[Dict[str, Any]]) -> Block:
    if not rows:
        return {}
    cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r[k])
    return {k: np.asarray(v) for k, v in cols.items()}


def block_from_items(items: Sequence[Any]) -> Block:
    if items and isinstance(items[0], dict):
        return block_from_rows(items)  # type: ignore[arg-type]
    return {"item": np.asarray(items)}


def block_num_rows(block: Block) -> int:
    if is_arrow_block(block):
        return block.num_rows
    for v in block.values():
        return len(v)
    return 0


def block_slice(block: Block, start: int, end: int) -> Block:
    if is_arrow_block(block):
        return block.slice(start, max(end - start, 0))  # zero-copy view
    return {k: v[start:end] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    if any(is_arrow_block(b) for b in blocks):
        import pyarrow as pa
        tables = [b if is_arrow_block(b) else block_to_arrow(b)
                  for b in blocks]
        return pa.concat_tables(tables, promote_options="default")
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_take(block: Block, indices: np.ndarray) -> Block:
    if is_arrow_block(block):
        return block.take(np.asarray(indices))
    return {k: v[indices] for k, v in block.items()}


def block_column(block: Block, key: str) -> np.ndarray:
    """One column as numpy (object dtype for Arrow strings)."""
    if is_arrow_block(block):
        return np.asarray(block[key])
    return np.asarray(block[key])


def block_rows(block: Block) -> Iterator[Dict[str, Any]]:
    if is_arrow_block(block):
        yield from block.to_pylist()
        return
    n = block_num_rows(block)
    keys = list(block.keys())
    for i in range(n):
        yield {k: block[k][i] for k in keys}


def block_nbytes(block: Block) -> int:
    if is_arrow_block(block):
        return block.nbytes
    return sum(v.nbytes for v in block.values()
               if isinstance(v, np.ndarray))


def block_to_numpy(block: Block) -> Dict[str, np.ndarray]:
    """Canonical dict-of-numpy view of any block format (used where an
    op's kernel is numpy-specific, e.g. the hash join)."""
    if is_arrow_block(block):
        return block_from_arrow(block)
    return block


def block_to_pandas(block: Block):
    import pandas as pd
    return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                         for k, v in block.items()})


def block_from_pandas(df) -> Block:
    return {c: df[c].to_numpy() for c in df.columns}


def block_to_arrow(block: Block):
    """Tensor columns ([N, d0, ...]) become FixedSizeList arrays over a
    flat values buffer — zero-copy from the numpy view — with the inner
    shape recorded in field metadata so >2-D tensors round-trip
    (reference: ArrowTensorArray, data/_internal/arrow_block.py).
    Arrow-native blocks pass through unchanged."""
    import json
    import pyarrow as pa
    if is_arrow_block(block):
        return block
    arrays, fields = [], []
    for k, v in block.items():
        if getattr(v, "ndim", 1) > 1 and v.dtype != object:
            flat = pa.array(np.ascontiguousarray(v).reshape(-1))
            width = int(np.prod(v.shape[1:]))
            arr = pa.FixedSizeListArray.from_arrays(flat, width)
            meta = {b"rtpu_tensor_shape":
                    json.dumps(list(v.shape[1:])).encode()}
            fields.append(pa.field(k, arr.type, metadata=meta))
            arrays.append(arr)
        elif getattr(v, "ndim", 1) > 1:
            arr = pa.array(v.tolist())
            fields.append(pa.field(k, arr.type))
            arrays.append(arr)
        else:
            arr = pa.array(v)
            fields.append(pa.field(k, arr.type))
            arrays.append(arr)
    return pa.table(arrays, schema=pa.schema(fields))


def block_from_arrow(table) -> Block:
    """FixedSizeList and uniform-length list columns reconstruct as
    tensors (zero-copy for fixed-size lists over primitive values);
    the inner shape comes from field metadata when present."""
    import json
    import pyarrow as pa
    out = {}
    for name in table.column_names:
        field = table.schema.field(name)
        col = table.column(name)
        if col.num_chunks == 1:
            col = col.chunk(0)      # zero-copy; combine_chunks copies
        else:
            col = col.combine_chunks()
            if isinstance(col, pa.ChunkedArray):    # zero chunks
                col = pa.concat_arrays(col.chunks) if col.chunks \
                    else pa.array([], type=col.type)
        if pa.types.is_fixed_size_list(col.type):
            width = col.type.list_size
            vals = col.values.to_numpy(zero_copy_only=False)
            inner = [width]
            meta = field.metadata or {}
            if b"rtpu_tensor_shape" in meta:
                inner = json.loads(meta[b"rtpu_tensor_shape"])
            out[name] = vals.reshape(len(col), *inner)
            continue
        if pa.types.is_list(col.type) or \
                pa.types.is_large_list(col.type):
            offsets = col.offsets.to_numpy(zero_copy_only=False)
            widths = np.diff(offsets)
            if len(widths) and (widths == widths[0]).all() \
                    and not pa.types.is_nested(col.type.value_type):
                vals = col.flatten().to_numpy(zero_copy_only=False)
                out[name] = vals.reshape(len(col), int(widths[0]))
                continue
        try:
            out[name] = col.to_numpy(zero_copy_only=False)
        except Exception:
            out[name] = np.asarray(col.to_pylist(), dtype=object)
    return out

"""Host -> card batch pipeline behind `Dataset.iter_device_batches`.

The JAX package hands each column to `jax.device_put`, whose transfers
are asynchronous.  Here each column is staged in a page-locked (pinned)
host buffer and copied with `non_blocking=True` on a side CUDA stream,
so the next `prefetch` batches are in flight while the caller's kernels
use the current one.  Two orderings keep that safe:

* before a batch is handed out, the caller's current stream waits on
  the event recorded after its copy, and every tensor of the batch is
  `record_stream`-ed on that stream, so the caching allocator does not
  give its memory to another copy while the caller may still read it;
* a pinned buffer is refilled only once the event of the copy that last
  read it has completed (`prefetch + 1` staging slots, used in turn).

Pinning is not optional: a failure to pin raises rather than falling
back to synchronous copies.  On the CPU (`device="cpu"`, the tests'
path) columns become tensors over the block arrays (copied where the
array is read-only, as a block read from the store is): no pinning, no
stream.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device

# Batches (and their bytes) staged through pinned buffers and copied on
# a side stream in this process; chip_smoke.py zeroes and reads them.
COUNTS = {"pinned_batches": 0, "pinned_bytes": 0}

Batch = Dict[str, Any]


def _torch_dtype(name: str, dtype: np.dtype) -> torch.dtype:
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError as e:
        raise TypeError(f"column {name!r} of dtype {dtype} has no torch "
                        "dtype") from e


def _host_tensor(name: str, column) -> torch.Tensor:
    """A CPU tensor of the column: the block's own memory when numpy
    lets it be written (a block read from the store is read-only, and
    is copied)."""
    column = np.asarray(column)
    _torch_dtype(name, column.dtype)
    if not (column.flags.writeable and column.flags.c_contiguous):
        column = np.array(column, order="C")
    return torch.from_numpy(column)


def _placer(sharding) -> Callable[[torch.Tensor], Any]:
    """`sharding=(mesh, placements)` -> each rank's part of the column
    as a DTensor (nothing is sent: every rank reads the same batch)."""
    if sharding is None:
        return lambda t: t
    from ray_tpu_torch.train.train_step import _place
    mesh, placements = sharding
    return lambda t: _place(t, mesh, placements)


class _Slot:
    """One batch's pinned staging buffers and the event of the copy
    that last read them."""

    def __init__(self) -> None:
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = None

    def stage(self, batch: Batch) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()
        staged = {}
        for name, column in batch.items():
            column = np.asarray(column)
            dtype = _torch_dtype(name, column.dtype)
            buf = self.buffers.get(name)
            if buf is None or buf.shape != column.shape or \
                    buf.dtype != dtype:
                buf = torch.empty(column.shape, dtype=dtype,
                                  pin_memory=True)
                self.buffers[name] = buf
            buf.numpy()[...] = column
            staged[name] = buf
        return staged


def _cuda_batches(batches: Iterable[Batch], dev: torch.device,
                  prefetch: int, place) -> Iterator[Batch]:
    copy_stream = torch.cuda.Stream(dev)
    slots = [_Slot() for _ in range(prefetch + 1)]
    in_flight: Deque[Tuple[Dict[str, torch.Tensor], Any]] = deque()

    def hand_out(item):
        out, event = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
        return {k: place(t) for k, t in out.items()}

    for i, batch in enumerate(batches):
        slot = slots[i % len(slots)]
        staged = slot.stage(batch)
        with torch.cuda.stream(copy_stream):
            out = {k: t.to(dev, non_blocking=True)
                   for k, t in staged.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        slot.event = event
        COUNTS["pinned_batches"] += 1
        COUNTS["pinned_bytes"] += sum(t.nbytes for t in staged.values())
        in_flight.append((out, event))
        if len(in_flight) > prefetch:
            yield hand_out(in_flight.popleft())
    while in_flight:
        yield hand_out(in_flight.popleft())


def device_batches(batches: Iterable[Batch], device=None,
                   prefetch: int = 2, sharding=None) -> Iterator[Batch]:
    """Numpy batches -> {column: tensor} on `device` (CUDA by default;
    see the module docstring)."""
    if prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {prefetch}")
    dev = resolve_device(device)
    place = _placer(sharding)
    if dev.type == "cuda":
        yield from _cuda_batches(batches, dev, prefetch, place)
        return
    buf: Deque[Batch] = deque()
    for batch in batches:
        buf.append({k: place(_host_tensor(k, v).to(dev))
                    for k, v in batch.items()})
        if len(buf) > prefetch:
            yield buf.popleft()
    while buf:
        yield buf.popleft()

"""DataContext: execution knobs for Dataset pipelines.

Analog of the reference's DataContext (data/context.py:211
DataContext.get_current()) — per-driver settings the streaming
executor reads at execution time.  The two backpressure knobs mirror
the reference's ConcurrencyCapBackpressurePolicy and the
ResourceManager's object-store budget
(_internal/execution/backpressure_policy/,
streaming_executor_state.py): the executor keeps at most
`max_blocks_in_flight` tasks outstanding per operator AND shrinks that
window so the bytes held by outstanding blocks stay under
`max_bytes_in_flight` (estimated from completed blocks' actual sizes —
a mixed CPU+GPU pipeline with fat decoded-image blocks throttles to a
few blocks while skinny token blocks keep the full window).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional


@dataclass
class DataContext:
    # Max outstanding block tasks per streaming operator.
    max_blocks_in_flight: int = 8
    # Byte budget for outstanding blocks per operator; None disables
    # byte-based backpressure (count cap still applies).
    max_bytes_in_flight: Optional[int] = 256 * 1024 * 1024
    # Default rows per block for constructors (from_numpy etc.).
    block_rows: int = 4096
    # Block format for columnar readers (read_parquet/csv/json):
    # "numpy" converts to dict-of-numpy at read time (tensor path);
    # "arrow" keeps pyarrow Tables end-to-end — string/nested columns
    # skip the numpy-object round-trip and groupbys run Arrow's C++
    # hash aggregation (reference: Arrow blocks, data/block.py:196).
    block_format: str = "numpy"
    # Files decoded per read_images block.
    images_per_block: int = 64

    _current: ClassVar[Optional["DataContext"]] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._current is None:
            cls._current = cls()
        return cls._current

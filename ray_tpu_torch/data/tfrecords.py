"""TFRecord framing + tf.train.Example wire-format parsing, natively.

Reference analog: data/read_api.py read_tfrecords over
TFRecordDatasource.  The reference imports tensorflow for the proto
classes; this image has no tensorflow, and the formats are tiny and
frozen, so both layers are parsed directly:

* TFRecord framing (tensorflow/core/lib/io/record_writer.h):
  uint64 length (LE) | uint32 masked-crc32c(length) | data |
  uint32 masked-crc32c(data).  CRCs are skipped on read (crc32c is
  not in the stdlib; corrupt-file detection is the filesystem's job
  here), matching the reference's `tf_record_iterator` default.

* tf.train.Example (tensorflow/core/example/example.proto):
  Example{1: Features{1: map<string, Feature>}},
  Feature one-of {1: BytesList, 2: FloatList, 3: Int64List}, each a
  repeated field 1 (floats may be packed).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Iterator, List, Tuple

import numpy as np

_MASK_DELTA = 0xA282EAD8


def _masked_crc(data: bytes) -> int:
    """Masked crc32c as the writer produces it (write path only)."""
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + _MASK_DELTA) & 0xFFFFFFFF


def _crc32c(data: bytes) -> int:
    """Software CRC-32C (Castagnoli); only used when WRITING records."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 * (crc & 1))
    return crc ^ 0xFFFFFFFF


def read_records(f) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord stream."""
    while True:
        header = f.read(12)
        if not header:
            return
        if len(header) < 12:
            raise ValueError("truncated TFRecord header")
        (length,) = struct.unpack("<Q", header[:8])
        data = f.read(length)
        if len(data) < length:
            raise ValueError("truncated TFRecord data")
        if len(f.read(4)) < 4:
            raise ValueError("truncated TFRecord data crc")
        yield data


def write_records(f, payloads: Iterable[bytes]) -> int:
    """Write TFRecord framing (with real masked CRCs); returns count."""
    n = 0
    for data in payloads:
        header = struct.pack("<Q", len(data))
        f.write(header)
        f.write(struct.pack("<I", _masked_crc(header)))
        f.write(data)
        f.write(struct.pack("<I", _masked_crc(data)))
        n += 1
    return n


# ---------------------------------------------------------------------------
# minimal protobuf wire reader
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                      # varint
            v, i = _varint(buf, i)
        elif wt == 1:                    # fixed64
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:                    # length-delimited
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:                    # fixed32
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_feature(buf: bytes):
    for field, wt, v in _fields(buf):
        if field == 1:                   # BytesList
            return [bv for f2, _, bv in _fields(v) if f2 == 1]
        if field == 2:                   # FloatList (maybe packed)
            out: List[float] = []
            for f2, wt2, fv in _fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:             # packed
                    out.extend(struct.unpack(f"<{len(fv) // 4}f", fv))
                else:
                    out.append(struct.unpack("<f", fv)[0])
            return out
        if field == 3:                   # Int64List (maybe packed)
            ints: List[int] = []
            for f2, wt2, iv in _fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:             # packed varints
                    j = 0
                    while j < len(iv):
                        x, j = _varint(iv, j)
                        ints.append(_signed64(x))
                else:
                    ints.append(_signed64(iv))
            return ints
    return []


def parse_example(record: bytes) -> Dict[str, list]:
    """tf.train.Example bytes -> {feature_name: list of values}."""
    out: Dict[str, list] = {}
    for field, _, v in _fields(record):
        if field != 1:                   # Example.features
            continue
        for f2, _, entry in _fields(v):
            if f2 != 1:                  # Features.feature map entry
                continue
            key, val = None, []
            for f3, _, ev in _fields(entry):
                if f3 == 1:
                    key = ev.decode()
                elif f3 == 2:
                    val = _parse_feature(ev)
            if key is not None:
                out[key] = val
    return out


def examples_to_block(examples: Iterable[Dict[str, list]]
                      ) -> Dict[str, np.ndarray]:
    """Column-ize parsed examples: scalars unwrap, fixed-width lists
    become 2-D columns, ragged/bytes become object arrays."""
    rows = list(examples)
    if not rows:
        return {}
    keys = sorted({k for r in rows for k in r})
    out: Dict[str, np.ndarray] = {}
    for k in keys:
        vals = [r.get(k, []) for r in rows]
        lens = {len(v) for v in vals}
        if lens == {1}:
            flat = [v[0] for v in vals]
            if isinstance(flat[0], (bytes, bytearray)):
                col = np.empty(len(flat), dtype=object)
                for i, b in enumerate(flat):
                    col[i] = b
                out[k] = col
            else:
                out[k] = np.asarray(flat)
        elif len(lens) == 1 and not isinstance(
                next(iter(vals[0]), None), (bytes, bytearray)):
            out[k] = np.asarray(vals)
        else:
            col = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                col[i] = v
            out[k] = col
    return out


# -- write-side helpers (tests + dataset exports) ---------------------------
def _encode_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _encode_varint(field << 3 | 2) + \
        _encode_varint(len(payload)) + payload


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: bytes | [bytes] | float(s) | int(s)} -> Example bytes."""
    entries = b""
    for k, v in features.items():
        vals = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
        vals = list(vals)
        if vals and isinstance(vals[0], (bytes, bytearray, str)):
            items = b"".join(
                _ld(1, x.encode() if isinstance(x, str) else bytes(x))
                for x in vals)
            feat = _ld(1, items)                      # BytesList
        elif vals and isinstance(vals[0], (float, np.floating)):
            packed = struct.pack(f"<{len(vals)}f", *vals)
            feat = _ld(2, _ld(1, packed))             # FloatList packed
        else:
            body = b"".join(
                _encode_varint(1 << 3 | 0)
                + _encode_varint(int(x) & ((1 << 64) - 1))
                for x in vals)
            feat = _ld(3, body)                       # Int64List
        entries += _ld(1, _ld(1, k.encode()) + _ld(2, feat))
    return _ld(1, entries)                            # Example.features

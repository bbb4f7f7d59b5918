# Port copy of src/repro/columnar/codec.py (the port imports nothing of the JAX package): keep the two in sync by hand.
"""TAG_COLBLOCK wire format: :class:`ColumnBlock` <-> one shm span slot.

A block travels through the ring as a single contiguous frame written via
the same span-publish path bundles use (``core.shm`` only moves the bytes;
this module owns their meaning).  Layout, all little-endian::

    [nrows:4][flags:1][ncols:1][head_serial:8]      _HDR, 14 bytes
    [ncols field-code bytes]                        see block._CODE_BYTE
    [serials: nrows * i8]                           only if flags & EXPLICIT_SERIALS
    [column 0 raw bytes][column 1 raw bytes]...     nrows * itemsize each
    [marks pickle]                                  only if flags & HAS_MARKS

Scalar-vs-tuple row shape rides ``flags & SCALAR``.  Contiguous serials
(``head, head+1, ...`` — the overwhelmingly common dispatch-unit shape) are
elided from the wire and rebuilt from ``head_serial``; only reordered
device egress pays the explicit-serials vector.  Field *names* never hit
the wire: the decoder rebuilds a positional ``c0..ck`` schema, which is
sufficient because stage exchanges address columns by position.

Decoding is zero-copy for cell data: columns are ``np.frombuffer`` views
over the received payload bytes.  Ragged markers are the one pickled
sidecar (they are rare control records, not per-row data).
"""
from __future__ import annotations

import pickle
import struct
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from .block import ColumnBlock, Schema, byte_to_code, code_to_byte

_PICKLE = pickle.HIGHEST_PROTOCOL

_HDR = struct.Struct("<IBBq")  # nrows:4  flags:1  ncols:1  head_serial:8

EXPLICIT_SERIALS = 1  # serials vector present (non-contiguous blocks)
HAS_MARKS = 2  # pickled marks sidecar trails the columns
SCALAR = 4  # rows decode as bare scalars, not 1-tuples

_I64 = np.dtype("<i8")


def encode_block(block: ColumnBlock) -> bytes:
    """Serialise a block to one TAG_COLBLOCK payload frame."""
    n = len(block)
    flags = 0
    if not block.contiguous_serials():
        flags |= EXPLICIT_SERIALS
    if block.marks:
        flags |= HAS_MARKS
    if block.schema.scalar:
        flags |= SCALAR
    parts = [
        _HDR.pack(n, flags, block.schema.width, block.head_serial),
        bytes(code_to_byte(c) for c in block.schema.codes),
    ]
    if flags & EXPLICIT_SERIALS:
        parts.append(np.ascontiguousarray(block.serials, dtype=_I64).tobytes())
    for col in block.columns:
        parts.append(np.ascontiguousarray(col).tobytes())
    if flags & HAS_MARKS:
        parts.append(pickle.dumps(block.marks, _PICKLE))
    return b"".join(parts)


@lru_cache(maxsize=256)
def _wire_schema(code_bytes: bytes, scalar: bool) -> Schema:
    # streams see the same few schemas for millions of frames; Schema
    # construction (dataclass + validation) is ~2µs, the cache hit ~100ns
    codes = tuple(byte_to_code(b) for b in code_bytes)
    return Schema.of(*codes, scalar=scalar)


def decode_block(data: bytes) -> ColumnBlock:
    """Rebuild a block from a TAG_COLBLOCK frame (zero-copy columns)."""
    n, flags, ncols, head = _HDR.unpack_from(data, 0)
    off = _HDR.size
    schema = _wire_schema(data[off : off + ncols], bool(flags & SCALAR))
    off += ncols
    if flags & EXPLICIT_SERIALS:
        serials = np.frombuffer(data, dtype=_I64, count=n, offset=off)
        off += n * 8
    else:
        serials = np.arange(head, head + n, dtype=_I64)
    cols = []
    for dt in schema.dtypes:
        cols.append(np.frombuffer(data, dtype=dt, count=n, offset=off))
        off += n * dt.itemsize
    marks = list(pickle.loads(data[off:])) if flags & HAS_MARKS else []
    return ColumnBlock(schema, cols, serials, marks)


class ColumnarCodec:
    """Builder half of the columnar dispatch path.

    The dispatcher feeds it contiguous ``(values, marks)`` micro-batches; it
    answers with an encoded frame when the batch fits a fixed-width schema
    and ``None`` when the batch must fall back to pickle.  The schema is
    locked by the first encodable batch so a stream cannot silently flip
    layouts mid-flight (a later mismatched batch just falls back)."""

    def __init__(self, schema: Optional[Schema] = None):
        self.schema = schema
        #: batches diverted to pickle (observability: bench/tests read this)
        self.fallbacks = 0

    def try_encode_unit(
        self, vals: list, marks: list, head_serial: int
    ) -> Optional[Tuple[bytes, int]]:
        """Encode one dispatch unit; returns ``(payload, span)`` or ``None``
        (pickle fallback).  ``marks`` is the dispatcher's ragged
        ``(row_offset, marker)`` sidecar for this unit."""
        block = ColumnBlock.from_values(
            vals, head_serial=head_serial, marks=marks, schema=self.schema
        )
        if block is None:
            self.fallbacks += 1
            return None
        if self.schema is None:
            self.schema = block.schema
        return encode_block(block), len(block)

"""Chunk wire codec: Chunk <-> bytes.

Capability parity with reference util/chunk/codec.go:353 (the SelectResponse
chunk wire format used by the coprocessor response path).  Layout per column:
  [u32 length][null bitmap bytes][payload]
payload = raw little-endian buffer for fixed-width; [u32 offsets][utf8 bytes]
for strings.  The selection vector is materialized before encode.
"""
from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from ..mytypes import EvalType, FieldType
from .column import Column
from .chunk import Chunk


def encode_column(col: Column) -> bytes:
    n = len(col)
    out = [struct.pack("<I", n)]
    out.append(np.packbits(col.null_mask(), bitorder="little").tobytes())
    if col.ft.eval_type is EvalType.STRING:
        vals = ["" if col.is_null(i) else str(col.values()[i]) for i in range(n)]
        raw = [v.encode("utf-8") for v in vals]
        offsets = np.zeros(n + 1, dtype=np.uint32)
        for i, b in enumerate(raw):
            offsets[i + 1] = offsets[i] + len(b)
        out.append(offsets.tobytes())
        out.append(b"".join(raw))
    else:
        out.append(np.ascontiguousarray(col.values()).tobytes())
    return b"".join(out)


def _need(buf: bytes, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise ValueError(f"truncated chunk buffer: need {n} bytes at {pos}, have {len(buf) - pos}")


def decode_column(buf: bytes, pos: int, ft: FieldType) -> tuple[Column, int]:
    _need(buf, pos, 4)
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    nb = (n + 7) // 8
    _need(buf, pos, nb)
    null = np.unpackbits(
        np.frombuffer(buf, dtype=np.uint8, count=nb, offset=pos),
        bitorder="little")[:n].astype(bool)
    pos += nb
    if ft.eval_type is EvalType.STRING:
        _need(buf, pos, 4 * (n + 1))
        offsets = np.frombuffer(buf, dtype=np.uint32, count=n + 1, offset=pos)
        pos += 4 * (n + 1)
        total = int(offsets[-1]) if n else 0
        _need(buf, pos, total)
        blob = buf[pos:pos + total]
        pos += total
        data = np.empty(n, dtype=object)
        for i in range(n):
            data[i] = blob[offsets[i]:offsets[i + 1]].decode("utf-8")
        col = Column.from_numpy(ft, data, null)
    else:
        _need(buf, pos, 8 * n)
        dt = np.int64 if ft.eval_type is EvalType.INT else np.float64
        data = np.frombuffer(buf, dtype=dt, count=n, offset=pos).copy()
        pos += 8 * n
        col = Column.from_numpy(ft, data, null)
    return col, pos


def encode_chunk(chk: Chunk) -> bytes:
    c = chk.compact()
    return b"".join(encode_column(col) for col in c.columns)


def decode_chunk(buf: bytes, fields: Sequence[FieldType]) -> Chunk:
    cols: List[Column] = []
    pos = 0
    for ft in fields:
        col, pos = decode_column(buf, pos, ft)
        cols.append(col)
    return Chunk.from_columns(cols)

"""Row value codec: {columnID: datum} <-> bytes.

Capability parity with reference util/rowcodec (v2 row format: column-id
directory + typed payloads, decoded straight into chunk columns —
rowcodec/decoder.go:355).  Layout:

  [u8 version=2][u16 ncols] then per column (sorted by id):
  [varint colID][u8 tag][payload]
  tag: 0=NULL, 1=int64(le), 2=float64(le), 3=str(u32 len + utf8)
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

from ..mytypes import Datum, FieldType, EvalType

_VERSION = 2
TAG_NULL, TAG_INT, TAG_REAL, TAG_STR = 0, 1, 2, 3


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


def encode_row(values: Dict[int, Datum]) -> bytes:
    out = bytearray()
    out.append(_VERSION)
    out += struct.pack("<H", len(values))
    for col_id in sorted(values):
        v = values[col_id]
        _write_varint(out, col_id)
        if v is None:
            out.append(TAG_NULL)
        elif isinstance(v, bool):
            out.append(TAG_INT)
            out += struct.pack("<q", int(v))
        elif isinstance(v, int):
            # two's-complement wrap into int64, matching Column.append
            u = v & ((1 << 64) - 1)
            out.append(TAG_INT)
            out += struct.pack("<q", u - (1 << 64) if u >= (1 << 63) else u)
        elif isinstance(v, float):
            out.append(TAG_REAL)
            out += struct.pack("<d", v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            out.append(TAG_STR)
            out += struct.pack("<I", len(raw))
            out += raw
        else:
            raise TypeError(f"cannot row-encode {v!r}")
    return bytes(out)


def decode_row(buf: bytes) -> Dict[int, Datum]:
    if not buf:
        return {}
    if buf[0] != _VERSION:
        raise ValueError(f"bad row version {buf[0]}")
    (ncols,) = struct.unpack_from("<H", buf, 1)
    pos = 3
    out: Dict[int, Datum] = {}
    for _ in range(ncols):
        col_id, pos = _read_varint(buf, pos)
        tag = buf[pos]
        pos += 1
        if tag == TAG_NULL:
            out[col_id] = None
        elif tag == TAG_INT:
            (v,) = struct.unpack_from("<q", buf, pos)
            pos += 8
            out[col_id] = v
        elif tag == TAG_REAL:
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            out[col_id] = v
        elif tag == TAG_STR:
            (n,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            out[col_id] = buf[pos:pos + n].decode("utf-8")
            pos += n
        else:
            raise ValueError(f"bad row tag {tag}")
    return out


def decode_row_to_datums(buf: bytes, col_ids: Sequence[int],
                         fts: Sequence[FieldType],
                         defaults: Optional[Sequence[Datum]] = None) -> List[Datum]:
    """Decode selected columns in order, filling defaults for absent ids —
    the chunk-decoder fast path (reference: rowcodec/decoder.go:355)."""
    m = decode_row(buf)
    out: List[Datum] = []
    for i, cid in enumerate(col_ids):
        if cid in m:
            v = m[cid]
            if v is not None and fts[i].eval_type is EvalType.INT and fts[i].is_unsigned and v < 0:
                v += 1 << 64
            out.append(v)
        else:
            out.append(defaults[i] if defaults else None)
    return out

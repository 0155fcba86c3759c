"""Table/index key layout.

Capability parity with reference tablecodec/tablecodec.go:34-150 (including
the course-stub bodies :74 EncodeRowKeyWithHandle and :97 DecodeRecordKey,
implemented for real here):

  record key:  t{tableID}_r{handle}
  index key:   t{tableID}_i{indexID}{encoded values...}

tableID / indexID / handle are 8-byte memcomparable signed ints so ranges
over a table/index are contiguous in the keyspace.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..mytypes import Datum
from . import keycodec
from .keycodec import encode_i64_raw as _enc_i64, decode_i64_raw as _dec_i64

TABLE_PREFIX = b"t"
RECORD_PREFIX_SEP = b"_r"
INDEX_PREFIX_SEP = b"_i"


def encode_table_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + _enc_i64(table_id)


def encode_record_prefix(table_id: int) -> bytes:
    return encode_table_prefix(table_id) + RECORD_PREFIX_SEP


def encode_row_key(table_id: int, handle: int) -> bytes:
    """reference: tablecodec.go:74 (course stub) — t{tid}_r{handle}."""
    return encode_record_prefix(table_id) + _enc_i64(handle)


def encode_row_keys_batch(table_id: int, handles) -> list:
    """Batch-encode record keys for a handle array — the native
    memcomparable batch codec when available, python otherwise (hot in
    IndexLookUp stage 2: one key per handle per batch)."""
    import numpy as np
    from .. import native
    prefix = encode_record_prefix(table_id)
    h = np.asarray(handles, dtype=np.int64)
    enc = native.mc_encode_column(h, "int")
    if enc is not None:
        # skip the flag byte: record keys embed the raw big-endian payload
        return [prefix + enc[i, 1:].tobytes() for i in range(len(h))]
    return [encode_row_key(table_id, int(v)) for v in h]


def decode_record_key(key: bytes) -> Tuple[int, int]:
    """reference: tablecodec.go:97 (course stub) — inverse of encode_row_key."""
    if len(key) != 19 or key[:1] != TABLE_PREFIX or key[9:11] != RECORD_PREFIX_SEP:
        raise ValueError(f"invalid record key {key!r}")
    return _dec_i64(key[1:9]), _dec_i64(key[11:19])


def encode_index_prefix(table_id: int, index_id: int) -> bytes:
    return encode_table_prefix(table_id) + INDEX_PREFIX_SEP + _enc_i64(index_id)


def encode_index_key(table_id: int, index_id: int, values: Sequence[Datum],
                     handle: Optional[int] = None,
                     unsigned_flags: Optional[Sequence[bool]] = None) -> bytes:
    """Index key; for non-unique indexes the handle is appended to the key to
    disambiguate duplicates (reference: tables/index.go:103)."""
    key = encode_index_prefix(table_id, index_id) + keycodec.encode_key(values, unsigned_flags)
    if handle is not None:
        out = bytearray()
        keycodec.encode_int(out, handle)
        key += bytes(out)
    return key


def decode_index_key(key: bytes) -> Tuple[int, int, List[Datum]]:
    if key[:1] != TABLE_PREFIX or key[9:11] != INDEX_PREFIX_SEP:
        raise ValueError(f"invalid index key {key!r}")
    table_id = _dec_i64(key[1:9])
    index_id = _dec_i64(key[11:19])
    values = keycodec.decode_key(key[19:])
    return table_id, index_id, values


def is_record_key(key: bytes) -> bool:
    return len(key) >= 11 and key[:1] == TABLE_PREFIX and key[9:11] == RECORD_PREFIX_SEP


def is_index_key(key: bytes) -> bool:
    return len(key) >= 11 and key[:1] == TABLE_PREFIX and key[9:11] == INDEX_PREFIX_SEP


def decode_table_id(key: bytes) -> int:
    if key[:1] != TABLE_PREFIX or len(key) < 9:
        raise ValueError(f"invalid table key {key!r}")
    return _dec_i64(key[1:9])


def record_range(table_id: int) -> Tuple[bytes, bytes]:
    """[start, end) covering all records of a table."""
    p = encode_record_prefix(table_id)
    return p, p + b"\xff" * 9


def index_range(table_id: int, index_id: int) -> Tuple[bytes, bytes]:
    p = encode_index_prefix(table_id, index_id)
    return p, p + b"\xff" * 200

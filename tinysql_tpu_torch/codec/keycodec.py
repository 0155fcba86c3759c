"""Order-preserving (memcomparable) scalar key codec.

Capability parity with reference util/codec/codec.go:746 + number.go +
bytes.go: encoded byte strings compare (memcmp) in the same order as the
source datums, with NULL sorting first.  This is the foundation of every KV
key in the system (tablecodec, index keys, ranges).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

from ..mytypes import Datum

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
INT_FLAG = 0x03
UINT_FLAG = 0x04
FLOAT_FLAG = 0x05
MAX_FLAG = 0xFA

_SIGN_MASK = 0x8000000000000000
_GROUP = 8
_PAD = 0x00
_MARKER = 0xFF


def encode_i64_raw(v: int) -> bytes:
    """Flagless memcomparable int64 (shared with tablecodec key layout)."""
    return struct.pack(">Q", (v & 0xFFFFFFFFFFFFFFFF) ^ _SIGN_MASK)


def decode_i64_raw(b: bytes) -> int:
    (u,) = struct.unpack(">Q", b)
    u ^= _SIGN_MASK
    return u - (1 << 64) if u >= (1 << 63) else u


def encode_int(out: bytearray, v: int) -> None:
    out.append(INT_FLAG)
    out += encode_i64_raw(v)


def encode_uint(out: bytearray, v: int) -> None:
    out.append(UINT_FLAG)
    out += struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)


def encode_float(out: bytearray, f: float) -> None:
    out.append(FLOAT_FLAG)
    if f == 0.0:
        f = 0.0  # normalize -0.0: SQL equality must give one key
    (u,) = struct.unpack(">Q", struct.pack(">d", f))
    if u & _SIGN_MASK:
        u ^= 0xFFFFFFFFFFFFFFFF
    else:
        u ^= _SIGN_MASK
    out += struct.pack(">Q", u)


def encode_bytes(out: bytearray, data: bytes) -> None:
    """8-byte-group escape encoding (reference: util/codec/bytes.go
    EncodeBytes): pad each group to 8 with 0x00 and append a marker byte
    0xFF - pad_count; full groups get marker 0xFF."""
    out.append(BYTES_FLAG)
    i = 0
    n = len(data)
    while True:
        group = data[i:i + _GROUP]
        pad = _GROUP - len(group)
        out += group
        out += bytes([_PAD]) * pad
        out.append(_MARKER - pad)
        i += _GROUP
        if pad > 0:
            break
        if i == n:
            # length is a multiple of 8: emit an all-pad trailing group
            out += bytes([_PAD]) * _GROUP
            out.append(_MARKER - _GROUP)
            break


def decode_bytes(buf: bytes, pos: int) -> Tuple[bytes, int]:
    data = bytearray()
    while True:
        if pos + _GROUP + 1 > len(buf):
            raise ValueError("truncated bytes encoding")
        group = buf[pos:pos + _GROUP]
        marker = buf[pos + _GROUP]
        pos += _GROUP + 1
        pad = _MARKER - marker
        if pad == 0:
            data += group
        elif 0 < pad <= _GROUP:
            if any(group[_GROUP - pad:]):
                # native mc_decode_bytes rejects non-zero padding; corrupt
                # keys must decode identically with or without the library
                raise ValueError("corrupt bytes encoding: non-zero padding")
            data += group[:_GROUP - pad]
            break
        else:
            raise ValueError(f"corrupt bytes-encoding marker {marker:#x}")
    return bytes(data), pos


def encode_datum(out: bytearray, v: Datum, unsigned: bool = False) -> None:
    if v is None:
        out.append(NIL_FLAG)
    elif isinstance(v, bool):
        encode_int(out, int(v))
    elif isinstance(v, int):
        if unsigned:
            encode_uint(out, v)
        else:
            encode_int(out, v)
    elif isinstance(v, float):
        encode_float(out, v)
    elif isinstance(v, str):
        encode_bytes(out, v.encode("utf-8", "surrogateescape"))
    elif isinstance(v, bytes):
        encode_bytes(out, v)
    else:
        raise TypeError(f"cannot key-encode {v!r}")


def encode_key(values: Sequence[Datum], unsigned_flags: Optional[Sequence[bool]] = None) -> bytes:
    out = bytearray()
    for i, v in enumerate(values):
        encode_datum(out, v, unsigned_flags[i] if unsigned_flags else False)
    return bytes(out)


def decode_one(buf: bytes, pos: int) -> Tuple[Datum, int]:
    if pos >= len(buf):
        raise ValueError("empty key buffer")
    flag = buf[pos]
    pos += 1
    if flag in (INT_FLAG, UINT_FLAG, FLOAT_FLAG) and pos + 8 > len(buf):
        raise ValueError("truncated key buffer")
    if flag == NIL_FLAG:
        return None, pos
    if flag == INT_FLAG:
        (u,) = struct.unpack_from(">Q", buf, pos)
        u ^= _SIGN_MASK
        v = u - (1 << 64) if u >= (1 << 63) else u
        return v, pos + 8
    if flag == UINT_FLAG:
        (u,) = struct.unpack_from(">Q", buf, pos)
        return u, pos + 8
    if flag == FLOAT_FLAG:
        (u,) = struct.unpack_from(">Q", buf, pos)
        if u & _SIGN_MASK:
            u ^= _SIGN_MASK
        else:
            u ^= 0xFFFFFFFFFFFFFFFF
        (f,) = struct.unpack(">d", struct.pack(">Q", u))
        return f, pos + 8
    if flag == BYTES_FLAG:
        b, pos = decode_bytes(buf, pos)
        # deterministic type: BYTES always decodes to str; surrogateescape
        # makes arbitrary binary round-trip losslessly through the str form
        return b.decode("utf-8", "surrogateescape"), pos
    raise ValueError(f"bad codec flag {flag:#x} at {pos - 1}")


def decode_key(buf: bytes) -> List[Datum]:
    out: List[Datum] = []
    pos = 0
    while pos < len(buf):
        v, pos = decode_one(buf, pos)
        out.append(v)
    return out

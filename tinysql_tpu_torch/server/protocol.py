"""MySQL protocol payloads: handshake, OK/ERR/EOF, column definitions,
text-protocol resultset rows (reference: server/conn.go writeInitialHandshake
:117, readOptionalSSLRequestAndHandshakeResponse :418, writeOK/writeError,
writeResultset :931-1050).
"""
from __future__ import annotations

import os
import struct
from typing import List, Optional

from ..mytypes import EvalType, FieldType
from .packetio import lenenc_int, lenenc_str, read_lenenc_int, read_nul_str

SERVER_VERSION = "5.7.25-tinysql-tpu-1.0"

# capability flags (subset)
CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_FOUND_ROWS = 1 << 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_SSL = 1 << 11
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_MULTI_STATEMENTS = 1 << 16
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19

SERVER_CAPS = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
               | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41
               | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
               | CLIENT_MULTI_STATEMENTS | CLIENT_MULTI_RESULTS
               | CLIENT_PLUGIN_AUTH)

SERVER_STATUS_AUTOCOMMIT = 0x0002
SERVER_MORE_RESULTS_EXISTS = 0x0008

# MySQL column types
TYPE_LONGLONG = 0x08
TYPE_DOUBLE = 0x05
TYPE_VAR_STRING = 0xFD

# commands
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19


def handshake_v10(conn_id: int, salt: bytes,
                  caps: int = SERVER_CAPS) -> bytes:
    out = bytearray()
    out.append(10)  # protocol version
    out += SERVER_VERSION.encode() + b"\x00"
    out += struct.pack("<I", conn_id)
    out += salt[:8] + b"\x00"
    out += struct.pack("<H", caps & 0xFFFF)
    out.append(0x21)  # charset utf8
    out += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
    out += struct.pack("<H", (caps >> 16) & 0xFFFF)
    out.append(21)  # auth plugin data len
    out += b"\x00" * 10
    out += salt[8:20] + b"\x00"
    out += b"mysql_native_password\x00"
    return bytes(out)


def parse_handshake_response(payload: bytes) -> dict:
    caps = struct.unpack_from("<I", payload, 0)[0]
    pos = 4 + 4 + 1 + 23  # caps, max packet, charset, reserved
    user, pos = read_nul_str(payload, pos)
    if caps & CLIENT_SECURE_CONNECTION:
        alen = payload[pos]
        auth = payload[pos + 1:pos + 1 + alen]
        pos += 1 + alen
    else:
        auth, pos = read_nul_str(payload, pos)
    db = b""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        db, pos = read_nul_str(payload, pos)
    return {"caps": caps, "user": user.decode(), "db": db.decode(),
            "auth": bytes(auth)}


def ok_packet(affected: int = 0, last_insert_id: int = 0,
              warnings: int = 0, more_results: bool = False) -> bytes:
    status = SERVER_STATUS_AUTOCOMMIT | (
        SERVER_MORE_RESULTS_EXISTS if more_results else 0)
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<H", status)
            + struct.pack("<H", warnings))


def err_packet(code: int, message: str, state: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state.encode()[:5]
            + message.encode("utf-8", "replace"))


def eof_packet(warnings: int = 0, more_results: bool = False) -> bytes:
    status = SERVER_STATUS_AUTOCOMMIT | (
        SERVER_MORE_RESULTS_EXISTS if more_results else 0)
    return (b"\xfe" + struct.pack("<H", warnings)
            + struct.pack("<H", status))


def _mysql_type(ft: Optional[FieldType]):
    if ft is None:
        return TYPE_VAR_STRING, 0x21
    et = ft.eval_type
    if et is EvalType.INT:
        return TYPE_LONGLONG, 0x3F  # binary charset for numerics
    if et is EvalType.REAL:
        return TYPE_DOUBLE, 0x3F
    return TYPE_VAR_STRING, 0x21


def column_def(name: str, ft: Optional[FieldType],
               with_default: bool = False) -> bytes:
    """Column definition 41.  with_default appends the (empty) default-
    value field COM_FIELD_LIST responses carry (reference conn.go:846
    handleFieldList: zero DefaultValueLength to keep clients happy)."""
    tp, charset = _mysql_type(ft)
    flags = ft.flag if ft is not None else 0
    out = bytearray()
    out += lenenc_str(b"def")          # catalog
    out += lenenc_str(b"")             # schema
    out += lenenc_str(b"")             # table
    out += lenenc_str(b"")             # org_table
    out += lenenc_str(name.encode())   # name
    out += lenenc_str(name.encode())   # org_name
    out.append(0x0C)                   # fixed-length fields marker
    out += struct.pack("<H", charset)
    out += struct.pack("<I", (ft.flen if ft is not None and ft.flen > 0
                              else 255))
    out.append(tp)
    out += struct.pack("<H", flags & 0xFFFF)
    out.append(0)                      # decimals
    out += b"\x00\x00"
    if with_default:
        out += lenenc_int(0)           # empty default value
    return bytes(out)


def text_row(values: List[object]) -> bytes:
    out = bytearray()
    for v in values:
        if v is None:
            out += b"\xfb"
        else:
            if isinstance(v, float):
                s = repr(v)
            else:
                s = str(v)
            out += lenenc_str(s.encode("utf-8", "surrogateescape"))
    return bytes(out)


def binary_row(values: List[object],
               fields: Optional[List[Optional[FieldType]]] = None) -> bytes:
    """Binary-protocol resultset row (reference server/util.go:171
    dumpBinaryRow): 0x00 header, NULL bitmap with a 2-bit offset, then
    per-column wire values — int64 little-endian, float64 IEEE bits,
    strings length-encoded."""
    ncols = len(values)
    nmap = bytearray((ncols + 7 + 2) // 8)
    body = bytearray()
    fts = fields if fields is not None and len(fields) == ncols \
        else [None] * ncols
    for i, (v, ft) in enumerate(zip(values, fts)):
        if v is None:
            pos = i + 2
            nmap[pos // 8] |= 1 << (pos % 8)
            continue
        et = ft.eval_type if ft is not None else None
        if et is EvalType.INT or (et is None and isinstance(v, int)
                                  and not isinstance(v, bool)):
            # two's-complement longlong covers signed and unsigned
            body += struct.pack("<Q", int(v) & 0xFFFFFFFFFFFFFFFF)
        elif et is EvalType.REAL or (et is None and isinstance(v, float)):
            body += struct.pack("<d", float(v))
        else:
            body += lenenc_str(str(v).encode("utf-8", "surrogateescape"))
    return b"\x00" + bytes(nmap) + bytes(body)


def prepare_ok(stmt_id: int, n_params: int, n_cols: int = 0) -> bytes:
    """COM_STMT_PREPARE response header packet."""
    return (b"\x00" + struct.pack("<I", stmt_id)
            + struct.pack("<H", n_cols) + struct.pack("<H", n_params)
            + b"\x00" + struct.pack("<H", 0))


def split_placeholders(sql: str) -> List[str]:
    """Split sql on '?' placeholders OUTSIDE quoted strings/identifiers
    and comments (same comment syntax the lexer strips: '-- ', '#',
    '/*...*/'); len(result) - 1 is the parameter count."""
    parts = []
    cur = []
    quote = None
    n = len(sql)
    i = 0
    while i < n:
        ch = sql[i]
        if quote:
            cur.append(ch)
            if ch == "\\" and quote != "`" and i + 1 < n:
                cur.append(sql[i + 1])
                i += 2
                continue
            if ch == quote:
                quote = None
            i += 1
            continue
        if ch == "#" or (ch == "-" and (sql[i:i + 3] in ("-- ", "--\t",
                                                         "--\n")
                                        or sql[i:i + 2] == "--"
                                        and i + 2 == n)):
            j = sql.find("\n", i)
            j = n if j < 0 else j
            cur.append(sql[i:j])
            i = j
            continue
        if ch == "/" and sql[i:i + 2] == "/*":
            j = sql.find("*/", i + 2)
            j = n - 2 if j < 0 else j
            cur.append(sql[i:j + 2])
            i = j + 2
            continue
        if ch in ("'", '"', "`"):
            quote = ch
            cur.append(ch)
        elif ch == "?":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


def decode_execute_params(payload: bytes, n_params: int,
                          prev_types: Optional[list]):
    """COM_STMT_EXECUTE payload -> (stmt_id, values, types).  Binary
    protocol parameter block: NULL bitmap (no offset), new-params-bound
    flag, type pairs, then wire values (longlong/double/lenenc subset —
    the engine's three type families)."""
    stmt_id = struct.unpack_from("<I", payload, 0)[0]
    pos = 9  # id(4) + flags(1) + iteration_count(4)
    if n_params == 0:
        return stmt_id, [], prev_types
    nmap_len = (n_params + 7) // 8
    nmap = payload[pos:pos + nmap_len]
    pos += nmap_len
    bound = payload[pos]
    pos += 1
    if bound:
        types = [(payload[pos + 2 * i], payload[pos + 2 * i + 1])
                 for i in range(n_params)]
        pos += 2 * n_params
    else:
        types = prev_types
    if types is None:
        raise ValueError("no parameter types bound")
    vals: List[object] = []
    for i, (tp, flag) in enumerate(types):
        if nmap[i // 8] & (1 << (i % 8)):
            vals.append(None)
            continue
        unsigned = bool(flag & 0x80)
        if tp == 0x01:    # TINY
            v = payload[pos] if unsigned \
                else struct.unpack_from("<b", payload, pos)[0]
            pos += 1
        elif tp in (0x02, 0x0D):  # SHORT / YEAR
            v = struct.unpack_from("<H" if unsigned else "<h",
                                   payload, pos)[0]
            pos += 2
        elif tp in (0x03, 0x09):  # LONG / INT24
            v = struct.unpack_from("<I" if unsigned else "<i",
                                   payload, pos)[0]
            pos += 4
        elif tp == 0x08:  # LONGLONG
            v = struct.unpack_from("<Q" if unsigned else "<q",
                                   payload, pos)[0]
            pos += 8
        elif tp == 0x04:  # FLOAT
            v = struct.unpack_from("<f", payload, pos)[0]
            pos += 4
        elif tp == 0x05:  # DOUBLE
            v = struct.unpack_from("<d", payload, pos)[0]
            pos += 8
        elif tp == 0x06:  # NULL
            v = None
        elif tp in (0x0F, 0xFC, 0xFD, 0xFE):  # VARCHAR/BLOB/VAR_STRING/STRING
            ln, pos = read_lenenc_int(payload, pos)
            v = payload[pos:pos + ln].decode("utf-8", "surrogateescape")
            pos += ln
        else:
            raise ValueError(f"unsupported parameter type 0x{tp:02x}")
        vals.append(v)
    return stmt_id, vals, types


def literal(v: object) -> str:
    """Render a decoded parameter as a SQL literal for substitution."""
    import math
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            # 'inf'/'nan' are not SQL literals; reject cleanly rather
            # than surface a confusing parse error
            raise ValueError("non-finite double parameter")
        return repr(v)
    s = str(v).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{s}'"


def new_salt() -> bytes:
    # printable, non-zero bytes per protocol convention
    return bytes((b % 93) + 33 for b in os.urandom(20))

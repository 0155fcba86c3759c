"""MySQL packet framing: 3-byte little-endian length + 1-byte sequence id
(reference: server/packetio.go readPacket/writePacket).

Oversized payloads split at 0xFFFFFF per the protocol; sequence ids are
tracked per round-trip.
"""
from __future__ import annotations

import socket
import struct
from typing import Optional

MAX_PAYLOAD = 0xFFFFFF


class PacketIO:
    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.sequence = 0
        self._buf: Optional[bytearray] = None

    def reset_sequence(self) -> None:
        self.sequence = 0

    def begin_buffer(self) -> None:
        """Frame subsequent packets into one buffer; flush() sends them in
        a single syscall (reference: bufio writer in server/packetio.go)."""
        if self._buf is None:
            self._buf = bytearray()

    def flush(self) -> None:
        buf, self._buf = self._buf, None
        if buf:
            self.conn.sendall(bytes(buf))

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.conn.recv(n - len(buf))
            if not part:
                raise ConnectionError("connection closed")
            buf += part
        return buf

    def read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self._read_exact(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.sequence = (header[3] + 1) & 0xFF
            payload += self._read_exact(length) if length else b""
            if length < MAX_PAYLOAD:
                return payload

    def write_packet(self, payload: bytes) -> None:
        out = bytearray()
        pos = 0
        while True:
            part = payload[pos:pos + MAX_PAYLOAD]
            out += struct.pack("<I", len(part))[:3]
            out.append(self.sequence)
            self.sequence = (self.sequence + 1) & 0xFF
            out += part
            pos += len(part)
            if len(part) < MAX_PAYLOAD:
                break
        if self._buf is not None:
            self._buf += out
        else:
            self.conn.sendall(bytes(out))


# ---- lenenc helpers --------------------------------------------------------

def lenenc_int(v: int) -> bytes:
    if v < 251:
        return bytes([v])
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + struct.pack("<I", v)[:3]
    return b"\xfe" + struct.pack("<Q", v)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_int(buf: bytes, pos: int):
    first = buf[pos]
    if first < 251:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def read_nul_str(buf: bytes, pos: int):
    end = buf.index(0, pos)
    return buf[pos:end], end + 1

"""mysql_native_password authentication (reference: server/conn.go:418
openSessionAndDoAuth — tinysql STRIPS the scramble check that full TiDB
performs there; this build restores it: privilege/auth CheckScrambledPassword
semantics against a bootstrapped mysql.user table).

Scheme: the server sends a 20-byte salt in the v10 handshake; the client
responds with  token = SHA1(pw) XOR SHA1(salt + SHA1(SHA1(pw))).  The
server stores only  '*' + HEX(SHA1(SHA1(pw)))  (MySQL's PASSWORD() hash),
recovers SHA1(pw) from the token, and re-hashes to compare.

The system-table sessions run on the server's device (``device``; None
means the current CUDA device, as for every port session).
"""
from __future__ import annotations

import hashlib


def hash_password(password: str) -> str:
    """MySQL PASSWORD(): '*' + HEX(SHA1(SHA1(pw))); '' stays ''."""
    if not password:
        return ""
    h = hashlib.sha1(hashlib.sha1(password.encode()).digest()).hexdigest()
    return "*" + h.upper()


def scramble(password: str, salt: bytes) -> bytes:
    """Client-side token (used by tests' raw-socket client)."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    x = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, x))


def check_scramble(token: bytes, salt: bytes, stored: str) -> bool:
    """Server-side verification against the stored PASSWORD() hash."""
    if not stored:
        return len(token) == 0  # empty password accepts only empty token
    if len(token) != 20 or len(stored) != 41 or not stored.startswith("*"):
        return False
    try:
        h2 = bytes.fromhex(stored[1:])  # SHA1(SHA1(pw))
    except ValueError:
        return False
    x = hashlib.sha1(salt + h2).digest()
    h1 = bytes(a ^ b for a, b in zip(token, x))  # candidate SHA1(pw)
    return hashlib.sha1(h1).digest() == h2


def ensure_user_table(storage, device=None) -> None:
    """Bootstrap mysql.user with a passwordless root (reference:
    session/bootstrap.go:126 creates the mysql.* system tables)."""
    from ..session.session import Session
    s = Session(storage)
    s.device = device
    try:
        s.execute("create database if not exists mysql")
        s.execute("create table if not exists mysql.user ("
                  "user varchar(32) primary key, "
                  "authentication_string varchar(64))")
        if not s.query("select count(*) from mysql.user").rows[0][0]:
            s.execute("insert into mysql.user values ('root', '')")
    finally:
        s.rollback_txn()


def lookup_auth_string(storage, user: str, device=None):
    """Stored hash for `user`, or None when the user does not exist.
    The username is matched in PYTHON, never interpolated into SQL — a
    crafted username must not be able to escape a string literal."""
    from ..session.session import Session
    s = Session(storage)
    s.device = device
    try:
        rows = s.query(
            "select user, authentication_string from mysql.user").rows
    finally:
        s.rollback_txn()
    for u, h in rows:
        if u == user:
            return h if h is not None else ""
    return None

"""Structured JSONL slow-query log (reference: executor/adapter.go
LogSlowQuery + the slow-log parser's field contract).

Replaces the inline ``logging.warning("slow query ...")`` in
session/session.py with one JSON object per slow statement: timings,
plan digest, per-query device counters, and per-operator RuntimeStats —
enough to answer "where did the time go" without re-running the query.
``conn_id`` / ``db`` / ``success`` / ``sql_digest`` make every record
joinable against ``information_schema.statements_summary`` and
``processlist`` (the ``slow_query`` mem-table reads the ring below).

Destinations:
- the ``tinysql_tpu.slowlog`` logger (one JSON line per record);
- an append-only JSONL file when ``TINYSQL_SLOW_LOG`` names a path
  (resolved once per env value, not per record).
  ``TINYSQL_SLOW_LOG_MAX_BYTES`` caps it: when an append would grow the
  file past the cap, the current file rotates to ``<path>.1``
  (tmp→rename, one rotated generation — the reference keeps bounded
  slow-log files the same way) and the append starts a fresh file.
  Rotation is file-plumbing only: the in-process ring and the
  ``slow_query`` mem-table never change behavior;
- an in-process ring (``recent``) for tests, debug endpoints, and the
  ``slow_query`` mem-table — ``TINYSQL_SLOW_LOG_RING`` sizes it
  (default 64; applied on the next :func:`clear`).

The threshold lives in the ``tidb_slow_log_threshold`` sysvar
(milliseconds, default 300 — the reference's default).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

LOGGER = logging.getLogger("tinysql_tpu.slowlog")

DEFAULT_RING = 64


def _ring_maxlen() -> int:
    try:
        n = int(os.environ.get("TINYSQL_SLOW_LOG_RING", DEFAULT_RING))
    except ValueError:
        n = DEFAULT_RING
    return n if n > 0 else DEFAULT_RING


_mu = threading.Lock()
_RING: deque = deque(maxlen=_ring_maxlen())

#: (raw env value, resolved absolute path) — the path is resolved ONCE
#: per distinct env value instead of per record; tests that monkeypatch
#: the env var get a fresh resolution automatically
_PATH_CACHE: Tuple[Optional[str], Optional[str]] = (None, None)


def _log_path() -> Optional[str]:
    global _PATH_CACHE
    raw = os.environ.get("TINYSQL_SLOW_LOG")
    cached_raw, cached_path = _PATH_CACHE
    if raw == cached_raw:
        return cached_path
    path = os.path.abspath(raw) if raw else None
    _PATH_CACHE = (raw, path)
    return path


def build_record(sql: str, info: dict, qobs=None, *, conn_id: int = 0,
                 db: str = "", success: bool = True,
                 sql_digest: str = "") -> dict:
    """One slow-log record; ``info`` is the session's per-statement
    timing dict (parse_s is the per-BATCH parse wall, reported once).
    ``conn_id``/``db``/``success``/``sql_digest`` are the join keys the
    ``slow_query`` mem-table exposes."""
    rec = {
        "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime()),
        "sql": sql[:2048].replace("\n", " "),
        "conn_id": int(conn_id),
        "db": db,
        "success": bool(success),
        "total_ms": round(info.get("total_s", 0.0) * 1e3, 3),
        "parse_ms": round(info.get("parse_s", 0.0) * 1e3, 3),
        "plan_ms": round(info.get("plan_s", 0.0) * 1e3, 3),
        "exec_ms": round(info.get("exec_s", 0.0) * 1e3, 3),
        # serving-path wait attribution (server/pool.py measurement):
        # whether this slow statement was slow because it RAN slow or
        # because it WAITED — queue wait is outside total_ms
        "queue_wait_ms": round(info.get("queue_s", 0.0) * 1e3, 3),
        "batch_wait_ms": round(info.get("batch_s", 0.0) * 1e3, 3),
    }
    if sql_digest:
        rec["sql_digest"] = sql_digest
    if qobs is not None:
        rec["plan_digest"] = qobs.plan_digest
        rec["device"] = qobs.device_totals()
        rec["operators"] = qobs.operators()
        if qobs.admission_verdict:
            rec["admission_verdict"] = qobs.admission_verdict
    return rec


def _max_bytes() -> int:
    """``TINYSQL_SLOW_LOG_MAX_BYTES`` (0/absent/junk = unbounded)."""
    try:
        return max(0, int(os.environ.get("TINYSQL_SLOW_LOG_MAX_BYTES",
                                         "0")))
    except ValueError:
        return 0


def _maybe_rotate(path: str, incoming: int) -> None:
    """Size-capped rotation: if appending ``incoming`` bytes would push
    the file past the cap, move it aside as ``<path>.1`` (via a tmp
    name so a crash mid-rotation never leaves ``.1`` half-replaced)."""
    cap = _max_bytes()
    if cap <= 0:
        return
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size + incoming <= cap:
        return
    tmp = path + ".1.tmp"
    try:
        os.replace(path, tmp)
        os.replace(tmp, path + ".1")
    except OSError:
        pass  # rotation is best-effort, like the append itself


def log_slow(record: dict) -> None:
    line = json.dumps(record, default=str, sort_keys=True)
    LOGGER.warning("%s", line)
    path = _log_path()
    if path:
        try:
            _maybe_rotate(path, len(line) + 1)
            with open(path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        except OSError:
            pass  # a full disk must not fail the query
    with _mu:
        _RING.append(record)


def recent(n: Optional[int] = None) -> List[dict]:
    with _mu:
        out = list(_RING)
    return out[-n:] if n else out


def clear() -> None:
    """Drop buffered records; re-reads ``TINYSQL_SLOW_LOG_RING`` so
    tests can resize the ring without reloading the module."""
    global _RING
    with _mu:
        _RING = deque(maxlen=_ring_maxlen())

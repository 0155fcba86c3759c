"""Virtual INFORMATION_SCHEMA mem-tables (reference: infoschema/tables.go —
schema-backed tables computed on read, no storage).

Supported: SCHEMATA, TABLES, COLUMNS, STATISTICS (index metadata) plus
the observability tables the volcano executor can scan, join, and
filter like any other source:

- ``statements_summary``: the windowed per-(sql digest, plan digest)
  aggregation store (obs/stmtsummary.py);
- ``processlist``: live sessions from the interruption registry
  (utils/interrupt.py) joined with their MemTracker bytes and elapsed
  statement time;
- ``slow_query``: the structured slow-log ring (obs/slowlog.py);
- ``metrics_history`` / ``metrics_summary``: the time-series metrics
  ring (obs/tsring.py) — raw samples, and windowed delta/rate/avg/max
  per metric ("what changed in the last N minutes");
- ``inspection_result``: the automated inspection engine's findings
  (obs/inspect.py), evaluated over the ring at scan time;
- ``compiled_programs``: the per-program catalog (ops/progcache.py) —
  dispatch counts, compile walls, measured device time, cost-analysis
  flops/bytes, joinable with ``statements_summary`` on plan_digest;
- ``continuous_profiling``: the continuous host profiler's windowed
  folded stacks (obs/conprof.py) — per (window, thread role, stack)
  sample counts and estimated cpu_ms;
- ``memory_usage``: the memory reconciliation ledger (obs/memprof.py)
  — tracked MemTracker bytes vs measured heap/RSS vs the HBM census
  with per-owner attribution and the unattributed leak bucket;
- ``flight_incarnations``: the flight recorder's run catalogue
  (obs/flight.py) — one row per process incarnation with boundaries
  and the clean-vs-torn shutdown verdict.  The history-shaped tables
  (``statements_summary_history``, ``metrics_history``,
  ``continuous_profiling``, ``inspection_result``) carry an
  ``incarnation`` column: prior runs replay read-only from the
  durable flight store, the current run is the highest id.

Rows are produced from the live InfoSchema / obs stores at query time.
The catalog lists ITSELF: ``information_schema`` appears in SCHEMATA,
and every mem-table (id -1 = virtual) in TABLES/COLUMNS, so tooling
that introspects the catalog sees the whole surface.
"""
from __future__ import annotations

import time
from typing import List, Tuple

from ..mytypes import (FieldType, new_int_type, new_real_type,
                       new_string_type)

DB_NAME = "information_schema"

_KIND = {"int": new_int_type, "str": new_string_type,
         "real": new_real_type}


def _summary_cols():
    from ..obs.stmtsummary import COLUMNS
    return [(name, kind) for name, kind in COLUMNS]


# The cross-incarnation surfaces: the history-shaped
# mem-tables gain an ``incarnation`` column — the current run is the
# highest id, prior runs replay read-only from the flight store
# (obs/flight.py).  Current-window tables (statements_summary,
# metrics_summary) stay incarnation-free: they are by definition live.

def _summary_history_cols():
    return _summary_cols() + [("incarnation", "int")]


def _metrics_history_cols():
    from ..obs.tsring import HISTORY_COLUMNS
    return list(HISTORY_COLUMNS) + [("incarnation", "int")]


def _metrics_summary_cols():
    from ..obs.tsring import SUMMARY_COLUMNS
    return list(SUMMARY_COLUMNS)


def _inspection_cols():
    from ..obs.inspect import COLUMNS
    return list(COLUMNS) + [("incarnation", "int")]


def _programs_cols():
    from ..ops.progcache import CATALOG_COLUMNS
    return list(CATALOG_COLUMNS)


def _conprof_cols():
    from ..obs.conprof import COLUMNS
    return list(COLUMNS) + [("incarnation", "int")]


def _flight_incarnation_cols():
    from ..obs.flight import INCARNATION_COLUMNS
    return list(INCARNATION_COLUMNS)


def _memory_usage_cols():
    from ..obs.memprof import MEMORY_USAGE_COLUMNS
    return list(MEMORY_USAGE_COLUMNS)


# table name -> [(column name, kind)];  statements_summary's layout is
# owned by obs/stmtsummary.COLUMNS (one definition for store + catalog)
_TABLES = {
    "schemata": [("catalog_name", "str"),
                 ("schema_name", "str")],
    "tables": [("table_schema", "str"),
               ("table_name", "str"),
               ("tidb_table_id", "int")],
    "columns": [("table_schema", "str"),
                ("table_name", "str"),
                ("column_name", "str"),
                ("ordinal_position", "int"),
                ("data_type", "str"),
                ("is_nullable", "str"),
                ("column_key", "str")],
    "statistics": [("table_schema", "str"),
                   ("table_name", "str"),
                   ("non_unique", "int"),
                   ("index_name", "str"),
                   ("seq_in_index", "int"),
                   ("column_name", "str")],
    "statements_summary": _summary_cols,
    "statements_summary_history": _summary_history_cols,
    "metrics_history": _metrics_history_cols,
    "metrics_summary": _metrics_summary_cols,
    "inspection_result": _inspection_cols,
    "compiled_programs": _programs_cols,
    "continuous_profiling": _conprof_cols,
    "flight_incarnations": _flight_incarnation_cols,
    "memory_usage": _memory_usage_cols,
    "processlist": [("id", "int"),
                    ("user", "str"),
                    ("db", "str"),
                    ("command", "str"),
                    ("time_ms", "int"),
                    ("state", "str"),
                    ("mem_bytes", "int"),
                    ("info", "str"),
                    ("plan_digest", "str")],
    "slow_query": [("time", "str"),
                   ("conn_id", "int"),
                   ("db", "str"),
                   ("success", "int"),
                   ("total_ms", "real"),
                   ("parse_ms", "real"),
                   ("plan_ms", "real"),
                   ("exec_ms", "real"),
                   ("queue_wait_ms", "real"),
                   ("batch_wait_ms", "real"),
                   ("plan_digest", "str"),
                   ("sql_digest", "str"),
                   ("query", "str")],
}


def _columns_of(table: str) -> List[Tuple[str, str]]:
    spec = _TABLES[table]
    return spec() if callable(spec) else spec


def is_memtable(db: str, table: str) -> bool:
    return db.lower() == DB_NAME and table.lower() in _TABLES


def memtable_columns(table: str) -> List[Tuple[str, FieldType]]:
    return [(n, _KIND[k]()) for n, k in _columns_of(table.lower())]


def memtable_rows(infoschema, table: str) -> List[list]:
    t = table.lower()
    if t == "statements_summary":
        from ..obs import stmtsummary
        return stmtsummary.rows()
    if t == "statements_summary_history":
        from ..obs import stmtsummary
        return _with_incarnations("summary", stmtsummary.history_rows())
    if t == "processlist":
        return _processlist_rows()
    if t == "slow_query":
        return _slow_query_rows()
    if t == "metrics_history":
        from ..obs import tsring
        return _with_incarnations("metrics", tsring.history_rows())
    if t == "metrics_summary":
        from ..obs import tsring
        return tsring.summary_rows()
    if t == "inspection_result":
        from ..obs import inspect as obs_inspect
        return _with_incarnations("findings", obs_inspect.rows())
    if t == "flight_incarnations":
        from ..obs import flight
        return flight.incarnation_rows()
    if t == "compiled_programs":
        # the per-program catalog (ops/progcache.py): dispatch counts,
        # compile walls, measured device time, cost-analysis flops/bytes
        # — joinable against statements_summary on plan_digest
        from ..ops import progcache
        return progcache.catalog_rows()
    if t == "continuous_profiling":
        # the continuous host profiler's windowed folded stacks
        # (obs/conprof.py): role, stack, samples, estimated cpu_ms —
        # the SQL face of /debug/conprof
        from ..obs import conprof
        return _with_incarnations("conprof", conprof.rows())
    if t == "memory_usage":
        # the memory reconciliation ledger (obs/memprof.py): tracked vs
        # measured vs HBM census — the SQL face of /debug/heap's truth
        from ..obs import memprof
        return memprof.memory_usage_rows()
    out: List[list] = []
    if t == "schemata":
        out.append(["def", DB_NAME])
        for db in infoschema.all_schemas():
            out.append(["def", db.name])
        return out
    for db in infoschema.all_schemas():
        for ti in infoschema.schema_tables(db.name):
            if t == "tables":
                out.append([db.name, ti.name, ti.id])
            elif t == "columns":
                for i, c in enumerate(ti.public_columns()):
                    key = "PRI" if (c.ft.flag & 0x2) else ""
                    out.append([db.name, ti.name, c.name, i + 1,
                                _type_name(c.ft),
                                "NO" if c.ft.not_null else "YES", key])
            elif t == "statistics":
                for idx in ti.public_indices():
                    for seq, ic in enumerate(idx.columns):
                        out.append([db.name, ti.name,
                                    0 if idx.unique else 1,
                                    idx.name, seq + 1, ic.name])
    # the catalog's own virtual tables (id -1: no storage behind them)
    if t == "tables":
        for name in sorted(_TABLES):
            out.append([DB_NAME, name, -1])
    elif t == "columns":
        for name in sorted(_TABLES):
            for i, (cn, ft) in enumerate(memtable_columns(name)):
                out.append([DB_NAME, name, cn, i + 1, _type_name(ft),
                            "YES", ""])
    return out


def _with_incarnations(tier: str, live_rows: List[list]) -> List[list]:
    """Cross-incarnation splice (obs/flight.py): prior runs' replayed
    rows (ascending incarnation) followed by the live rows, every row
    tagged with its incarnation id in a trailing column.  Volatile
    (no flight store armed) degrades to live rows + current id — the
    column exists either way so queries need no arming awareness."""
    from ..obs import flight
    out: List[list] = []
    for inc, rows in flight.prior_tier_rows(tier):
        out.extend(r + [inc] for r in rows)
    cur = flight.current_incarnation()
    out.extend(r + [cur] for r in live_rows)
    return out


def _processlist_rows() -> List[list]:
    """Live sessions (reference: infoschema PROCESSLIST fed from the
    server's ShowProcessList): one row per registered session; running
    statements carry their SQL, elapsed wall, and the statement
    MemTracker's live byte count.

    TIME semantics by state (documented contract, tested in
    tests/test_tsring.py): ``state='executing'`` reports elapsed wall
    since the statement began executing; ``state='queued'`` reports the
    statement's WAIT-SO-FAR in the admission queue (since pool submit) —
    not elapsed-since-statement-start, because a queued statement has
    not started.  Once a queued statement is claimed by a worker its row
    flips to 'executing' and TIME restarts from execution start; the
    full wait it accumulated is attributed separately as
    ``queue_wait_s`` (statements_summary / slow_query / span trace)."""
    from ..utils import interrupt
    now = time.time()
    out: List[list] = []
    for cid, sess in interrupt.sessions():
        running = bool(getattr(sess, "stmt_running", False))
        queued = not running and \
            getattr(sess, "stmt_state", "") == "queued"
        qobs = getattr(sess, "last_query_stats", None)
        elapsed_ms = 0
        mem = 0
        info = ""
        digest = ""
        if running and qobs is not None:
            elapsed_ms = int((now - qobs.started_at) * 1e3)
            info = qobs.sql[:512]
            digest = qobs.plan_digest
            mt = getattr(sess, "_stmt_mem", None)
            if mt is not None:
                mem = mt.consumed
        elif queued:
            # waiting in the statement pool's admission queue
            # (server/pool.py): no worker yet, so no obs scope / memory
            # — but the statement and its wait are live, KILLable state
            info = getattr(sess, "pending_sql", "")[:512]
            elapsed_ms = int((now - getattr(sess, "queue_ts", now)) * 1e3)
        out.append([cid, getattr(sess, "user", "") or "",
                    getattr(sess, "current_db", ""),
                    "Query" if running or queued else "Sleep", elapsed_ms,
                    "executing" if running
                    else ("queued" if queued else ""), mem, info, digest])
    out.sort(key=lambda r: r[0])
    return out


def _slow_query_rows() -> List[list]:
    from ..obs import slowlog
    out: List[list] = []
    for r in slowlog.recent():
        out.append([r.get("time", ""), int(r.get("conn_id", 0) or 0),
                    r.get("db", ""),
                    1 if r.get("success", True) else 0,
                    float(r.get("total_ms", 0.0)),
                    float(r.get("parse_ms", 0.0)),
                    float(r.get("plan_ms", 0.0)),
                    float(r.get("exec_ms", 0.0)),
                    float(r.get("queue_wait_ms", 0.0)),
                    float(r.get("batch_wait_ms", 0.0)),
                    r.get("plan_digest", "") or "",
                    r.get("sql_digest", "") or "",
                    r.get("sql", "")])
    return out


def _type_name(ft: FieldType) -> str:
    et = ft.eval_type.name
    if et == "INT":
        return "bigint unsigned" if ft.is_unsigned else "bigint"
    if et == "REAL":
        return "double"
    return "varchar"

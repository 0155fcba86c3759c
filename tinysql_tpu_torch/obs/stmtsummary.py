"""Statement summary: the windowed, evicting per-digest aggregation
store behind ``information_schema.statements_summary`` (reference:
util/stmtsummary/statement_summary.go + infoschema/tables.go).

Every finished statement is folded into one :class:`StmtRecord` keyed by
``(normalized-SQL digest, plan digest)``: execution count, sum/max
latency per phase (parse/plan/exec/total), the per-query device
counters (program dispatches, packed D2H transfers/bytes, compile-cache
hits/misses, pipeline blocks), high-water memory, rows returned,
first/last seen, and a sample of the raw SQL + rendered plan.  The
aggregates double as the steady-state feedback signal the cost model
and bucket prewarming read per plan digest.

Window + eviction semantics (the reference's sysvars):

- ``tidb_stmt_summary_refresh_interval`` (seconds): when the current
  window is older than the interval, it rotates into a bounded history
  and aggregation restarts — ``statements_summary`` always shows the
  CURRENT window.
- ``tidb_stmt_summary_max_stmt_count``: at most N distinct keys per
  window; adding key N+1 evicts the least-recently-seen record into a
  single ``evicted`` tombstone row that keeps aggregating (so totals
  stay accountable even when cardinality explodes).

Latency histograms: every ingest also feeds per-phase exponential
histograms (process-cumulative, never rotated) that ``/metrics`` renders
as ``tinysql_stmt_phase_seconds`` — the summary store is the single
write path for both surfaces.

WRITE DISCIPLINE (enforced by qlint OB403): :func:`ingest` — and the
store's mutating methods — may be called ONLY from the session's
statement-close hook (``session/session.py _finish_obs``).  Any other
writer would double-count statements or bypass the window/eviction
accounting.  Reads (``rows``, ``snapshot``, ``histogram_snapshot``,
``normalize``) are fine anywhere.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

DEFAULT_REFRESH_INTERVAL_S = 1800
DEFAULT_MAX_STMT_COUNT = 200

#: phases the ingest path buckets into the /metrics histograms; "queue"
#: is the serving-path wait a pooled statement spent waiting for a
#: worker (info key queue_s, measured by server/pool.py) — so a p99
#: regression can be split into queue wait vs execution straight from
#: the histogram
HIST_PHASES = ("parse", "plan", "exec", "queue")

#: phase keys folded into per-record sum/max aggregates ("total" is the
#: statement wall; "queue"/"batch" are serving-path waits OUTSIDE it)
_FOLD_PHASES = ("parse", "plan", "exec", "total", "queue", "batch")

#: upper bounds (seconds) of the latency histogram buckets; +Inf implied
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

EVICTED_DIGEST = "evicted"


def normalize(sql: str) -> Tuple[str, str]:
    """``(digest, normalized text)`` of a statement: literals become
    ``?``, unquoted identifiers/keywords lowercase, whitespace collapses
    — so ``SELECT * FROM t WHERE a = 5`` and ``select * from t where
    a=7`` share one digest (reference: parser.Normalize/DigestHash).
    Unlexable input falls back to whitespace-collapsed raw text."""
    from ..parser.lexer import (T_FLOAT, T_INT, T_QIDENT, T_STRING,
                                tokenize)
    try:
        toks = tokenize(sql)
    except Exception:
        text = " ".join(sql.split()).lower()
        return _digest_of(text), text[:1024]
    parts: List[str] = []
    for t in toks:
        if t.kind in (T_INT, T_FLOAT, T_STRING):
            parts.append("?")
        elif t.kind == T_QIDENT:
            parts.append(f"`{t.value}`")
        else:
            parts.append(str(t.text).lower())
    text = " ".join(parts)
    return _digest_of(text), text[:1024]


def _digest_of(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def plan_text(plan_rows) -> str:
    """Flatten rendered EXPLAIN rows (id/estRows/task/info) into the
    sample-plan string stored on a record."""
    if not plan_rows:
        return ""
    return "\n".join("\t".join(str(c) for c in r) for r in plan_rows)


_flatten_plan = plan_text  # ingest's local `plan_text` param shadows it


def _ts(epoch: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(epoch))


class StmtRecord:
    """One (sql digest, plan digest) aggregate within a window."""

    __slots__ = ("sql_digest", "digest_text", "plan_digest", "stmt_type",
                 "schema_name", "exec_count", "sum_errors", "sum_ms",
                 "max_ms", "device", "max_mem", "sum_rows", "first_seen",
                 "last_seen", "sample_sql", "sample_plan", "queued_count",
                 "max_spill_bytes", "spill_count", "max_heap_kb")

    def __init__(self, sql_digest: str, digest_text: str,
                 plan_digest: str):
        self.sql_digest = sql_digest
        self.digest_text = digest_text
        self.plan_digest = plan_digest
        self.stmt_type = ""
        self.schema_name = ""
        self.exec_count = 0
        self.sum_errors = 0
        self.sum_ms: Dict[str, float] = {}
        self.max_ms: Dict[str, float] = {}
        self.device: Dict[str, float] = {}
        self.max_mem = 0
        self.sum_rows = 0
        self.first_seen = 0.0
        self.last_seen = 0.0
        self.sample_sql = ""
        self.sample_plan = ""
        self.queued_count = 0
        self.max_spill_bytes = 0
        self.spill_count = 0
        self.max_heap_kb = 0.0

    def fold(self, *, stmt_type: str, schema_name: str,
             info: Dict[str, float], device: Dict[str, float],
             rows_returned: int, error: bool, max_mem: int, sql: str,
             plan: str, now: float, queued: bool = False) -> None:
        self.exec_count += 1
        if error:
            self.sum_errors += 1
        if queued:
            self.queued_count += 1
        self.stmt_type = stmt_type or self.stmt_type
        self.schema_name = schema_name or self.schema_name
        for phase in _FOLD_PHASES:
            ms = float(info.get(f"{phase}_s", 0.0)) * 1e3
            self.sum_ms[phase] = self.sum_ms.get(phase, 0.0) + ms
            if ms > self.max_ms.get(phase, 0.0):
                self.max_ms[phase] = ms
        for k, v in device.items():
            self.device[k] = self.device.get(k, 0) + v
        # memory-adaptive execution: this EXECUTION's spill volume (the
        # device dict is per-statement, so the max/count fold here)
        sp = int(device.get("spill_bytes", 0))
        if sp > 0:
            self.spill_count += 1
            if sp > self.max_spill_bytes:
                self.max_spill_bytes = sp
        # heap truth (obs/memprof.py): this EXECUTION's traced-heap high
        # water (the hwm counter is per-statement, so the max folds here;
        # heap_kb sums through the device loop above)
        hk = float(device.get("heap_peak_kb", 0.0))
        if hk > self.max_heap_kb:
            self.max_heap_kb = hk
        if max_mem > self.max_mem:
            self.max_mem = int(max_mem)
        self.sum_rows += int(rows_returned)
        if not self.first_seen:
            self.first_seen = now
        self.last_seen = now
        if sql and not self.sample_sql:
            self.sample_sql = sql[:2048]
        if plan and not self.sample_plan:
            self.sample_plan = plan[:4096]

    def merge(self, other: "StmtRecord") -> None:
        """Fold ``other`` into this record (tombstone accounting)."""
        self.exec_count += other.exec_count
        self.sum_errors += other.sum_errors
        self.queued_count += other.queued_count
        for p, v in other.sum_ms.items():
            self.sum_ms[p] = self.sum_ms.get(p, 0.0) + v
        for p, v in other.max_ms.items():
            if v > self.max_ms.get(p, 0.0):
                self.max_ms[p] = v
        for k, v in other.device.items():
            self.device[k] = self.device.get(k, 0) + v
        self.max_mem = max(self.max_mem, other.max_mem)
        self.max_spill_bytes = max(self.max_spill_bytes,
                                   other.max_spill_bytes)
        self.spill_count += other.spill_count
        self.max_heap_kb = max(self.max_heap_kb, other.max_heap_kb)
        self.sum_rows += other.sum_rows
        if other.first_seen and (not self.first_seen
                                 or other.first_seen < self.first_seen):
            self.first_seen = other.first_seen
        self.last_seen = max(self.last_seen, other.last_seen)

    def _overlap_frac(self) -> float:
        if not self.device.get("pipe_blocks"):
            return 0.0
        try:
            from ..ops.kernels import pipe_overlap_frac
            return round(pipe_overlap_frac(self.device), 4)
        except Exception:
            return 0.0

    def row(self, window_begin: float) -> list:
        d = self.device
        return [
            _ts(window_begin), self.sql_digest, self.digest_text,
            self.plan_digest, self.stmt_type, self.schema_name,
            self.exec_count, self.sum_errors,
            round(self.sum_ms.get("total", 0.0), 3),
            round(self.max_ms.get("total", 0.0), 3),
            round(self.sum_ms.get("parse", 0.0), 3),
            round(self.max_ms.get("parse", 0.0), 3),
            round(self.sum_ms.get("plan", 0.0), 3),
            round(self.max_ms.get("plan", 0.0), 3),
            round(self.sum_ms.get("exec", 0.0), 3),
            round(self.max_ms.get("exec", 0.0), 3),
            round(self.sum_ms.get("queue", 0.0), 3),
            round(self.max_ms.get("queue", 0.0), 3),
            round(self.sum_ms.get("batch", 0.0), 3),
            self.queued_count,
            int(d.get("dispatches", 0)), int(d.get("d2h_transfers", 0)),
            int(d.get("d2h_bytes", 0)),
            int(d.get("h2d_transfers", 0)), int(d.get("h2d_bytes", 0)),
            int(d.get("progcache_hits", 0)),
            int(d.get("progcache_misses", 0)),
            # device-time truth: MEASURED device busy ms from
            # profiled dispatches (0 with tidb_device_profile_rate=0)
            # and the program-build wall attributed to these executions
            round(float(d.get("device_s", 0.0)) * 1e3, 3),
            int(d.get("profiled_dispatches", 0)),
            round(float(d.get("compile_s", 0.0)) * 1e3, 3),
            # host-CPU truth: sample-estimated on-thread ms
            # attributed by the continuous profiler (obs/conprof.py; 0
            # with tidb_conprof_rate=0 or no sampler running)
            round(float(d.get("cpu_s", 0.0)) * 1e3, 3),
            int(d.get("cpu_samples", 0)),
            # heap truth (obs/memprof.py): traced-heap growth attributed
            # to these executions (the sum across concurrent statements
            # never exceeds measured process growth) and the traced high
            # water while any of them ran (0 with tidb_memprof_rate=0)
            round(float(d.get("heap_kb", 0.0)), 1),
            round(self.max_heap_kb, 1),
            int(d.get("pipe_blocks", 0)), self._overlap_frac(),
            int(d.get("coalesced", 0)),
            int(d.get("spill_bytes", 0)), self.max_spill_bytes,
            self.spill_count,
            self.max_mem, self.sum_rows,
            _ts(self.first_seen) if self.first_seen else "",
            _ts(self.last_seen) if self.last_seen else "",
            self.sample_sql, self.sample_plan,
        ]

    def to_dict(self) -> dict:
        return {"digest": self.sql_digest, "digest_text": self.digest_text,
                "plan_digest": self.plan_digest,
                "stmt_type": self.stmt_type, "schema": self.schema_name,
                "exec_count": self.exec_count, "errors": self.sum_errors,
                "queued_count": self.queued_count,
                "sum_ms": dict(self.sum_ms), "max_ms": dict(self.max_ms),
                "device": dict(self.device), "max_mem": self.max_mem,
                "max_spill_bytes": self.max_spill_bytes,
                "spill_count": self.spill_count,
                "max_heap_kb": self.max_heap_kb,
                "rows": self.sum_rows, "sample_sql": self.sample_sql}


#: information_schema.statements_summary column order — MUST match
#: StmtRecord.row (catalog/memtables.py builds FieldTypes from this)
COLUMNS = [
    ("summary_begin_time", "str"), ("digest", "str"),
    ("digest_text", "str"), ("plan_digest", "str"), ("stmt_type", "str"),
    ("schema_name", "str"), ("exec_count", "int"), ("sum_errors", "int"),
    ("sum_latency_ms", "real"), ("max_latency_ms", "real"),
    ("sum_parse_ms", "real"), ("max_parse_ms", "real"),
    ("sum_plan_ms", "real"), ("max_plan_ms", "real"),
    ("sum_exec_ms", "real"), ("max_exec_ms", "real"),
    ("sum_queue_wait_ms", "real"), ("max_queue_wait_ms", "real"),
    ("sum_batch_wait_ms", "real"), ("queued_count", "int"),
    ("dispatches", "int"), ("d2h_transfers", "int"), ("d2h_bytes", "int"),
    ("h2d_transfers", "int"), ("h2d_bytes", "int"),
    ("compile_cache_hits", "int"), ("compile_cache_misses", "int"),
    ("sum_device_ms", "real"), ("profiled_dispatches", "int"),
    ("sum_compile_ms", "real"),
    ("sum_cpu_ms", "real"), ("cpu_samples", "int"),
    ("sum_heap_alloc_kb", "real"), ("max_heap_kb", "real"),
    ("pipe_blocks", "int"), ("pipe_overlap_frac", "real"),
    ("coalesced", "int"),
    ("sum_spill_bytes", "int"), ("max_spill_bytes", "int"),
    ("spill_count", "int"),
    ("max_mem_bytes", "int"), ("sum_rows_returned", "int"),
    ("first_seen", "str"), ("last_seen", "str"),
    ("sample_sql", "str"), ("sample_plan", "str"),
]


class SummaryStore:
    """The aggregation store: current window + bounded rotated history
    + process-cumulative latency histograms.  Written from any session
    thread through the designated hook — all paths take the lock."""

    HISTORY_WINDOWS = 4

    def __init__(self, refresh_interval_s: float = DEFAULT_REFRESH_INTERVAL_S,
                 max_stmt_count: int = DEFAULT_MAX_STMT_COUNT):
        self.refresh_interval_s = float(refresh_interval_s)
        self.max_stmt_count = int(max_stmt_count)
        self._mu = threading.Lock()
        self._entries: Dict[Tuple[str, str], StmtRecord] = {}
        self._tombstone: Optional[StmtRecord] = None
        #: anchored by the FIRST ingest (not construction), so injected
        #: test clocks and long-idle processes both start a fresh window
        #: at the first statement
        self.window_begin: Optional[float] = None
        #: rotated windows: (window_begin, [rows...]) — newest last
        self.history: deque = deque(maxlen=self.HISTORY_WINDOWS)
        self._hist = {p: [0] * (len(LATENCY_BUCKETS_S) + 1)
                      for p in HIST_PHASES}
        self._hist_sum = {p: 0.0 for p in HIST_PHASES}
        self._hist_count = {p: 0 for p in HIST_PHASES}

    # ---- the designated write path (session close hook ONLY) ------------
    def ingest(self, *, sql: str, stmt_type: str, schema_name: str,
               plan_digest: str, info: Dict[str, float],
               device: Dict[str, float], rows_returned: int = 0,
               error: bool = False, max_mem: int = 0,
               plan_text: str = "", plan_rows=None,
               sql_digest: str = "",
               digest_text: str = "",
               queued: bool = False,
               refresh_interval_s: Optional[float] = None,
               max_stmt_count: Optional[int] = None,
               now: Optional[float] = None) -> str:
        """Fold one finished statement in; returns the SQL digest.
        ``now`` is injectable for window-rotation tests; the per-call
        interval/max-count overrides carry the session's sysvars."""
        if not sql_digest:
            sql_digest, digest_text = normalize(sql)
        if now is None:
            now = time.time()
        if refresh_interval_s is not None:
            # reads use the most recent session-provided interval for
            # their own staleness check
            self.refresh_interval_s = float(refresh_interval_s)
        interval = self.refresh_interval_s
        max_count = self.max_stmt_count if max_stmt_count is None \
            else int(max_stmt_count)
        key = (sql_digest, plan_digest or "")
        with self._mu:
            if self.window_begin is None:
                self.window_begin = now
            elif interval > 0 and now - self.window_begin >= interval:
                self._rotate(now)
            if max_count > 0:
                # enforce the cap even when it was LOWERED mid-window:
                # one-in-one-out eviction alone would pin the entry
                # count at its old high-water forever
                while len(self._entries) > max_count:
                    self._evict_one()
            rec = self._entries.get(key)
            if rec is None:
                if max_count > 0 and len(self._entries) >= max_count:
                    self._evict_one()
                rec = self._entries[key] = StmtRecord(
                    sql_digest, digest_text, plan_digest or "")
            if not rec.sample_plan and not plan_text and plan_rows:
                # flatten lazily: only the FIRST execution of a digest
                # pays the O(plan-rows) render-to-string
                plan_text = _flatten_plan(plan_rows)
            rec.fold(stmt_type=stmt_type, schema_name=schema_name,
                     info=info, device=device,
                     rows_returned=rows_returned, error=error,
                     max_mem=max_mem, sql=sql, plan=plan_text, now=now,
                     queued=queued)
            for phase in HIST_PHASES:
                v = float(info.get(f"{phase}_s", 0.0))
                # 0.0 means "no measurement for this phase" (wire
                # statements carry no parse wall, non-first batch
                # statements amortize it, bookkeeping statements never
                # plan) — piling zeros into the lowest bucket would make
                # the histogram count statements, not measurements
                if v > 0.0:
                    self._observe(phase, v)
        return sql_digest

    def _rotate(self, now: float) -> None:
        # caller holds the lock
        rows = [r.row(self.window_begin)
                for r in self._window_records()]
        if rows:
            self.history.append((self.window_begin, rows))
        self._entries.clear()
        self._tombstone = None
        self.window_begin = now

    def _evict_one(self) -> None:
        # caller holds the lock: least-recently-seen record folds into
        # the tombstone so window totals stay accountable
        victim_key = min(self._entries,
                         key=lambda k: self._entries[k].last_seen)
        victim = self._entries.pop(victim_key)
        if self._tombstone is None:
            self._tombstone = StmtRecord(EVICTED_DIGEST, "(evicted)", "")
        self._tombstone.merge(victim)

    def _observe(self, phase: str, seconds: float) -> None:
        # caller holds the lock
        buckets = self._hist[phase]
        for i, le in enumerate(LATENCY_BUCKETS_S):
            if seconds <= le:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1
        self._hist_sum[phase] += seconds
        self._hist_count[phase] += 1

    # ---- reads -----------------------------------------------------------
    def _window_records(self) -> List[StmtRecord]:
        recs = list(self._entries.values())
        if self._tombstone is not None:
            recs.append(self._tombstone)
        return recs

    def _maybe_rotate_stale(self, now: Optional[float]) -> None:
        # caller holds the lock.  Reads must not present a long-expired
        # window as current: after an idle gap the first SELECT scans
        # BEFORE its own close-hook ingest, so rotation has to happen on
        # the read side too.
        if now is None:
            now = time.time()
        if self.window_begin is not None and self.refresh_interval_s > 0 \
                and now - self.window_begin >= self.refresh_interval_s:
            self._rotate(now)

    def rows(self, now: Optional[float] = None) -> List[list]:
        """Current-window rows in ``COLUMNS`` order (the
        ``statements_summary`` mem-table payload), tombstone last.
        ``now`` is injectable for window tests."""
        with self._mu:
            self._maybe_rotate_stale(now)
            begin = self.window_begin or (now if now is not None
                                          else time.time())
            return [r.row(begin) for r in self._window_records()]

    def history_rows(self, now: Optional[float] = None) -> List[list]:
        """Rotated windows (oldest first) followed by the current one —
        the ``statements_summary_history`` mem-table payload (reference:
        statements_summary_history spans the retained windows)."""
        with self._mu:
            self._maybe_rotate_stale(now)
            out = [row for _, wrows in self.history for row in wrows]
            begin = self.window_begin or (now if now is not None
                                          else time.time())
            out.extend(r.row(begin) for r in self._window_records())
            return out

    def snapshot(self, now: Optional[float] = None) -> List[dict]:
        """Debug-endpoint form (dicts, current window)."""
        with self._mu:
            self._maybe_rotate_stale(now)
            return [r.to_dict() for r in self._window_records()]

    def histogram_snapshot(self) -> Dict[str, dict]:
        """Per-phase ``{"buckets": [(le_s, count), ...], "sum": s,
        "count": n}`` with PER-BUCKET (non-cumulative) counts; /metrics
        renders the Prometheus cumulative form."""
        with self._mu:
            out = {}
            for p in HIST_PHASES:
                out[p] = {
                    "buckets": list(zip(LATENCY_BUCKETS_S, self._hist[p])),
                    "overflow": self._hist[p][-1],
                    "sum": self._hist_sum[p],
                    "count": self._hist_count[p],
                }
            return out

    def reset(self) -> None:
        """Tests only: drop windows, history, and histograms."""
        with self._mu:
            self._entries.clear()
            self._tombstone = None
            self.history.clear()
            self.window_begin = None
            for p in HIST_PHASES:
                self._hist[p] = [0] * (len(LATENCY_BUCKETS_S) + 1)
                self._hist_sum[p] = 0.0
                self._hist_count[p] = 0


#: the process-global store every session aggregates into
STORE = SummaryStore()


def ingest(**kw) -> str:
    """THE designated writer (qlint OB403): called from the session's
    statement-close hook only."""
    return STORE.ingest(**kw)


def rows() -> List[list]:
    return STORE.rows()


def history_rows() -> List[list]:
    return STORE.history_rows()


def snapshot() -> List[dict]:
    return STORE.snapshot()


def histogram_snapshot() -> Dict[str, dict]:
    return STORE.histogram_snapshot()

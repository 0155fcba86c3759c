"""Durable flight recorder: the observability black box that crosses
process death (reference: TiDB persists the slow log and statements
summary across restarts, and TiDB Dashboard's continuous-profiling
store keeps historical profiles for post-hoc diagnosis).

Every observability surface — the metrics ring (tsring), statements
summary windows, conprof/memprof folded stacks, inspection findings —
lives in process memory, so a crash destroys the telemetry exactly when
it matters most.  This module rides the WAL's durability arming
convention: when the store has a data dir, a background ``FlightWriter``
appends length-prefixed crc32-checksummed segments (zlib-compressed
JSON snapshots of every tier) to ``<data-dir>/flight/inc-<N>.flt``; when
there is no data dir, nothing is armed and behavior is byte-identical
to the volatile server (zero ``tinysql_flight_*`` movement — the
/metrics render and the tsring source both gate on any-counter-moved,
the same discipline kv/wal.py uses).

One process lifetime = one **incarnation**: a monotonic id read-bumped
from ``flight/INCARNATION`` at boot (tmp→fsync→rename, like every other
metadata write here; an in-process counter still advances when
volatile so the id is always a usable join key).  On startup prior
incarnations load read-only and are served through the existing SQL
surfaces — ``metrics_history`` / ``statements_summary_history`` /
``continuous_profiling`` / ``inspection_result`` gain an
``incarnation`` column (current run = highest id) and the new
``flight_incarnations`` mem-table lists each run's boundaries and
whether it shut down clean or torn (last segment carries ``final``).

Segment framing reuses wal.py's record discipline: ``u32 payload_len |
u32 crc32(payload) | payload`` after an 8-byte magic, torn tails
truncated at the last good boundary on writer open, and a
retention-bounded in-file compaction (keep the newest ``retention``
segments, rewrite tmp→fsync→rename) plus pruning of the oldest
incarnation files keeps the directory bounded.

A crash-scoped fatal path — ``atexit`` + ``faulthandler`` into
``flight/fatal-<N>.log`` + both wire-mode close paths — force-flushes a
final segment carrying the last trace-span ring and the active
processlist, so even a graceful-degradation death leaves a readable
black box for tools/postmortem.py.

Blind spots (documented contract): SIGKILL between writer ticks loses
at most one ``tidb_flight_interval`` of telemetry (the post-mortem
window is the last *completed* segment); faulthandler records the
C-level stack on a hard fault but cannot run the Python flush hook, so
a segfault's last window is also the last tick, plus the native
traceback file.
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import struct
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "FlightStore", "FlightWriter", "DEFAULT_INTERVAL_S",
    "DEFAULT_RETENTION", "INCARNATION_COLUMNS", "current_incarnation",
    "server_start_ts", "active_store", "prior_tier_rows",
    "incarnation_rows", "stats_snapshot", "reset_stats",
    "live_overhead_frac",
]

#: GLOBAL sysvar defaults (session.DEFAULT_SYSVARS mirrors these)
DEFAULT_INTERVAL_S = 10
DEFAULT_RETENTION = 8

SUBDIR = "flight"
_COUNTER_FILE = "INCARNATION"
_MAGIC = b"TSQLFLT1"
_HDR = struct.Struct("<II")          # payload length, crc32(payload)

#: replayable tiers a segment snapshots (postmortem + mem-tables read
#: these keys back; "metrics" is a delta, the rest are
#: last-segment-wins full snapshots)
TIERS = ("metrics", "summary", "conprof", "memprof", "findings",
         "counters")

# ---- process-cumulative stats (METRICS -> tsring -> /metrics) --------------
_STATS_MU = threading.Lock()
STATS: Dict[str, float] = {
    "segments": 0, "segment_bytes": 0, "fsyncs": 0,
    "final_flushes": 0, "compactions": 0, "torn_truncations": 0,
    "prior_segments_loaded": 0, "errors": 0,
    "self_s": 0.0,               # writer self-cost (bench overhead gate)
}


def _bump(key: str, n: float = 1) -> None:
    with _STATS_MU:
        STATS[key] = STATS.get(key, 0) + n


def stats_snapshot() -> Dict[str, float]:
    with _STATS_MU:
        return dict(STATS)


def reset_stats() -> None:
    """Test hook: zero the cumulative counters."""
    with _STATS_MU:
        for k in STATS:
            STATS[k] = 0


def live_overhead_frac(stats_before: Dict[str, float],
                       stats_after: Dict[str, float],
                       wall_s: float) -> float:
    """Writer self-cost over a measured live window — same definition
    as conprof/memprof.live_overhead_frac, so bench_serve can gate the
    three samplers' combined live fraction under one budget."""
    if wall_s <= 0:
        return 0.0
    d = stats_after.get("self_s", 0.0) - stats_before.get("self_s", 0.0)
    return max(0.0, d) / wall_s


# ---- incarnation identity --------------------------------------------------
# One process lifetime = one incarnation.  Armed boots read-bump the
# persisted counter; volatile boots advance an in-process counter so
# the id is still a monotone join key within the process (a counter
# even when volatile).
_ID_MU = threading.Lock()
_INCARNATION = 0                      # 0 = no boot yet (reads clamp to 1)
_SERVER_START_TS = time.time()        # refreshed at every writer boot


def current_incarnation() -> int:
    with _ID_MU:
        return max(1, _INCARNATION)


def server_start_ts() -> float:
    with _ID_MU:
        return _SERVER_START_TS


def _boot_identity(incarnation: Optional[int]) -> int:
    """Stamp boot identity: explicit id from the persisted counter, or
    the next in-process id when volatile.  Returns the assigned id."""
    global _INCARNATION, _SERVER_START_TS
    with _ID_MU:
        if incarnation is not None:
            _INCARNATION = int(incarnation)
        else:
            _INCARNATION = max(1, _INCARNATION + 1)
        _SERVER_START_TS = time.time()
        return _INCARNATION


# ---- codec -----------------------------------------------------------------

def _encode_segment(doc: dict) -> bytes:
    payload = zlib.compress(
        json.dumps(doc, separators=(",", ":"), sort_keys=True,
                   default=str).encode("utf-8"))
    return _HDR.pack(len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _scan_segments(path: str) -> Tuple[List[dict], int, bool]:
    """Decode every intact segment of one incarnation file.  Returns
    ``(docs, good_end, clean_tail)`` — ``good_end`` is the byte offset
    after the last intact record (the writer truncates there),
    ``clean_tail`` is False when trailing garbage followed it (a torn
    append).  Same replay discipline as WriteAheadLog._replay: stop at
    the first short header, short record, or crc mismatch."""
    docs: List[dict] = []
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return [], 0, False
    if not blob.startswith(_MAGIC):
        return [], 0, False
    off = len(_MAGIC)
    size = len(blob)
    good_end = off
    clean = True
    while off + _HDR.size <= size:
        plen, crc = _HDR.unpack_from(blob, off)
        body = blob[off + _HDR.size: off + _HDR.size + plen]
        if len(body) < plen or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            clean = False
            break
        try:
            docs.append(json.loads(zlib.decompress(body).decode("utf-8")))
        except Exception:
            clean = False
            break
        off += _HDR.size + plen
        good_end = off
    if off != size:
        clean = False
    return docs, good_end, clean


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---- store -----------------------------------------------------------------

def _inc_path(flight_dir: str, n: int) -> str:
    return os.path.join(flight_dir, "inc-%08d.flt" % n)


def _list_incarnation_files(flight_dir: str) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(flight_dir)
    except OSError:
        return out
    for name in names:
        if name.startswith("inc-") and name.endswith(".flt"):
            try:
                out.append((int(name[4:-4]),
                            os.path.join(flight_dir, name)))
            except ValueError:
                continue
    out.sort()
    return out


class FlightStore:
    """One ``<data-dir>/flight/`` directory: the incarnation counter,
    the current incarnation's append-only segment file, and the prior
    incarnations loaded read-only at open."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        self.dir = os.path.join(data_dir, SUBDIR)
        self.incarnation = 0
        self.path = ""
        self._f = None
        self._mu = threading.Lock()
        self._segments = 0            # records in the current file
        #: incarnation -> (docs, clean_tail) for every PRIOR run
        self.prior: Dict[int, Tuple[List[dict], bool]] = {}

    # -- counter ------------------------------------------------------------
    def _counter_path(self) -> str:
        return os.path.join(self.dir, _COUNTER_FILE)

    def _read_counter(self) -> int:
        try:
            with open(self._counter_path(), "r", encoding="utf-8") as f:
                return int(f.read().strip() or "0")
        except (OSError, ValueError):
            return 0

    def _write_counter(self, n: int) -> None:
        tmp = self._counter_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("%d\n" % n)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._counter_path())
        _fsync_dir(self.dir)

    # -- lifecycle ----------------------------------------------------------
    def open_writer(self) -> int:
        """Assign this boot's incarnation (read-bump-persist the
        counter), open its segment file, truncate any torn tail left by
        a previous crash of the SAME file (only possible if the counter
        write raced a kill), and load every prior incarnation
        read-only.  Returns the assigned incarnation id."""
        os.makedirs(self.dir, exist_ok=True)
        n = self._read_counter() + 1
        self._write_counter(n)
        self.incarnation = n
        self.path = _inc_path(self.dir, n)
        segs = 0
        if os.path.exists(self.path):
            docs, good_end, clean = _scan_segments(self.path)
            if not clean:
                with open(self.path, "r+b") as f:
                    f.truncate(max(good_end, len(_MAGIC)))
                _bump("torn_truncations")
            segs = len(docs)
        f = open(self.path, "ab")
        if f.tell() == 0:
            f.write(_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        with self._mu:
            self._f = f
            self._segments = segs
        self._load_prior(exclude=n)
        return n

    def open_read_only(self) -> None:
        """Post-mortem entry: load every incarnation (including the
        last writer's) WITHOUT bumping the counter or truncating
        anything on disk."""
        self.incarnation = self._read_counter()
        self._load_prior(exclude=None)

    def _load_prior(self, exclude: Optional[int]) -> None:
        prior: Dict[int, Tuple[List[dict], bool]] = {}
        for n, path in _list_incarnation_files(self.dir):
            if exclude is not None and n >= exclude:
                continue
            docs, _good_end, clean = _scan_segments(path)
            if docs:
                prior[n] = (docs, clean)
                _bump("prior_segments_loaded", len(docs))
        with self._mu:
            self.prior = prior

    def close(self) -> None:
        with self._mu:
            f, self._f = self._f, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
            except OSError:
                pass
            f.close()

    # -- writes -------------------------------------------------------------
    def append_segment(self, doc: dict, retention: int) -> None:
        """Frame, append, fsync one segment; then bound the store:
        in-file compaction keeps the newest ``retention`` segments once
        the file holds twice that, and incarnation files older than the
        newest ``retention`` runs are pruned."""
        rec = _encode_segment(doc)
        with self._mu:
            if self._f is None:
                return
            self._f.write(rec)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._segments += 1
            segs = self._segments
        _bump("segments")
        _bump("segment_bytes", len(rec))
        _bump("fsyncs")
        if retention > 0 and segs > 2 * retention:
            self._compact(retention)
        if retention > 0:
            self._prune(retention)

    def _compact(self, retention: int) -> None:
        """Rewrite the current file keeping only the newest
        ``retention`` segments (tmp→fsync→rename, the checkpoint
        discipline)."""
        with self._mu:
            if self._f is None:
                return
            docs, _end, _clean = _scan_segments(self.path)
            keep = docs[-retention:]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                for d in keep:
                    f.write(_encode_segment(d))
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            _fsync_dir(self.dir)
            self._f = open(self.path, "ab")
            self._segments = len(keep)
        _bump("compactions")

    def _prune(self, retention: int) -> None:
        files = _list_incarnation_files(self.dir)
        if len(files) <= retention:
            return
        for n, path in files[:len(files) - retention]:
            if n == self.incarnation:
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            with self._mu:
                self.prior.pop(n, None)

    # -- replay -------------------------------------------------------------
    def tier_rows(self, incarnation: int, tier: str) -> List[list]:
        """Replay one prior incarnation's mem-table payload.
        ``metrics`` concatenates every segment's delta back into
        metrics_history rows; the other tiers are last-segment-wins
        full snapshots (each segment re-snapshots the whole retained
        window, so the newest one supersedes)."""
        entry = self.prior.get(incarnation)
        if entry is None:
            return []
        docs = entry[0]
        if tier == "metrics":
            from . import tsring
            out: List[list] = []
            for doc in docs:
                for ts, vals in doc.get("tiers", {}).get("metrics", []):
                    stamp = tsring._ts(ts)
                    for name in sorted(vals):
                        out.append([stamp, float(ts), name,
                                    float(vals[name])])
            return out
        payload = docs[-1].get("tiers", {}).get(tier, [])
        return payload if isinstance(payload, list) else []

    def last_segment(self, incarnation: Optional[int] = None
                     ) -> Optional[dict]:
        if incarnation is None:
            incarnation = max(self.prior) if self.prior else 0
        entry = self.prior.get(incarnation)
        return entry[0][-1] if entry else None

    def incarnation_summary(self) -> List[dict]:
        """One dict per loaded prior incarnation (ascending):
        boundaries, clean-vs-torn verdict, last WAL LSN, tier counts."""
        out: List[dict] = []
        for n in sorted(self.prior):
            docs, clean_tail = self.prior[n]
            first, last = docs[0], docs[-1]
            final = bool(last.get("final"))
            counters = last.get("tiers", {}).get("counters", {})
            out.append({
                "incarnation": n,
                "start_ts": float(first.get("server_start_ts",
                                            first.get("ts", 0.0))),
                "end_ts": float(last.get("ts", 0.0)),
                "status": "clean" if (final and clean_tail) else "torn",
                "last_lsn": int(counters.get("wal_last_lsn", 0)),
                "segments": len(docs),
                "metrics_samples": sum(
                    len(d.get("tiers", {}).get("metrics", []))
                    for d in docs),
                "summary_rows": len(last.get("tiers", {})
                                    .get("summary", [])),
                "conprof_rows": len(last.get("tiers", {})
                                    .get("conprof", [])),
                "findings": len(last.get("tiers", {})
                                .get("findings", [])),
            })
        return out


# ---- writer ----------------------------------------------------------------

#: armed writers with a pending final flush — a single atexit hook
#: drains the set so a plain interpreter exit still leaves a black box
_FATAL_WRITERS: "weakref.WeakSet[FlightWriter]" = weakref.WeakSet()
_ATEXIT_ARMED = False
_ATEXIT_MU = threading.Lock()


def _atexit_flush() -> None:
    for w in list(_FATAL_WRITERS):
        try:
            w.final_flush(reason="atexit")
        except Exception:
            _bump("errors")


def _arm_atexit() -> None:
    global _ATEXIT_ARMED
    with _ATEXIT_MU:
        if not _ATEXIT_ARMED:
            atexit.register(_atexit_flush)
            _ATEXIT_ARMED = True


class FlightWriter:
    """Background segment writer on the server lifecycle (same
    start/close discipline as obs/memprof.MemprofSampler: daemon
    thread, Event-paced waits sliced at ≤0.25 s, GLOBAL sysvars
    re-read every tick so ``SET GLOBAL`` takes effect without a
    restart; ``tidb_flight_interval = 0`` pauses without stopping).

    Construction stamps the boot identity (incarnation +
    server_start_ts) whether or not a data dir is armed; everything
    else — the store, the fatal hooks, the segment stream — exists
    only when armed, preserving volatile byte-identity."""

    def __init__(self, storage):
        self.storage = storage
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self._final_done = False
        self._seq = 0
        self._last_metrics_ts = 0.0
        self._fatal_file = None
        self.store: Optional[FlightStore] = None
        data_dir = getattr(storage, "data_dir", "") or ""
        if data_dir:
            self.store = FlightStore(data_dir)
            inc = self.store.open_writer()
            _boot_identity(inc)
            _set_active(self)
            self._enable_fatal_hooks()
        else:
            _boot_identity(None)
            _set_active(None)

    # -- sysvars ------------------------------------------------------------
    def _int_sysvar(self, name: str, default: int) -> int:
        from ..server.pool import read_global_int
        return read_global_int(self.storage, name, default)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self.store is None:
            return
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="flight-writer")
            self._thread.start()

    def close(self) -> None:
        with self._mu:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._mu:
            if self._thread is t:
                self._thread = None
        self.final_flush(reason="close")
        self._disable_fatal_hooks()
        if self.store is not None:
            self.store.close()

    def _loop(self) -> None:
        # the interval sysvar is re-read every 0.25 s slice (not once
        # per tick) so SET GLOBAL tidb_flight_interval takes effect
        # within a slice even mid-wait; interval <= 0 pauses and also
        # resets the accumulated wait
        waited = 0.0
        while not self._stop.is_set():
            interval = self._int_sysvar("tidb_flight_interval",
                                        DEFAULT_INTERVAL_S)
            if interval <= 0:
                waited = 0.0
                self._stop.wait(0.25)
                continue
            if waited < interval:
                t0 = time.monotonic()
                self._stop.wait(min(0.25, interval - waited))
                waited += time.monotonic() - t0
                continue
            waited = 0.0
            try:
                self.flush_now()
            except Exception:
                _bump("errors")

    # -- fatal hooks ---------------------------------------------------------
    def _enable_fatal_hooks(self) -> None:
        _FATAL_WRITERS.add(self)
        _arm_atexit()
        try:
            path = os.path.join(self.store.dir,
                                "fatal-%08d.log" % self.store.incarnation)
            self._fatal_file = open(path, "w", encoding="utf-8")
            faulthandler.enable(self._fatal_file)
        except Exception:
            self._fatal_file = None

    def _disable_fatal_hooks(self) -> None:
        _FATAL_WRITERS.discard(self)
        if self._fatal_file is not None:
            try:
                faulthandler.disable()
            except Exception:
                pass
            try:
                self._fatal_file.close()
            except Exception:
                pass
            self._fatal_file = None

    # -- segments ------------------------------------------------------------
    def _counters(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        # the reference also probes ops/shardops.py (ROADMAP queue 1,
        # item 10) and ops/spill.py (item 6), which the port lacks yet
        probes = (
            ("wal", "..kv.wal"),
            ("batching", "..ops.batching"),
            ("admission", "..server.admission"),
            ("prewarm", "..session.prewarm"),
            ("tsring", ".tsring"), ("conprof", ".conprof"),
            ("memprof", ".memprof"),
        )
        import importlib
        for key, modname in probes:
            try:
                mod = importlib.import_module(modname, package=__package__)
                out[key] = {k: float(v) for k, v
                            in mod.stats_snapshot().items()}
            except Exception:
                continue
        try:
            wal = self.storage.mvcc.wal
            if wal is not None:
                out["wal_last_lsn"] = int(getattr(wal, "_lsn", 0))
        except Exception:
            pass
        return out

    def _collect(self, final: bool) -> dict:
        from . import conprof, memprof, stmtsummary, tsring
        from . import inspect as obs_inspect
        now = time.time()
        samples = tsring.RING.snapshot_samples()
        with self._mu:
            last_ts = self._last_metrics_ts
        delta = [[ts, vals] for ts, vals in samples if ts > last_ts]
        if delta:
            with self._mu:
                self._last_metrics_ts = delta[-1][0]
        tiers: Dict[str, Any] = {
            "metrics": delta,
            "summary": stmtsummary.history_rows(),
            "conprof": conprof.rows(),
            "findings": obs_inspect.rows(now=now, window_s=None),
            "counters": self._counters(),
        }
        try:
            tiers["memprof"] = {
                "collapsed": memprof.collapsed(),
                "memory_usage": memprof.memory_usage_rows(),
            }
        except Exception:
            tiers["memprof"] = {}
        with self._mu:
            seq = self._seq
            self._seq = seq + 1
        doc = {
            "v": 1,
            "incarnation": self.store.incarnation,
            "seq": seq,
            "ts": now,
            "server_start_ts": server_start_ts(),
            "final": final,
            "tiers": tiers,
        }
        if final:
            from ..catalog.memtables import _processlist_rows
            from .trace import recent_traces
            try:
                doc["traces"] = recent_traces(64)
            except Exception:
                doc["traces"] = []
            try:
                doc["processlist"] = _processlist_rows()
            except Exception:
                doc["processlist"] = []
        return doc

    def flush_now(self, final: bool = False, reason: str = "tick") -> None:
        """Snapshot every tier and append one segment.  ``final``
        segments carry the trace ring + processlist and mark the run
        clean for incarnation_summary."""
        if self.store is None:
            return
        t0 = time.monotonic()
        try:
            doc = self._collect(final)
            if final:
                doc["reason"] = reason
            retention = self._int_sysvar("tidb_flight_retention",
                                         DEFAULT_RETENTION)
            self.store.append_segment(doc, retention)
            if final:
                _bump("final_flushes")
        finally:
            _bump("self_s", time.monotonic() - t0)

    def final_flush(self, reason: str = "close") -> None:
        """Idempotent last-segment flush — every death path (graceful
        close in both wire modes, atexit) funnels here."""
        with self._mu:
            if self._final_done or self.store is None:
                return
            self._final_done = True
        try:
            self.flush_now(final=True, reason=reason)
        except Exception:
            _bump("errors")


# ---- module-level read surface (mem-tables + /debug + postmortem) ----------

_ACTIVE: Optional["weakref.ReferenceType[FlightWriter]"] = None
_ACTIVE_MU = threading.Lock()


def _set_active(writer: Optional[FlightWriter]) -> None:
    global _ACTIVE
    with _ACTIVE_MU:
        _ACTIVE = weakref.ref(writer) if writer is not None else None


def active_writer() -> Optional[FlightWriter]:
    with _ACTIVE_MU:
        ref = _ACTIVE
    return ref() if ref is not None else None


def active_store() -> Optional[FlightStore]:
    w = active_writer()
    return w.store if w is not None else None


def prior_tier_rows(tier: str) -> List[Tuple[int, List[list]]]:
    """``[(incarnation, rows), ...]`` ascending for every loaded prior
    incarnation — the mem-table extensions append the incarnation
    column and splice these ahead of the live rows.  Empty when
    volatile (no store armed)."""
    store = active_store()
    if store is None:
        return []
    return [(n, store.tier_rows(n, tier)) for n in sorted(store.prior)]


#: information_schema.flight_incarnations layout — MUST match
#: incarnation_rows
INCARNATION_COLUMNS = [
    ("incarnation", "int"), ("start_time", "str"), ("end_time", "str"),
    ("status", "str"), ("last_lsn", "int"), ("segments", "int"),
    ("metrics_samples", "int"), ("summary_rows", "int"),
    ("conprof_rows", "int"), ("findings", "int"),
]


def incarnation_rows() -> List[list]:
    """``flight_incarnations`` payload: loaded prior runs (ascending)
    then the current run (status ``running``; its counters reflect the
    live stores, not yet any segment)."""
    from . import tsring
    out: List[list] = []
    store = active_store()
    if store is not None:
        for s in store.incarnation_summary():
            out.append([s["incarnation"], tsring._ts(s["start_ts"]),
                        tsring._ts(s["end_ts"]), s["status"],
                        s["last_lsn"], s["segments"],
                        s["metrics_samples"], s["summary_rows"],
                        s["conprof_rows"], s["findings"]])
    segs = store._segments if store is not None else 0
    out.append([current_incarnation(), tsring._ts(server_start_ts()),
                "", "running", 0, int(segs), 0, 0, 0, 0])
    return out


def debug_snapshot() -> dict:
    """The ``/debug/flight`` payload."""
    store = active_store()
    return {
        "armed": store is not None,
        "incarnation": current_incarnation(),
        "server_start_ts": server_start_ts(),
        "dir": store.dir if store is not None else "",
        "stats": stats_snapshot(),
        "incarnations": (store.incarnation_summary()
                         if store is not None else []),
    }

"""Time-series metrics ring: the "what changed in the last N minutes"
substrate (reference lineage: TiDB's metrics_schema — PromQL-backed
mem-tables computed on read; here the process IS the metrics store, so a
background sampler snapshots every registered counter/gauge source into
a bounded in-memory ring instead).

Three cooperating pieces:

- **sources**: named callables returning a flat ``{metric name: value}``
  dict.  The built-ins cover every counter family the engine publishes
  — kernels.STATS device economics, the program registry, the serving
  layer (pool gauges, admission verdicts + queue wait, batching),
  the MemTracker aggregate, device-loss degradation, failpoint hits,
  the query-lifecycle counters, and the auto-prewarm worker.  Every
  name MUST come from the central registry (``obs/metrics.METRICS``);
  unregistered names are dropped at sample time and counted
  (``dropped_unregistered``), and qlint OB404 rejects them statically —
  /metrics, ``metrics_history``, and ``metrics_summary`` can never
  drift on what a metric is called.
- **MetricsRing**: the bounded sample store.  ``sample_once`` collects
  all sources OUTSIDE the lock, then appends one ``(ts, values)``
  sample and trims by ``tidb_metrics_retention`` seconds (re-read every
  sample, so shrinking retention mid-flight trims immediately; a hard
  ``MAX_SAMPLES`` cap bounds memory even under a pathological
  interval).  Readers (the ``metrics_history`` / ``metrics_summary``
  mem-tables, the inspection engine) take the same lock, so a scan can
  never observe a torn sample.
- **Sampler**: the background thread wired into the server lifecycle
  (server/server.py), pacing ``sample_once`` by the GLOBAL
  ``tidb_metrics_interval`` sysvar (seconds; 0 disables sampling, the
  thread keeps watching for a re-enable).

Self-accounting is PER RING (``MetricsRing.stats_snapshot``): the
module-level :func:`stats_snapshot` reports the live global ring, so a
private probe ring (bench overhead measurement, tests) can never
inflate the background sampler's own cost metrics.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_INTERVAL_S = 5
DEFAULT_RETENTION_S = 900

#: hard sample-count bound: retention/interval normally bounds the ring,
#: but a tiny interval with a huge retention must not grow memory
#: without limit
MAX_SAMPLES = 4096

def stats_snapshot() -> Dict[str, float]:
    """The LIVE ring's self-accounting (samples taken, unregistered
    drops, collection wall) — what /metrics and the "tsring" source
    report; private rings keep their own books."""
    return RING.stats_snapshot()


def reset_stats() -> None:
    """Tests only."""
    RING.reset_stats()


# ---- source registry ------------------------------------------------------

#: source name -> callable returning {registered metric name: value};
#: insertion-ordered so samples are reproducible
_src_mu = threading.Lock()
_SOURCES: Dict[str, Callable[[], Dict[str, float]]] = {}


def register_source(name: str,
                    fn: Callable[[], Dict[str, float]]) -> None:
    """Register (or replace) one named sample source.  Metric names the
    callable returns must be declared in ``obs/metrics.METRICS`` —
    unregistered names are dropped at sample time (and qlint OB404
    flags them statically)."""
    with _src_mu:
        _SOURCES[name] = fn


def sources() -> List[str]:
    with _src_mu:
        return list(_SOURCES)


def _collect() -> Dict[str, float]:
    """One raw pass over every source.  A broken source contributes
    nothing — sampling must never raise into the sampler thread or a
    mem-table scan."""
    with _src_mu:
        fns = list(_SOURCES.values())
    values: Dict[str, float] = {}
    for fn in fns:
        try:
            values.update(fn() or {})
        except Exception:
            continue
    return values


# ---- the ring -------------------------------------------------------------

# ONE time-format for every observability row stamp: metrics_history,
# statements_summary, and inspection_result must stay joinable on their
# time columns
from .stmtsummary import _ts  # noqa: E402


class MetricsRing:
    """Bounded (ts, {name: value}) sample store.  Writes and reads share
    one lock: a ``metrics_history`` scan racing the sampler sees whole
    samples or nothing — never a half-written one."""

    def __init__(self, retention_s: float = DEFAULT_RETENTION_S):
        self.retention_s = float(retention_s)
        self._mu = threading.Lock()
        self._samples: deque = deque()
        #: this ring's OWN self-accounting — a private probe ring must
        #: not inflate the live sampler's cost metrics
        self._stats = {"samples": 0, "dropped_unregistered": 0,
                       "sample_wall_s": 0.0}

    def _stat_add(self, key: str, n) -> None:
        with self._mu:
            self._stats[key] = self._stats.get(key, 0) + n

    def stats_snapshot(self) -> Dict[str, float]:
        with self._mu:
            return dict(self._stats)

    def reset_stats(self) -> None:
        """Tests only."""
        with self._mu:
            self._stats = {"samples": 0, "dropped_unregistered": 0,
                           "sample_wall_s": 0.0}

    def sample_once(self, now: Optional[float] = None,
                    retention_s: Optional[float] = None) -> Dict[str, float]:
        """Collect every source into one sample; returns the values.
        ``now`` is injectable for deterministic tests; ``retention_s``
        carries the live sysvar (also applied to ALREADY-stored samples,
        so a retention shrink trims immediately)."""
        t0 = time.perf_counter()
        values = self.record(_collect(), now=now, retention_s=retention_s)
        self._stat_add("sample_wall_s", time.perf_counter() - t0)
        return values

    def record(self, raw: Dict[str, float], now: Optional[float] = None,
               retention_s: Optional[float] = None) -> Dict[str, float]:
        """Append one pre-collected sample (sample_once's storage leg;
        also the deterministic entry for tests and offline replays).
        Names are validated against the central registry — an
        unregistered or non-numeric value is dropped and counted, so
        the ring can NEVER contain a name /metrics doesn't know."""
        from .metrics import registered
        values: Dict[str, float] = {}
        dropped = 0
        for name, v in raw.items():
            if not registered(name):
                dropped += 1
                continue
            try:
                values[name] = float(v)
            except (TypeError, ValueError):
                dropped += 1
        if now is None:
            now = time.time()
        with self._mu:
            if retention_s is not None:
                self.retention_s = float(retention_s)
            self._samples.append((now, values))
            self._trim(now)
            self._stats["samples"] += 1
            self._stats["dropped_unregistered"] += dropped
        return values

    def _trim(self, now: float) -> None:
        # caller holds the lock
        horizon = now - self.retention_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        while len(self._samples) > MAX_SAMPLES:
            self._samples.popleft()

    def size(self) -> int:
        with self._mu:
            return len(self._samples)

    def reset(self) -> None:
        """Tests only."""
        with self._mu:
            self._samples.clear()

    # ---- reads (mem-tables + inspection) --------------------------------
    def snapshot_samples(self) -> List[Tuple[float, Dict[str, float]]]:
        """One consistent copy of the retained samples — THE read
        entry: every consumer (mem-table scans, the inspection
        engine's whole rule evaluation) copies the deque exactly once
        under the lock instead of re-copying per read."""
        with self._mu:
            return [(ts, dict(vals)) for ts, vals in self._samples]

    def rows(self) -> List[list]:
        """``metrics_history`` payload: one row per (sample, metric) in
        sample order — (time, ts epoch, metric, value)."""
        samples = self.snapshot_samples()
        out: List[list] = []
        for ts, vals in samples:
            stamp = _ts(ts)
            for name in sorted(vals):
                out.append([stamp, float(ts), name, float(vals[name])])
        return out

    def summary_rows(self, now: Optional[float] = None,
                     window_s: Optional[float] = None) -> List[list]:
        """``metrics_summary`` payload: per metric over the retained
        window — (metric, kind, samples, window_s, first/last value,
        delta, rate_per_s, avg, min, max).  ``rate_per_s`` is the
        counter reading (delta over the sampled span, clamped at 0 so a
        process-counter reset shows 0 not a negative rate); gauges are
        summarized by avg/min/max."""
        from .metrics import METRICS
        samples = self.snapshot_samples()
        if now is None:
            now = time.time()
        if window_s is not None:
            samples = [s for s in samples if s[0] >= now - window_s]
        series: Dict[str, List[Tuple[float, float]]] = {}
        for ts, vals in samples:
            for name, v in vals.items():
                series.setdefault(name, []).append((ts, v))
        out: List[list] = []
        for name in sorted(series):
            pts = series[name]
            kind = METRICS.get(name, ("gauge", ""))[0]
            vals = [v for _, v in pts]
            t_first, v_first = pts[0]
            t_last, v_last = pts[-1]
            span = t_last - t_first
            delta = v_last - v_first
            rate = max(delta, 0.0) / span if span > 0 else 0.0
            out.append([
                name, kind, len(pts),
                round(span, 3), float(v_first), float(v_last),
                round(delta, 6), round(rate, 6),
                round(sum(vals) / len(vals), 6),
                float(min(vals)), float(max(vals)),
            ])
        return out

    def series(self, metric: str, since: Optional[float] = None,
               until: Optional[float] = None) -> List[Tuple[float, float]]:
        """(ts, value) points of one metric — the inspection engine's
        evidence-window read."""
        with self._mu:
            samples = list(self._samples)
        out = []
        for ts, vals in samples:
            if since is not None and ts < since:
                continue
            if until is not None and ts > until:
                continue
            if metric in vals:
                out.append((ts, float(vals[metric])))
        return out


#: the process-global ring every surface reads (mem-tables, /metrics
#: ring gauge, the inspection engine)
RING = MetricsRing()


# ---- mem-table payloads (catalog/memtables.py reads these) ---------------

#: information_schema.metrics_history column order — MUST match
#: MetricsRing.rows
HISTORY_COLUMNS = [
    ("time", "str"), ("ts", "real"), ("metric", "str"), ("value", "real"),
]

#: information_schema.metrics_summary column order — MUST match
#: MetricsRing.summary_rows
SUMMARY_COLUMNS = [
    ("metric", "str"), ("kind", "str"), ("samples", "int"),
    ("window_s", "real"), ("first_value", "real"), ("last_value", "real"),
    ("delta", "real"), ("rate_per_s", "real"), ("avg_value", "real"),
    ("min_value", "real"), ("max_value", "real"),
]


def history_rows() -> List[list]:
    return RING.rows()


def summary_rows() -> List[list]:
    return RING.summary_rows()


def measure_overhead(n: int = 50) -> Dict[str, float]:
    """The sampler's steady-state cost, THE definition both benches
    publish as ``obs_overhead_frac``: one sample's wall (averaged over
    ``n`` live collections, lazy imports warmed outside the timed loop)
    over the default sampling interval.  Probes a PRIVATE ring, so the
    measurement never pollutes the live ring or its self-accounting."""
    ring = MetricsRing()
    ring.sample_once()
    t0 = time.perf_counter()
    for _ in range(n):
        ring.sample_once()
    per_sample_s = (time.perf_counter() - t0) / n
    return {"sample_wall_s": round(per_sample_s, 6),
            "interval_s": DEFAULT_INTERVAL_S,
            "obs_overhead_frac": round(
                per_sample_s / DEFAULT_INTERVAL_S, 6)}


# ---- the background sampler (server lifecycle) ---------------------------

class Sampler:
    """Background thread pacing ``RING.sample_once`` by the GLOBAL
    ``tidb_metrics_interval`` sysvar (re-read every tick, like the
    auto-prewarm worker): 0 pauses sampling without stopping the
    thread, so ``SET GLOBAL tidb_metrics_interval = 5`` resumes it."""

    def __init__(self, storage, ring: Optional[MetricsRing] = None):
        self.storage = storage
        self.ring = ring if ring is not None else RING
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: guards the start/close lifecycle (qlint CC7xx triage): two
        #: concurrent start() calls both passing the None-check would
        #: leak a second sampler thread ticking the same ring
        self._mu = threading.Lock()

    def _int_sysvar(self, name: str, default: int) -> int:
        # THE server-side config-read helper (server/pool.py) — one
        # definition of the GLOBAL-scope-with-defaults int read
        from ..server.pool import read_global_int
        return read_global_int(self.storage, name, default)

    def interval_s(self) -> int:
        return self._int_sysvar("tidb_metrics_interval",
                                DEFAULT_INTERVAL_S)

    def start(self) -> None:
        with self._mu:
            if self._thread is not None:
                return
            self._stop.clear()  # restartable after close()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="metrics-sampler")
            self._thread.start()

    def close(self) -> None:
        # set the stop flag UNDER the lock, atomically with reading the
        # thread slot: a start() interleaved between the two would
        # clear the flag and spawn a thread this close() then orphans
        with self._mu:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        # clear the slot only AFTER the join: a start() racing this
        # close must keep seeing the old thread (and stay a no-op)
        # until it has actually exited — nulling early would let start
        # clear _stop before the old loop observed it
        with self._mu:
            if self._thread is t:
                self._thread = None

    def _loop(self) -> None:
        # wait in 1 s slices, re-reading the interval each slice: an
        # operator who drops tidb_metrics_interval from 300 to 1 during
        # an incident gets fine-grained samples within ~1 s, not after
        # the old interval drains.  Disabled (0) pauses the elapsed
        # clock without stopping the thread, so a re-enable resumes.
        elapsed = 0.0
        while True:
            if self._stop.wait(1.0):
                return
            interval = self.interval_s()
            if interval <= 0:
                elapsed = 0.0
                continue
            elapsed += 1.0
            if elapsed + 1e-9 < interval:
                continue
            elapsed = 0.0
            try:
                self.ring.sample_once(
                    retention_s=self._int_sysvar(
                        "tidb_metrics_retention", DEFAULT_RETENTION_S))
            except Exception:
                # a broken source must never kill the sampler thread
                import logging
                logging.getLogger("tinysql_tpu.tsring").warning(
                    "metrics sample failed", exc_info=True)


# ---- built-in sources -----------------------------------------------------
# Each source is lazy-importing and exception-isolated: /metrics and the
# ring must stay alive without a card, without a server, without a pool.
# The reference's spill and degrade sources are left out: the port has no
# ops/spill.py or ops/degrade.py yet (ROADMAP queue 1, item 6).

def _src_queries() -> Dict[str, float]:
    from .metrics import query_counter_totals
    return query_counter_totals()


def _src_kernels() -> Dict[str, float]:
    from ..ops import kernels
    from .metrics import _DEVICE_METRICS
    stats = dict(kernels.STATS)
    out = {name: stats[key]
           for key, (name, _help) in _DEVICE_METRICS.items()
           if key in stats}
    return out


def _src_progcache() -> Dict[str, float]:
    from ..ops import progcache
    p = progcache.stats_snapshot()
    return {"tinysql_progcache_hits_total": p.get("hits", 0),
            "tinysql_progcache_misses_total": p.get("misses", 0),
            "tinysql_prewarm_seeded_total": p.get("prewarm_seeded", 0),
            "tinysql_prewarm_hits_total": p.get("prewarm_hits", 0),
            "tinysql_compile_seconds_total": p.get("compile_wall_s", 0.0),
            "tinysql_progcache_programs": progcache.size()}


def _src_pool() -> Dict[str, float]:
    from ..server.pool import gauges
    g = gauges()
    return {"tinysql_pool_queued": g["queued"],
            "tinysql_pool_running": g["running"]}


def _src_conn() -> Dict[str, float]:
    from ..server.admission import conn_stats_snapshot
    from ..server.server import conn_gauges
    g = conn_gauges()
    a = conn_stats_snapshot()
    return {"tinysql_conn_open": g["open"],
            "tinysql_conn_idle": g["idle"],
            "tinysql_conn_active": g["active"],
            "tinysql_conn_accepts_total": a.get("accepts", 0),
            "tinysql_conn_sheds_total": a.get("sheds", 0)}


def _src_admission() -> Dict[str, float]:
    from ..server.admission import aggregate_stmt_mem, stats_snapshot
    a = stats_snapshot()
    return {"tinysql_admission_admitted_total": a.get("admitted", 0),
            "tinysql_admission_queued_total": a.get("queued", 0),
            "tinysql_admission_rejected_total": a.get("rejected", 0),
            "tinysql_admission_queue_wait_seconds_total":
                a.get("queue_wait_s_sum", 0.0),
            "tinysql_stmt_mem_inflight_bytes": aggregate_stmt_mem()}


def _src_batching() -> Dict[str, float]:
    from ..ops.batching import stats_snapshot
    b = stats_snapshot()
    return {"tinysql_batch_rounds_total": b.get("batches", 0),
            "tinysql_batch_statements_total":
                b.get("batched_statements", 0),
            "tinysql_batch_occupancy_sum": b.get("occupancy_sum", 0),
            "tinysql_batch_fallbacks_total": b.get("fallbacks", 0),
            "tinysql_batch_stacked_rounds_total":
                b.get("stacked_rounds", 0),
            "tinysql_batch_stacked_occupancy_sum":
                b.get("stacked_occupancy_sum", 0),
            "tinysql_batch_stack_fallbacks_total":
                b.get("stack_fallbacks", 0),
            "tinysql_batch_dispatch_seconds_total":
                b.get("dispatch_s_sum", 0.0)}


def _src_memory() -> Dict[str, float]:
    from ..utils import memory as mem
    return {"tinysql_mem_quota_exceeded_total": mem.aborts_total()}


def _src_shardops() -> Dict[str, float]:
    from ..ops.shardops import stats_snapshot
    from .metrics import SHARD_METRIC_NAMES
    s = stats_snapshot()
    return {name: s.get(key, 0) for key, name in SHARD_METRIC_NAMES}


def _src_wal() -> Dict[str, float]:
    from ..kv.wal import stats_snapshot
    from .metrics import WAL_METRIC_NAMES
    s = stats_snapshot()
    if not any(s.values()):
        return {}  # volatile store: zero movement, zero samples
    return {name: s.get(key, 0) for key, name in WAL_METRIC_NAMES}


def _src_flight() -> Dict[str, float]:
    from .flight import stats_snapshot
    from .metrics import FLIGHT_METRIC_NAMES
    s = stats_snapshot()
    if not any(s.values()):
        return {}  # no data dir armed: zero movement, zero samples
    return {name: s.get(key, 0) for key, name in FLIGHT_METRIC_NAMES}


def _src_identity() -> Dict[str, float]:
    from .flight import current_incarnation, server_start_ts
    return {"tinysql_incarnation": float(current_incarnation()),
            "tinysql_server_start_timestamp": server_start_ts()}


def _src_failpoints() -> Dict[str, float]:
    from .. import fail
    return {"tinysql_failpoint_hits_total": sum(fail.hits().values())}


def _src_prewarm() -> Dict[str, float]:
    from ..session.prewarm import stats_snapshot
    return {f"tinysql_prewarm_worker_{k}_total": v
            for k, v in stats_snapshot().items()}


def _src_slo() -> Dict[str, float]:
    # SLO error-budget accounting: empty while tidb_slo_p99_ms is
    # unarmed (obs/inspect.slo_sample owns the bucket-edge math so the
    # source and the slo-burn rule share one definition)
    from . import inspect as oinspect
    return oinspect.slo_sample()


def _src_memory_state() -> Dict[str, float]:
    # measured-vs-tracked memory reconciliation (obs/memprof.py): the
    # tracked MemTracker ledger vs tracemalloc heap / RSS vs the HBM
    # census, plus the heap sampler's self-accounting — the evidence
    # series the heap-growth / hbm-pressure / mem-untracked rules judge
    from . import memprof
    return memprof.memory_state()


def _src_conprof() -> Dict[str, float]:
    # continuous host profiler (obs/conprof.py): the cpu-saturation and
    # profiler-overhead inspection rules judge these windowed deltas
    from . import conprof
    s = conprof.stats_snapshot()
    out = {"tinysql_conprof_samples_total": s.get("samples", 0),
           "tinysql_conprof_idle_samples_total":
               s.get("idle_samples", 0),
           "tinysql_conprof_attributed_samples_total":
               s.get("attributed", 0),
           "tinysql_conprof_ticks_total": s.get("ticks", 0),
           "tinysql_conprof_self_seconds_total": s.get("self_s", 0.0),
           "tinysql_conprof_evicted_total": s.get("evicted", 0),
           "tinysql_conprof_backoff": s.get("backoff", 1),
           "tinysql_conprof_stacks": s.get("stacks", 0),
           "tinysql_conprof_windows": s.get("windows", 0)}
    for role, n in s.get("role_busy", {}).items():
        out[conprof.role_metric(role)] = n
    return out


def _src_tsring() -> Dict[str, float]:
    s = stats_snapshot()
    return {"tinysql_metrics_samples_total": s.get("samples", 0),
            "tinysql_metrics_sample_seconds_total":
                s.get("sample_wall_s", 0.0),
            "tinysql_metrics_dropped_unregistered_total":
                s.get("dropped_unregistered", 0),
            "tinysql_metrics_ring_entries": RING.size()}


for _name, _fn in (("queries", _src_queries), ("kernels", _src_kernels),
                   ("progcache", _src_progcache), ("pool", _src_pool),
                   ("conn", _src_conn), ("admission", _src_admission),
                   ("batching", _src_batching), ("memory", _src_memory),
                   ("shardops", _src_shardops), ("wal", _src_wal),
                   ("flight", _src_flight),
                   ("identity", _src_identity),
                   ("failpoints", _src_failpoints),
                   ("prewarm", _src_prewarm), ("slo", _src_slo),
                   ("conprof", _src_conprof),
                   ("memory_state", _src_memory_state),
                   ("tsring", _src_tsring)):
    register_source(_name, _fn)

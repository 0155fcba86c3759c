"""Query-lifecycle observability.

The reference surface this reproduces: executor runtime stats feeding
``EXPLAIN ANALYZE`` (reference: util/execdetails + distsql/select_result
CopRuntimeStats), the slow-query log (executor/adapter.go LogSlowQuery),
and the HTTP status server's metrics export.  The TPU twist: the
interesting runtime facts here are *device economics* — program
dispatches, packed D2H transfers, compile-cache behavior, pipeline
stage/compute overlap — which used to live only in the process-global
``kernels.STATS`` dict, unattributable to a query or an operator.

Three cooperating pieces:

- **context** (`context.py`): a ``contextvars``-scoped ``QueryObs`` per
  statement.  Device-layer accessors (``kernels.stats_add`` /
  ``stats_hwm``, progcache hit/miss) fan each increment out to the
  active query scope and to the operator whose ``next()`` frame is live,
  so two concurrent sessions collect disjoint counters while the global
  totals stay monotonic for ``/metrics``.  The devpipe producer thread
  inherits the creator's scope via ``contextvars.copy_context``.
- **RuntimeStats** (`context.py` + `runtime_stats.py`): per-operator
  actual rows, Next loops, wall time, and device counters, collected by
  wrapping the Open/Next/Close executor interface (``instrument_tree``)
  — no per-executor code changes.
- **surfaces**: ``EXPLAIN ANALYZE`` (planner/explain.py), Prometheus
  ``/metrics`` + ``/debug/trace`` (server/http_status.py via
  `metrics.py` / `trace.py`), the JSONL slow-query log (`slowlog.py`,
  threshold sysvar ``tidb_slow_log_threshold``), and the bucket-prewarm
  feedback file (`feedback.py`, consumed by ``tools/warm.py
  --from-stats``).
- **SQL-queryable aggregates** (`stmtsummary.py`): the windowed,
  evicting per-(sql digest, plan digest) summary store behind
  ``information_schema.statements_summary`` / ``processlist`` /
  ``slow_query`` (catalog/memtables.py), ``EXPLAIN FOR CONNECTION``,
  and the ``/metrics`` per-phase latency histograms.  Written ONLY from
  the session statement-close hook (qlint OB403).
- **time series + self-diagnosis** (`tsring.py` + `inspect.py`): a
  background sampler snapshots every registered counter source into a
  bounded ring (``metrics_history`` / ``metrics_summary`` mem-tables,
  ``tidb_metrics_interval`` / ``tidb_metrics_retention``), metric
  names pinned to the central registry in `metrics.py` (qlint OB404);
  an inspection rule catalogue evaluates the ring into
  ``inspection_result`` / ``/debug/inspection`` findings with severity
  and the metric evidence window.  The serving path attributes each
  statement's queue/batch wait (server/pool.py measurement → spans,
  summary columns, slow-log fields, the ``queue`` phase histogram).
- **host-CPU truth** (`conprof.py`): an always-on
  continuous stack-sampling profiler — a background sampler walks
  ``sys._current_frames()`` at ``tidb_conprof_rate`` Hz, classifies
  threads by serving role (the stable thread-name vocabulary),
  folds stacks into stmtsummary-style rotating windows
  (``information_schema.continuous_profiling``, ``/debug/conprof``
  collapsed text for flamegraph.pl/speedscope), and attributes
  samples to the statement running on the sampled thread
  (``statements_summary`` ``sum_cpu_ms``/``cpu_samples``, invariant
  cpu <= exec wall; qlint OB406 guards the write path).  ``TRACE
  <stmt>`` renders the span tracer's tree as rows over SQL.
- **device-time truth** (ops/profiler.py + ops/progcache.py, ISSUE
  11): the default timings are host walls around ASYNC enqueues; the
  opt-in sampling profiler (``tidb_device_profile_rate``) closes
  sampled dispatches with ``block_until_ready`` so ``device_s`` /
  ``compile_s`` carry measured truth into EXPLAIN ANALYZE,
  ``statements_summary``, the per-program catalog
  (``information_schema.compiled_programs``), and the
  ``tinysql_dispatch_device_seconds`` histogram (qlint OB405 guards
  the write path).

See docs/OBSERVABILITY.md.
"""
from .context import (QueryObs, RuntimeStats, activate, current,
                      current_op, deactivate, record, record_hwm, span)
from .runtime_stats import instrument_tree
from .trace import Tracer, recent_traces

__all__ = [
    "QueryObs", "RuntimeStats", "Tracer", "activate", "current",
    "current_op", "deactivate", "instrument_tree", "record", "record_hwm",
    "recent_traces", "span",
]

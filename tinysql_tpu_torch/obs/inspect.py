"""Automated inspection engine: the system diagnosing itself (reference
lineage: TiDB's ``information_schema.inspection_result`` — a registered
rule catalogue evaluated over the metrics store, each finding carrying
severity, details, and the metric evidence that triggered it).

Rules evaluate over the time-series ring (obs/tsring.py) and the
statement-summary store: each one is a plain function registered in the
RULE catalogue via :func:`rule`, receiving an :class:`InspectionContext`
(windowed metric deltas/series + summary records) and yielding
:class:`Finding`\\ s.  ``run()`` — the ``inspection_result`` mem-table
payload and the ``/debug/inspection`` endpoint — evaluates every rule
and never raises: a broken rule reports ITSELF as a finding instead of
taking the surface down.

The registered catalogue (each has an induced-condition test in
tests/test_tsring.py):

- **compile-storm**: program-build (progcache miss) burst within the
  window — literal parameterization or prewarm regressed, or an
  unparameterized workload arrived;
- **progcache-hit-rate**: registry hit rate collapsed under real lookup
  traffic;
- **pool-saturation**: admission shed statements (1041) in the window,
  or the queue gauge stayed deep — the serving tier is saturated;
- **cooldown-flapping**: repeated device losses within one window keep
  re-pinning planning to CPU (a flapping accelerator, not a blip);
- **memory-pressure**: statements aborted on tidb_mem_quota_query;
- **spill-pressure**: statements running memory-adaptive (spilling)
  execution within the window — the quota is actively constraining the
  workload (warning), escalating to critical when recursive
  repartitioning fires (working sets far beyond the budget);
- **prewarm-starvation**: the auto-prewarm worker left candidates
  unwarmed (budget exhausted / errors) while cold-run-shaped latency
  exists — the cold-start killer is starved;
- **dispatch-storm**: device dispatches per query regressed
  past the threshold within the window — plan fusion / micro-batching
  stopped covering the workload, or block sizes collapsed;
- **transfer-bound**: D2H bytes moved in the window dwarf
  the MEASURED device busy time (sampling profiler on) — latency is
  the link, not the kernels;
- **recompile-churn**: program builds keep landing on WARM
  digest families (statements_summary: misses across executions far
  beyond the first run's) — literal parameterization or shape
  bucketing regressed for those families;
- **slo-burn**: the exec-phase latency
  histogram shows > 1% of windowed measurements over the armed
  ``tidb_slo_p99_ms`` — the p99 objective's error budget is burning.
  Fed by the ``slo`` ring source (:func:`slo_sample`).
- **batching-degraded**: too many batched replay attempts
  fell back to solo dispatch within the window (consume misses —
  replica rotation, plan re-placement, param-layout churn): the
  coalescer is paying its protocol cost without the one-dispatch win;
- **connection-pressure**: the accept gate is refusing
  connects with MySQL 1040 (``tinysql_conn_sheds_total``); critical
  when a window sheds more connections than it admits;
- **shard-imbalance**: sharded operator attempts keep
  abandoning for partition skew (``tinysql_shard_skew_retries_total``)
  — one hash partition rivals the whole input, so the mesh sits idle
  while those operators run single-device; critical when the window
  abandoned more attempts than it completed sharded rounds;
- **wal-stall**: the durability journal is degraded — mean
  WAL fsync wall time within the window past threshold (under
  ``tidb_wal_fsync=strict`` every commit-class ack pays it), or any
  append/fsync ERROR at all (critical: writes surface typed WalErrors
  and nothing new is durable until the log is writable);
- **cpu-saturation**: one thread role dominates the busy
  host-CPU samples (obs/conprof.py) while the admission queue is
  non-empty — the serving tier's latency is host CPU in that role, and
  /debug/conprof has the dominant stacks;
- **profiler-overhead**: the continuous profiler's own
  sampling cost ran past its budget share of one core — the rule
  reports it while the sampler's backoff divisor absorbs it;
- **heap-growth**: the MEASURED python heap
  (obs/memprof.py) rose monotonically across the window past the
  threshold — leak-shaped growth, with /debug/heap holding the sites;
- **hbm-pressure**: the HBM census approaches the backend's
  exposed device-memory capacity (silent on CPU, which exposes none);
- **mem-untracked**: measured heap growth diverged from the
  MemTracker ledger beyond the documented band — allocation the
  spill/admission gates cannot see.

Thresholds are module-level constants, deliberately conservative: an
inspection finding is a diagnosis, so false positives cost trust.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from . import tsring

# ---- thresholds -----------------------------------------------------------

#: default evidence window for the serving surfaces (inspection_result,
#: /debug/inspection): a finding is a diagnosis of what is wrong NOW,
#: so the mem-table judges the last 5 minutes — not the whole retained
#: ring, where one transient 1041 spike would read as a live critical
#: finding until it aged past tidb_metrics_retention (15 min default)
DEFAULT_WINDOW_S = 300

#: progcache misses within the window that count as a compile storm
COMPILE_STORM_MISSES = 8
#: minimum registry lookups before the hit-rate rule may judge
HIT_RATE_MIN_LOOKUPS = 20
HIT_RATE_FLOOR = 0.5
#: sustained queue depth (max over window) that flags saturation even
#: without sheds
POOL_QUEUED_WARN = 8
#: device losses within one window = flapping (one loss is a blip the
#: cooldown already absorbs)
COOLDOWN_FLAP_LOSSES = 2
#: spilled bytes within the window that make the spill-pressure rule
#: speak up (a trickle of spilling is the feature working as designed)
SPILL_PRESSURE_BYTES = 1 << 20
#: device dispatches per query that count as a storm (warm fused plans
#: run 1-6 programs per query; micro-batching drives it under 1), and
#: the minimum windowed query traffic before the ratio may judge
DISPATCH_STORM_PER_QUERY = 12
DISPATCH_STORM_MIN_QUERIES = 10
#: D2H volume floor and the bytes-per-measured-device-second ratio
#: beyond which a window reads transfer-bound (1 GiB per busy second:
#: the link is doing orders of magnitude more work than the device)
TRANSFER_BOUND_MIN_BYTES = 32 << 20
TRANSFER_BOUND_BYTES_PER_DEVICE_S = 1 << 30
#: recompile churn: a digest family with at least this many executions
#: whose summed program builds exceed misses-per-exec x executions is
#: compiling on WARM runs, not just its first
RECOMPILE_MIN_EXECS = 4
RECOMPILE_MISSES_PER_EXEC = 1.5
#: SLO burn: minimum windowed exec measurements before judging, and the
#: breach fraction that burns a p99 objective's error budget (1%)
SLO_MIN_MEASUREMENTS = 20
SLO_BURN_FRAC = 0.01
#: cpu-saturation: minimum windowed BUSY profiler samples before the
#: role-share ratio may judge, and the share at which one role reads
#: window-dominant (only judged while the admission queue was non-empty
#: — a dominant role with an empty queue is just the workload's shape)
CPU_SAT_MIN_BUSY_SAMPLES = 50
CPU_SAT_DOMINANT_SHARE = 0.6
CPU_SAT_CRITICAL_SHARE = 0.85
#: profiler-overhead: the sampler's self-cost share of one core beyond
#: which the finding fires (obs/conprof.py backs its rate off at the
#: same budget — the rule reports what the backoff is absorbing)
PROFILER_OVERHEAD_BUDGET = 0.03
#: batching-degraded: minimum windowed replay ATTEMPTS (replays +
#: consume-miss fallbacks) / stacked-leg GROUPS (stacked rounds +
#: stack fallbacks) before either degradation ratio may judge, and the
#: degraded share at warning / critical (shared by both legs).  The
#: stacked leg is judged separately in its own units — a group that
#: fell back to back-to-back replays still coalesced and replays
#: cleanly, but the one-dispatch win is gone
BATCH_DEGRADED_MIN_ATTEMPTS = 10
BATCH_DEGRADED_MIN_GROUPS = 5
BATCH_DEGRADED_WARN = 0.20
BATCH_DEGRADED_CRIT = 0.50

#: shard-imbalance: sharded attempts abandoned for partition skew
#: within the window before the rule speaks — one clustered key set
#: bailing to the single-device kernel is the capacity gate working as
#: designed, a stream of them means the mesh is idle for this workload
SHARD_SKEW_RETRIES_WARN = 2

#: wal-stall: minimum windowed fsyncs before the mean may
#: judge (one slow sync on a cold disk is noise), and the mean fsync
#: wall seconds at warning / critical — past these every commit-class
#: ack under the strict policy eats the stall, so commit latency IS
#: the disk.  Any windowed append/fsync error is critical outright:
#: the durability path itself failed.
WAL_STALL_MIN_FSYNCS = 5
WAL_STALL_MEAN_WARN_S = 0.010
WAL_STALL_MEAN_CRIT_S = 0.050

#: connection-pressure: minimum windowed 1040 sheds before
#: the rule speaks at all — one refused connect is a client retrying
#: against a deliberately small cap, not pressure
CONN_SHEDS_WARN = 2

#: heap-growth: minimum sampled points of the traced-heap
#: gauge before monotone-rise leak detection may judge, the fraction of
#: point-to-point steps that must be rises (a sawtooth heap is a cache,
#: not a leak), and the total windowed rise in bytes that makes the
#: pattern worth reporting
HEAP_GROWTH_MIN_POINTS = 4
HEAP_GROWTH_RISE_FRAC = 0.9
HEAP_GROWTH_MIN_BYTES = 32 << 20
#: hbm-pressure: census share of the backend's exposed device-memory
#: capacity at which the finding fires (never on backends that expose
#: no limit — CPU reads bytes_limit 0)
HBM_PRESSURE_FRAC = 0.85
HBM_PRESSURE_CRIT_FRAC = 0.95


class Finding:
    """One diagnosis: rule, severity, the metric evidence window."""

    __slots__ = ("rule", "item", "severity", "details", "metric",
                 "start_ts", "end_ts", "first_value", "last_value",
                 "max_value")

    def __init__(self, rule: str, item: str, severity: str, details: str,
                 metric: str = "", start_ts: float = 0.0,
                 end_ts: float = 0.0, first_value: float = 0.0,
                 last_value: float = 0.0, max_value: float = 0.0):
        self.rule = rule
        self.item = item
        self.severity = severity      # "warning" | "critical"
        self.details = details
        self.metric = metric
        self.start_ts = start_ts
        self.end_ts = end_ts
        self.first_value = first_value
        self.last_value = last_value
        self.max_value = max_value

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def row(self) -> list:
        stamp = tsring._ts(time.time())
        return [stamp, self.rule, self.item, self.severity, self.details,
                self.metric,
                tsring._ts(self.start_ts) if self.start_ts else "",
                tsring._ts(self.end_ts) if self.end_ts else "",
                float(self.first_value), float(self.last_value),
                float(self.max_value)]


#: information_schema.inspection_result column order — MUST match
#: Finding.row
COLUMNS = [
    ("time", "str"), ("rule", "str"), ("item", "str"),
    ("severity", "str"), ("details", "str"), ("metric", "str"),
    ("evidence_start", "str"), ("evidence_end", "str"),
    ("first_value", "real"), ("last_value", "real"),
    ("max_value", "real"),
]


class InspectionContext:
    """What a rule sees: windowed reads over the ring + the statement
    summary.  ``window_s`` bounds the evidence span (None = everything
    retained)."""

    def __init__(self, ring: tsring.MetricsRing,
                 now: Optional[float] = None,
                 window_s: Optional[float] = None):
        self.now = time.time() if now is None else now
        self.window_s = window_s
        # ONE consistent copy for the whole evaluation: every rule's
        # delta/max/evidence reads see the same samples, so a finding's
        # evidence can never disagree with the delta that triggered it
        # (and a full run takes one ring lock, not ~15)
        self._samples = ring.snapshot_samples()

    def series(self, metric: str) -> List[tuple]:
        since = self.now - self.window_s if self.window_s else None
        out: List[tuple] = []
        for ts, vals in self._samples:
            if (since is not None and ts < since) or ts > self.now:
                continue
            if metric in vals:
                out.append((ts, float(vals[metric])))
        return out

    def delta(self, metric: str) -> float:
        """last - first over the window (0 with < 2 points)."""
        pts = self.series(metric)
        return pts[-1][1] - pts[0][1] if len(pts) >= 2 else 0.0

    def max_value(self, metric: str) -> float:
        pts = self.series(metric)
        return max(v for _, v in pts) if pts else 0.0

    def last(self, metric: str) -> float:
        pts = self.series(metric)
        return pts[-1][1] if pts else 0.0

    def evidence(self, rule: str, item: str, severity: str, details: str,
                 metric: str) -> Finding:
        """Build a finding whose evidence window is the metric's sampled
        span."""
        pts = self.series(metric)
        return Finding(
            rule, item, severity, details, metric,
            start_ts=pts[0][0] if pts else 0.0,
            end_ts=pts[-1][0] if pts else 0.0,
            first_value=pts[0][1] if pts else 0.0,
            last_value=pts[-1][1] if pts else 0.0,
            max_value=max((v for _, v in pts), default=0.0))

    def summary_records(self) -> List[dict]:
        from . import stmtsummary
        return stmtsummary.snapshot()


# ---- the SLO objective (tidb_slo_p99_ms) ----------------------------------

#: the armed p99 objective in MILLISECONDS (0 = no SLO): process-global
#: module state applied by the session SET hook / server start, like
#: kernels.set_compile_cache_dir — there is one latency surface
SLO_STATE = {"p99_ms": 0.0}


def set_slo_p99_ms(ms: float) -> None:
    try:
        v = float(ms)
    except (TypeError, ValueError):
        v = 0.0
    # qlint: disable=CC701 -- single GIL-atomic scalar-slot publish (no compound invariant); readers tolerate either the old or new objective
    SLO_STATE["p99_ms"] = max(v, 0.0)


def slo_p99_ms() -> float:
    return SLO_STATE["p99_ms"]


def slo_sample() -> Dict[str, float]:
    """The ``slo`` ring source payload: total exec-phase measurements
    and the count PROVABLY over the armed threshold (bucket lower edge
    >= SLO — conservative; the overflow bucket counts whenever the SLO
    sits at or under the last bound).  Sampled into the ring so the
    slo-burn rule judges a windowed DELTA, not the whole process
    history.  Empty while no SLO is armed."""
    slo_ms = SLO_STATE["p99_ms"]
    if slo_ms <= 0:
        return {}
    from .stmtsummary import histogram_snapshot
    h = histogram_snapshot().get("exec")
    if not h:
        return {}
    slo_s = slo_ms / 1e3
    over = 0
    prev = 0.0
    for le, count in h["buckets"]:
        if prev >= slo_s:
            over += count
        prev = le
    if slo_s <= prev:
        over += h.get("overflow", 0)
    # the armed threshold rides along as a gauge: breach counts are
    # recomputed over the cumulative histogram against the CURRENT
    # threshold, so the slo-burn rule must discard windows where the
    # objective changed (a lowered SLO would otherwise reclassify all
    # history as one window's breach delta)
    return {"tinysql_slo_exec_measurements_total": h["count"],
            "tinysql_slo_exec_breaches_total": over,
            "tinysql_slo_p99_ms": slo_ms}


# ---- the rule catalogue ---------------------------------------------------

RULES: Dict[str, Callable[[InspectionContext], List[Finding]]] = {}


def rule(name: str):
    """Register one inspection rule (decorator)."""
    def deco(fn):
        RULES[name] = fn
        return fn
    return deco


@rule("compile-storm")
def _rule_compile_storm(ctx: InspectionContext) -> List[Finding]:
    metric = "tinysql_progcache_misses_total"
    d = ctx.delta(metric)
    if d < COMPILE_STORM_MISSES:
        return []
    sev = "critical" if d >= 2 * COMPILE_STORM_MISSES else "warning"
    return [ctx.evidence(
        "compile-storm", "progcache", sev,
        f"{d:.0f} program builds within the window (threshold "
        f"{COMPILE_STORM_MISSES}): literal parameterization or prewarm "
        "is missing this workload's digest families", metric)]


@rule("progcache-hit-rate")
def _rule_hit_rate(ctx: InspectionContext) -> List[Finding]:
    hits = ctx.delta("tinysql_progcache_hits_total")
    misses = ctx.delta("tinysql_progcache_misses_total")
    lookups = hits + misses
    if lookups < HIT_RATE_MIN_LOOKUPS:
        return []
    rate = hits / lookups
    if rate >= HIT_RATE_FLOOR:
        return []
    return [ctx.evidence(
        "progcache-hit-rate", "progcache", "warning",
        f"registry hit rate {rate:.2f} over {lookups:.0f} lookups "
        f"(floor {HIT_RATE_FLOOR}): the program cache stopped covering "
        "the live workload", "tinysql_progcache_hits_total")]


@rule("pool-saturation")
def _rule_pool_saturation(ctx: InspectionContext) -> List[Finding]:
    out: List[Finding] = []
    shed = ctx.delta("tinysql_admission_rejected_total")
    if shed > 0:
        out.append(ctx.evidence(
            "pool-saturation", "admission", "critical",
            f"{shed:.0f} statement(s) shed with MySQL 1041 within the "
            "window: the admission queue hit its cap — raise "
            "tidb_stmt_pool_size / queue_depth or reduce load",
            "tinysql_admission_rejected_total"))
    deep = ctx.max_value("tinysql_pool_queued")
    if not out and deep >= POOL_QUEUED_WARN:
        out.append(ctx.evidence(
            "pool-saturation", "pool", "warning",
            f"statement queue reached depth {deep:.0f} (threshold "
            f"{POOL_QUEUED_WARN}) without shedding: latency is queue "
            "wait, not execution", "tinysql_pool_queued"))
    return out


@rule("connection-pressure")
def _rule_connection_pressure(ctx: InspectionContext) -> List[Finding]:
    """Sustained 1040 sheds at the accept gate: warning
    while some connects are refused, critical when the window shed MORE
    connects than it admitted — the wire tier is turning away the
    majority of new clients."""
    sheds = ctx.delta("tinysql_conn_sheds_total")
    if sheds < CONN_SHEDS_WARN:
        return []
    accepts = ctx.delta("tinysql_conn_accepts_total")
    sev = "critical" if sheds > accepts else "warning"
    return [ctx.evidence(
        "connection-pressure", "wire", sev,
        f"{sheds:.0f} connection(s) refused with MySQL 1040 within the "
        f"window ({accepts:.0f} admitted): tidb_max_server_connections "
        "is actively shedding connects — raise the cap (the aio front "
        "end holds idle connections at ~zero thread cost) or add "
        "serving capacity", "tinysql_conn_sheds_total")]


@rule("cooldown-flapping")
def _rule_cooldown_flapping(ctx: InspectionContext) -> List[Finding]:
    metric = "tinysql_device_loss_total"
    d = ctx.delta(metric)
    if d < COOLDOWN_FLAP_LOSSES:
        return []
    return [ctx.evidence(
        "cooldown-flapping", "device", "critical",
        f"{d:.0f} device losses within the window: the accelerator is "
        "flapping, planning keeps re-pinning to CPU "
        "(tidb_device_cooldown) — investigate the backend, not the "
        "queries", metric)]


@rule("memory-pressure")
def _rule_memory_pressure(ctx: InspectionContext) -> List[Finding]:
    metric = "tinysql_mem_quota_exceeded_total"
    d = ctx.delta(metric)
    if d <= 0:
        return []
    return [ctx.evidence(
        "memory-pressure", "quota", "warning",
        f"{d:.0f} statement(s) aborted on tidb_mem_quota_query within "
        "the window (error 8175): quotas are actively shedding memory "
        "pressure", metric)]


@rule("spill-pressure")
def _rule_spill_pressure(ctx: InspectionContext) -> List[Finding]:
    out: List[Finding] = []
    spilled = ctx.delta("tinysql_spill_bytes_total")
    stmts = ctx.delta("tinysql_spilled_statements_total")
    repart = ctx.delta("tinysql_spill_repartitions_total")
    if repart > 0:
        out.append(ctx.evidence(
            "spill-pressure", "repartition", "critical",
            f"{repart:.0f} recursive repartition event(s) within the "
            "window: working sets far exceed the spill budget "
            "(tidb_mem_quota_query x tidb_mem_quota_spill_ratio) — "
            "statements are one depth-exhaustion away from 8175",
            "tinysql_spill_repartitions_total"))
    if not out and spilled >= SPILL_PRESSURE_BYTES:
        mb = spilled / (1 << 20)
        out.append(ctx.evidence(
            "spill-pressure", "spill", "warning",
            f"{mb:.1f} MiB spilled by {stmts:.0f} statement(s) within "
            "the window: memory-adaptive execution is actively bounding "
            "working sets — latency includes spill I/O; raise "
            "tidb_mem_quota_query if this workload should run resident",
            "tinysql_spill_bytes_total"))
    return out


@rule("prewarm-starvation")
def _rule_prewarm_starvation(ctx: InspectionContext) -> List[Finding]:
    out: List[Finding] = []
    budget = ctx.delta("tinysql_prewarm_worker_skipped_budget_total")
    if budget > 0:
        # size the blast radius from statements_summary: every SELECT
        # family currently aggregating is a potential cold-start victim
        # of a starved warmer
        try:
            fams = sum(1 for r in ctx.summary_records()
                       if (r.get("stmt_type") or "").lower() == "select")
        except Exception:
            fams = 0
        out.append(ctx.evidence(
            "prewarm-starvation", "budget", "warning",
            f"{budget:.0f} prewarm candidate(s) deferred by "
            "tidb_auto_prewarm_budget_ms within the window "
            f"({fams} SELECT families live in statements_summary): "
            "cold-start compiles will land on real queries — raise the "
            "budget or top_k",
            "tinysql_prewarm_worker_skipped_budget_total"))
    errs = ctx.delta("tinysql_prewarm_worker_errors_total")
    if errs > 0:
        out.append(ctx.evidence(
            "prewarm-starvation", "errors", "warning",
            f"{errs:.0f} prewarm warm attempt(s) failed within the "
            "window: their families stay cold for the cooldown",
            "tinysql_prewarm_worker_errors_total"))
    return out


@rule("dispatch-storm")
def _rule_dispatch_storm(ctx: InspectionContext) -> List[Finding]:
    queries = ctx.delta("tinysql_queries_total")
    if queries < DISPATCH_STORM_MIN_QUERIES:
        return []
    dispatches = ctx.delta("tinysql_dispatches_total")
    per_query = dispatches / queries
    if per_query < DISPATCH_STORM_PER_QUERY:
        return []
    sev = "critical" if per_query >= 2 * DISPATCH_STORM_PER_QUERY \
        else "warning"
    return [ctx.evidence(
        "dispatch-storm", "dispatches", sev,
        f"{per_query:.1f} device dispatches per query over "
        f"{queries:.0f} statements within the window (threshold "
        f"{DISPATCH_STORM_PER_QUERY}): plan fusion / micro-batching "
        "stopped covering this workload, or block sizes collapsed — "
        "every extra dispatch pays the link's round trip",
        "tinysql_dispatches_total")]


@rule("transfer-bound")
def _rule_transfer_bound(ctx: InspectionContext) -> List[Finding]:
    moved = ctx.delta("tinysql_d2h_bytes_total")
    if moved < TRANSFER_BOUND_MIN_BYTES:
        return []
    profiled = ctx.delta("tinysql_profiled_dispatches_total")
    if profiled <= 0:
        # no measured device time in the window: judging the ratio
        # against an async submit wall would be exactly the fiction
        # this PR removes
        return []
    busy = ctx.delta("tinysql_device_busy_seconds_total")
    # busy accrues only on SAMPLED dispatches: at a fractional profile
    # rate it covers ~rate of the true device time, so extrapolate by
    # the window's dispatches-per-profiled-dispatch before judging —
    # otherwise a healthy workload at rate 0.1 reads 10x too
    # transfer-bound
    dispatches = ctx.delta("tinysql_dispatches_total")
    est_busy = busy * (max(dispatches, profiled) / profiled)
    ratio = moved / max(est_busy, 1e-9)
    if ratio < TRANSFER_BOUND_BYTES_PER_DEVICE_S:
        return []
    return [ctx.evidence(
        "transfer-bound", "d2h", "warning",
        f"{moved / (1 << 20):.1f} MiB pulled device-to-host against "
        f"~{est_busy * 1e3:.1f} ms of device busy time within the "
        f"window (measured {busy * 1e3:.1f} ms over {profiled:.0f} of "
        f"{dispatches:.0f} dispatches): the workload is transfer-bound "
        "— push projections/filters device-side, or keep results "
        "resident (tidb_device_passthrough)",
        "tinysql_d2h_bytes_total")]


@rule("recompile-churn")
def _rule_recompile_churn(ctx: InspectionContext) -> List[Finding]:
    out: List[Finding] = []
    for r in ctx.summary_records():
        n = int(r.get("exec_count", 0))
        if n < RECOMPILE_MIN_EXECS:
            continue
        misses = float(r.get("device", {}).get("progcache_misses", 0))
        if misses <= n * RECOMPILE_MISSES_PER_EXEC:
            continue
        out.append(Finding(
            "recompile-churn", r.get("digest", ""), "warning",
            f"{misses:.0f} program builds across {n} executions of a "
            "warm digest family (threshold "
            f"{RECOMPILE_MISSES_PER_EXEC}/exec beyond the first run): "
            "literal parameterization or shape bucketing stopped "
            "covering this family — constant variants are compiling "
            "instead of hitting", "tinysql_progcache_misses_total"))
    return out


@rule("batching-degraded")
def _rule_batching_degraded(ctx: InspectionContext) -> List[Finding]:
    out: List[Finding] = []

    def sev_of(ratio: float) -> Optional[str]:
        if ratio < BATCH_DEGRADED_WARN:
            return None
        return "critical" if ratio >= BATCH_DEGRADED_CRIT else "warning"

    # replay leg: members served from round dispatches plus the
    # consume misses that fell back to solo re-dispatch
    replays = ctx.delta("tinysql_batch_statements_total")
    misses = ctx.delta("tinysql_batch_fallbacks_total")
    attempts = replays + misses
    if attempts >= BATCH_DEGRADED_MIN_ATTEMPTS:
        sev = sev_of(misses / attempts)
        if sev:
            out.append(ctx.evidence(
                "batching-degraded", "replay", sev,
                f"{misses / attempts:.0%} of {attempts:.0f} batched "
                "replay attempts within the window fell back to solo "
                f"dispatch (warning {BATCH_DEGRADED_WARN:.0%} / critical "
                f"{BATCH_DEGRADED_CRIT:.0%}): replica rotation or plan "
                "re-placement is defeating the coalescer — batching "
                "pays its collect/replay cost without the win",
                "tinysql_batch_fallbacks_total"))
    # stacked leg, in its own units: groups that should have ridden ONE
    # vmap-batched dispatch but fell back to back-to-back replays
    rounds = ctx.delta("tinysql_batch_stacked_rounds_total")
    stack_falls = ctx.delta("tinysql_batch_stack_fallbacks_total")
    groups = rounds + stack_falls
    if groups >= BATCH_DEGRADED_MIN_GROUPS:
        sev = sev_of(stack_falls / groups)
        if sev:
            out.append(ctx.evidence(
                "batching-degraded", "stacked", sev,
                f"{stack_falls / groups:.0%} of {groups:.0f} stackable "
                "batch groups within the window fell back to the legacy "
                f"back-to-back leg (warning {BATCH_DEGRADED_WARN:.0%} / "
                f"critical {BATCH_DEGRADED_CRIT:.0%}): param-layout "
                "churn or a missing stacking recipe is costing the "
                "one-dispatch-per-round win (results stay correct)",
                "tinysql_batch_stack_fallbacks_total"))
    return out


@rule("shard-imbalance")
def _rule_shard_imbalance(ctx: InspectionContext) -> List[Finding]:
    """Sharded attempts repeatedly abandoned for partition skew
   : the hash partitioner keeps producing one block that
    rivals the whole input, so partition-parallel operators bail to
    their single-device kernels and the mesh sits idle.  Evidence is
    the skew-retry delta judged against completed sharded rounds, with
    the per-shard row high-water mark as sizing context."""
    retries = ctx.delta("tinysql_shard_skew_retries_total")
    if retries < SHARD_SKEW_RETRIES_WARN:
        return []
    rounds = ctx.delta("tinysql_shard_rounds_total")
    hwm = ctx.max_value("tinysql_shard_rows_hwm")
    sev = "critical" if retries > rounds else "warning"
    return [ctx.evidence(
        "shard-imbalance", "mesh", sev,
        f"{retries:.0f} sharded attempt(s) abandoned for partition skew "
        f"within the window against {rounds:.0f} completed sharded "
        f"rounds (per-shard row high-water mark {hwm:.0f}): one hash "
        "partition keeps rivaling the whole input, so those operators "
        "ran single-device — this key distribution defeats the "
        "partitioner; results stay correct, the mesh speedup is gone",
        "tinysql_shard_skew_retries_total")]


@rule("wal-stall")
def _rule_wal_stall(ctx: InspectionContext) -> List[Finding]:
    """Durability path degraded: WAL fsyncs stalling (under
    the strict policy every commit-class ack waits on one, so commit
    latency IS the disk) or — worse — append/fsync errors, meaning the
    journal itself is failing while the store keeps refusing to diverge
    ahead of it."""
    out: List[Finding] = []
    errs = (ctx.delta("tinysql_wal_append_errors_total")
            + ctx.delta("tinysql_wal_fsync_errors_total"))
    if errs > 0:
        out.append(ctx.evidence(
            "wal-stall", "storage", "critical",
            f"{errs:.0f} WAL append/fsync error(s) within the window: "
            "the durability journal is failing — affected mutations "
            "surfaced typed WalErrors without mutating the store, but "
            "no new write is durable until the log is writable again "
            "(check the data dir's filesystem)",
            "tinysql_wal_fsync_errors_total"))
    fsyncs = ctx.delta("tinysql_wal_fsyncs_total")
    if fsyncs >= WAL_STALL_MIN_FSYNCS:
        mean_s = ctx.delta("tinysql_wal_fsync_seconds_total") / fsyncs
        if mean_s >= WAL_STALL_MEAN_WARN_S:
            sev = ("critical" if mean_s >= WAL_STALL_MEAN_CRIT_S
                   else "warning")
            out.append(ctx.evidence(
                "wal-stall", "storage", sev,
                f"mean WAL fsync took {mean_s * 1000:.1f}ms over "
                f"{fsyncs:.0f} sync(s) in the window: commit-class "
                "acks under tidb_wal_fsync=strict are paying this "
                "stall per statement — a slow or contended data-dir "
                "disk; consider tidb_wal_fsync=relaxed (group commit) "
                "if power-loss durability per ack is not required",
                "tinysql_wal_fsync_seconds_total"))
    return out


@rule("cpu-saturation")
def _rule_cpu_saturation(ctx: InspectionContext) -> List[Finding]:
    # judged only while the admission queue was non-empty in the
    # window: host CPU concentrating in one role while statements WAIT
    # is the serving tier's bottleneck signature (ROADMAP items 2/3)
    queued = ctx.max_value("tinysql_pool_queued")
    if queued <= 0:
        return []
    from .conprof import ROLES, role_metric
    busy = {role: ctx.delta(role_metric(role)) for role in ROLES}
    total = sum(busy.values())
    if total < CPU_SAT_MIN_BUSY_SAMPLES:
        return []
    top_role = max(busy, key=lambda r: busy[r])
    share = busy[top_role] / total
    if share < CPU_SAT_DOMINANT_SHARE:
        return []
    sev = "critical" if share >= CPU_SAT_CRITICAL_SHARE else "warning"
    return [ctx.evidence(
        "cpu-saturation", top_role, sev,
        f"{share:.0%} of {total:.0f} busy host-CPU samples landed on "
        f"{top_role} threads while the admission queue held up to "
        f"{queued:.0f} statement(s): the host tier is CPU-bound in one "
        "role — check /debug/conprof for the dominant stacks before "
        "raising pool size (more workers on a saturated role only adds "
        "queue wait)", role_metric(top_role))]


@rule("profiler-overhead")
def _rule_profiler_overhead(ctx: InspectionContext) -> List[Finding]:
    metric = "tinysql_conprof_self_seconds_total"
    pts = ctx.series(metric)
    if len(pts) < 2:
        return []
    span = pts[-1][0] - pts[0][0]
    self_d = pts[-1][1] - pts[0][1]
    if span <= 0 or self_d <= 0:
        return []
    frac = self_d / span
    if frac <= PROFILER_OVERHEAD_BUDGET:
        return []
    backoff = ctx.last("tinysql_conprof_backoff") or 1
    return [ctx.evidence(
        "profiler-overhead", "conprof", "warning",
        f"the continuous profiler spent {frac:.1%} of one core on its "
        f"own sampling within the window (budget "
        f"{PROFILER_OVERHEAD_BUDGET:.0%}); the sampler is backing off "
        f"(current divisor {backoff:.0f} — effective rate = "
        "tidb_conprof_rate / divisor).  Lower tidb_conprof_rate or "
        "tidb_conprof_max_stacks if the backoff keeps climbing",
        metric)]


@rule("slo-burn")
def _rule_slo_burn(ctx: InspectionContext) -> List[Finding]:
    slo_ms = SLO_STATE["p99_ms"]
    if slo_ms <= 0:
        return []
    # an objective that CHANGED within (or since) the window makes the
    # breach delta meaningless — the samples were judged against
    # different thresholds; wait for a stable window
    armed = ctx.series("tinysql_slo_p99_ms")
    if armed and (min(v for _, v in armed) != max(v for _, v in armed)
                  or armed[-1][1] != slo_ms):
        return []
    total = ctx.delta("tinysql_slo_exec_measurements_total")
    if total < SLO_MIN_MEASUREMENTS:
        return []
    over = ctx.delta("tinysql_slo_exec_breaches_total")
    if over <= 0:
        return []
    frac = over / total
    if frac <= SLO_BURN_FRAC:
        return []
    sev = "critical" if frac >= 5 * SLO_BURN_FRAC else "warning"
    return [ctx.evidence(
        "slo-burn", "p99", sev,
        f"{over:.0f} of {total:.0f} statements ({frac:.1%}) exceeded "
        f"the armed tidb_slo_p99_ms={slo_ms:g} within the window "
        f"(budget {SLO_BURN_FRAC:.0%} for a p99 objective): the error "
        "budget is burning — split the regression into queue wait vs "
        "execution via the phase histograms and statements_summary",
        "tinysql_slo_exec_breaches_total")]


@rule("heap-growth")
def _rule_heap_growth(ctx: InspectionContext) -> List[Finding]:
    # monotone-rise leak detection over the MEASURED python heap
    # (obs/memprof.py memory_state): a heap that only goes up, window
    # after window, is a leak — a working set breathes back down
    metric = "tinysql_mem_traced_bytes"
    pts = ctx.series(metric)
    if len(pts) < HEAP_GROWTH_MIN_POINTS:
        return []
    rise = pts[-1][1] - pts[0][1]
    if rise < HEAP_GROWTH_MIN_BYTES:
        return []
    steps = len(pts) - 1
    rises = sum(1 for i in range(steps) if pts[i + 1][1] >= pts[i][1])
    if rises / steps < HEAP_GROWTH_RISE_FRAC:
        return []
    return [ctx.evidence(
        "heap-growth", "heap", "warning",
        f"traced python heap rose {rise / 1048576.0:.1f} MiB "
        f"monotonically across {len(pts)} samples in the window "
        f"({rises}/{steps} rising steps): leak-shaped growth — "
        "/debug/heap has the allocation sites holding the bytes",
        metric)]


@rule("hbm-pressure")
def _rule_hbm_pressure(ctx: InspectionContext) -> List[Finding]:
    # HBM census vs the backend's exposed capacity; silent on backends
    # without a limit (CPU) — a share of zero is not evidence
    metric = "tinysql_hbm_live_bytes"
    limit = ctx.last("tinysql_hbm_limit_bytes")
    if limit <= 0:
        return []
    live = ctx.last(metric)
    share = live / limit
    if share < HBM_PRESSURE_FRAC:
        return []
    sev = "critical" if share >= HBM_PRESSURE_CRIT_FRAC else "warning"
    return [ctx.evidence(
        "hbm-pressure", "device", sev,
        f"live device buffers hold {share:.0%} of the backend's "
        f"{limit / 1048576.0:.0f} MiB capacity "
        "(information_schema.memory_usage attributes them by owner; a "
        "non-empty unattributed bucket there is a leak)", metric)]


@rule("mem-untracked")
def _rule_mem_untracked(ctx: InspectionContext) -> List[Finding]:
    # measured-vs-tracked divergence: windowed MEASURED heap growth
    # beyond everything the MemTracker ledger ever held in the window.
    # Deltas, not absolutes — the absolute traced number includes the
    # interpreter baseline no statement should answer for.  The band
    # (obs/memprof.UNTRACKED_BAND_BYTES) is the documented tolerance.
    from .memprof import UNTRACKED_BAND_BYTES
    metric = "tinysql_mem_traced_bytes"
    d_traced = ctx.delta(metric)
    tracked_peak = ctx.max_value("tinysql_mem_tracked_bytes")
    over = d_traced - tracked_peak - UNTRACKED_BAND_BYTES
    if over <= 0:
        return []
    return [ctx.evidence(
        "mem-untracked", "ledger", "warning",
        f"measured heap grew {d_traced / 1048576.0:.1f} MiB in the "
        "window while the statement MemTracker ledger peaked at "
        f"{tracked_peak / 1048576.0:.1f} MiB — "
        f"{over / 1048576.0:.1f} MiB past the "
        f"{UNTRACKED_BAND_BYTES >> 20} MiB band is allocation the "
        "spill/admission gates cannot see (operator working state "
        "missing its tracker charge)", metric)]


# ---- evaluation -----------------------------------------------------------

def run(now: Optional[float] = None, window_s: Optional[float] = None,
        ring: Optional[tsring.MetricsRing] = None) -> List[Finding]:
    """Evaluate every registered rule; never raises (a broken rule
    becomes its own finding)."""
    ctx = InspectionContext(ring if ring is not None else tsring.RING,
                            now=now, window_s=window_s)
    findings: List[Finding] = []
    for name, fn in RULES.items():
        try:
            findings.extend(fn(ctx) or [])
        except Exception as e:
            findings.append(Finding(
                name, "rule", "warning",
                f"inspection rule raised: {e!r}"))
    return findings


def rows(now: Optional[float] = None,
         window_s: Optional[float] = DEFAULT_WINDOW_S) -> List[list]:
    """The ``inspection_result`` mem-table payload.  Bounded to the
    recent window by default (``None`` = the whole retained ring)."""
    return [f.row() for f in run(now=now, window_s=window_s)]


def snapshot(now: Optional[float] = None,
             window_s: Optional[float] = DEFAULT_WINDOW_S) -> List[dict]:
    """The ``/debug/inspection`` payload.  Bounded to the recent window
    by default (``None`` = the whole retained ring)."""
    return [f.to_dict() for f in run(now=now, window_s=window_s)]

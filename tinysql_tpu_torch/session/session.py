"""Session: the statement lifecycle loop.

Capability parity with reference session/session.go (parse→compile→run
:569-629, txn lifecycle with lazy TSO :638-663, autocommit handling,
sysvar get/set :464-523), executor/compiler.go, executor/adapter.go
(ExecStmt), plus the SHOW / EXPLAIN / ADMIN / SimpleExec statement family
(executor/show.go, simple.go, set.go, ddl.go, explain.go).
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..catalog.infoschema import InfoSchema
from ..catalog.meta import Meta
from ..catalog.model import SchemaState, TableInfo
from ..executor.executors import ExecContext, build_executor
from ..executor.write import DeleteExec, InsertExec, WriteError
from ..expression import Constant, Schema
from ..kv import RetryableError, new_mock_storage
from ..mytypes import Datum, to_string
from ..parser import ParseError, ast, parse
from ..planner.builder import (ExprRewriter, HANDLE_COL_NAME, PlanBuilder,
                               PlanError)
from ..planner.logical import LogicalSelection
from ..planner.optimizer import optimize
from ..expression import Column as ExprColumn, split_cnf
from ..mytypes import new_int_type
from ..utils import interrupt, memory

DEFAULT_SYSVARS: Dict[str, Datum] = {
    # reference: sessionctx/variable/tidb_vars.go defaults
    "autocommit": 1,
    "tidb_max_chunk_size": 1024,
    "tidb_init_chunk_size": 32,
    "tidb_hash_join_concurrency": 5,
    "tidb_projection_concurrency": 4,
    "tidb_hashagg_partial_concurrency": 4,
    "tidb_hashagg_final_concurrency": 4,
    "tidb_distsql_scan_concurrency": 15,
    "tidb_index_lookup_concurrency": 4,
    "tidb_use_tpu": 1,           # device enforcer master switch
    "tidb_tpu_min_rows": 8192,   # row gate: smaller inputs stay on CPU
    "tidb_devpipe": -1,          # device pipelines (executor/devpipe.py):
                                 # -1 auto (on CUDA), 0 off, 1 force
    "tidb_enable_cascades_planner": 0,
    "tidb_mesh_parallel": 0,     # shard fused aggregates over the device mesh
    # mesh join strategy: build sides with more (bucketed) rows than this
    # shuffle-partition over the mesh via all_to_all; smaller ones
    # broadcast (reference P4 "partition build-side tables" north star)
    "tidb_broadcast_build_max_rows": 1 << 20,
    # device memory budget in ROWS per upload block: AGGREGATION over
    # tables above it runs block-wise (partial-state carry) instead of
    # whole-column resident, and the fused device pipeline stands down
    # (SURVEY §5.7 long-context analogue).  Other device operators are
    # not budget-aware yet.  0 = unlimited
    "tidb_device_block_rows": 0,
    # late materialization: aggregate outputs consumed by device joins
    # stay resident in device memory (DeviceColumn chunks); 0 forces the
    # host-extraction path
    "tidb_device_passthrough": 1,
    # block pipeline: staged blocks in flight ahead of the device
    # (executor/devpipe.py BlockPipeline — block-wise aggregation and
    # join probe streaming stage on a thread and a CUDA side stream).
    # 0 = synchronous staging (byte-identical results, no thread), the
    # default: the uploads come from pageable host memory, so a thread
    # and a side stream have no copy to overlap (PERF.md §6); the
    # TINYSQL_PIPELINE_DEPTH env var overrides for tests/CI
    "tidb_pipeline_depth": 0,
    # the reference's persistent XLA compile-cache directory; no meaning
    # under torch (the CUDA kernels build once per checkout, see
    # ops/_ext.py) — accepted and ignored (ops/kernels.py
    # set_compile_cache_dir)
    "tidb_compile_cache_dir": "",
    # opt-in runtime arm of the qlint plan-device checker: verify every
    # placed plan's device invariants before execution (analysis/
    # plan_device.py) and fail the statement on violation
    "tidb_qlint_verify": 0,
    # slow-query log threshold in MILLISECONDS (reference:
    # tidb_slow_log_threshold, default 300): statements whose exec wall
    # exceeds it emit a structured JSONL record (obs/slowlog.py)
    "tidb_slow_log_threshold": 300,
    # statement-summary window length in SECONDS: when the current
    # aggregation window of information_schema.statements_summary is
    # older, it rotates into bounded history (obs/stmtsummary.py)
    "tidb_stmt_summary_refresh_interval": 1800,
    # max distinct (sql digest, plan digest) keys per summary window;
    # beyond it the least-recently-seen record folds into the single
    # 'evicted' tombstone row
    "tidb_stmt_summary_max_stmt_count": 200,
    "sql_mode": "STRICT_TRANS_TABLES",
    # SELECT wall-clock budget in MILLISECONDS (0 = unlimited): checked
    # at every block boundary (utils/interrupt.py), surfaces MySQL 3024
    "max_execution_time": 0,
    # per-query chunk-allocation budget in BYTES (0 = unlimited): blown
    # quota aborts the statement with error 8175 (utils/memory.py)
    "tidb_mem_quota_query": 0,
    # memory-adaptive execution (ops/spill.py): crossing spill_ratio x
    # quota flips join/agg/sort/topn into partitioned spill mode instead
    # of dying at the quota (0 disables the soft watermark); partitions
    # 0 = auto fan-out from the planner's estRows; max_depth bounds the
    # recursive-repartition ladder before the typed 8175 last resort
    "tidb_mem_quota_spill_ratio": 0.8,
    "tidb_spill_partitions": 0,
    "tidb_spill_max_depth": 3,
    # failpoint arming spec (fail.configure): "name=error(msg);..." —
    # process-global, empty string disarms everything
    "tidb_failpoints": "",
    # ---- durability (kv/wal.py; active only on a data_dir store) ------
    # WAL fsync policy, applied to the live store at SET time:
    # 'strict' = fsync before acking every commit-class record,
    # 'relaxed' = group commit (one fsync per GROUP_COMMIT_S window;
    # a POWER loss can lose acks inside the open window, a SIGKILL
    # cannot), 'off' = never fsync the log (checkpoints still fsync)
    "tidb_wal_fsync": "relaxed",
    # GC retention in SECONDS: versions older than this are collectable
    # by the domain owner loop's safepoint trigger (storage.maybe_run_gc,
    # self-paced to one pass per half-retention).  0 = GC disabled —
    # mvcc.gc() is never invoked, today's unbounded-history behavior
    "tidb_gc_safepoint": 0,
    # stats-driven auto-prewarm (session/prewarm.py PrewarmWorker, wired
    # into the server lifecycle): a background worker ranks the top-K
    # (digest, bucket) families from statements_summary by exec count x
    # observed miss cost and AOT-compiles their programs off the query
    # path.  The worker reads the GLOBAL scope (SET GLOBAL) each cycle.
    "tidb_auto_prewarm": 1,
    "tidb_auto_prewarm_top_k": 8,
    # seconds between worker cycles (first cycle fires one interval
    # after server start, never at startup)
    "tidb_auto_prewarm_interval": 60,
    # per-cycle warming wall budget in MILLISECONDS (0 = unlimited):
    # once spent, remaining candidates wait for the next cycle
    "tidb_auto_prewarm_budget_ms": 60000,
    # seconds a warmed (or failed) family is exempt from re-warming
    "tidb_auto_prewarm_cooldown": 600,
    # ---- serving layer (server/pool.py + server/admission.py; the
    # GLOBAL scope is what the server reads — SET GLOBAL to tune) -------
    # accept-loop connection cap: further connects get MySQL 1040
    # "Too many connections" before the handshake (0 = unlimited)
    "tidb_max_server_connections": 0,
    # wire front end for NEW connections (server/server.py reads it per
    # accept): 'legacy' = thread-per-connection, 'aio' = the event-loop
    # front end (server/aio.py) parking idle connections as registered
    # file objects — the C10k path.  Flippable mid-server; established
    # connections keep the mode they were accepted under
    "tidb_wire_mode": "legacy",
    # event-loop thread count for the aio front end (>= 1; read once at
    # front-end start — the first aio-mode accept)
    "tidb_aio_loops": 1,
    # slowloris guard: a connection stalled mid-handshake or mid-frame
    # (partial packet buffered) longer than this is closed (0 = off).
    # Parked IDLE connections — no partial frame — never time out
    "tidb_aio_frame_timeout_ms": 10000,
    # statement-execution pool: worker-thread count for pooled
    # statements (SELECT/INSERT/DELETE over the wire; 0 = pooling off,
    # statements run on their connection thread unbounded)
    "tidb_stmt_pool_size": 4,
    # bounded admission queue in front of the pool; a full queue sheds
    # load with MySQL 1041 + retry hint (server/admission.py)
    "tidb_stmt_pool_queue_depth": 64,
    # aggregate in-flight statement memory (sum of running statements'
    # MemTracker bytes) above which admission sheds new statements
    # (0 = off)
    "tidb_admission_mem_limit": 0,
    # cross-query micro-batching (ops/batching.py): max same-digest
    # statements coalesced into one device round (<2 disables), and how
    # long a worker tops up a forming batch from the queue
    "tidb_batch_max_size": 16,
    "tidb_batch_window_ms": 2,
    # stacked-params batch execution: max parked members one
    # vmap-batched dispatch may carry (rounds stack on a leading batch
    # axis padded to a power-of-two occupancy bucket; 0/1 = legacy
    # back-to-back ParamTable replays)
    "tidb_batch_stack_max": 16,
    # ---- time-series metrics ring (obs/tsring.py; GLOBAL scope — the
    # server's background sampler re-reads both every tick) -------------
    # seconds between ring samples (0 pauses the sampler without
    # stopping it)
    "tidb_metrics_interval": 5,
    # seconds of sample history information_schema.metrics_history /
    # metrics_summary retain; shrinking it trims the ring immediately
    "tidb_metrics_retention": 900,
    # ---- device-time truth (ops/profiler.py + obs/inspect.py; both are
    # process-global module state applied at SET time, like
    # tidb_compile_cache_dir) --------------------------------------------
    # fraction of device dispatches the sampling profiler closes with
    # block_until_ready to record MEASURED device busy time (0 = off and
    # byte-identical; 1 = every dispatch — diagnosis, not steady state)
    "tidb_device_profile_rate": 0,
    # p99 latency objective in MILLISECONDS the slo-burn inspection rule
    # judges the exec-phase histogram against (0 = no SLO armed)
    "tidb_slo_p99_ms": 0,
    # ---- continuous host profiler (obs/conprof.py; GLOBAL scope — the
    # server's background stack sampler re-reads all four every tick) --
    # sampling rate in Hz (0 = off; the sampler's own overhead backoff
    # may stretch the effective period under load)
    "tidb_conprof_rate": 10,
    # seconds per aggregation window of
    # information_schema.continuous_profiling (stmtsummary-style
    # rotation into bounded history)
    "tidb_conprof_window": 60,
    # rotated windows retained
    "tidb_conprof_history": 15,
    # max distinct folded stacks per window; beyond it the
    # least-recently-seen stack folds into the '(evicted)' tombstone
    "tidb_conprof_max_stacks": 512,
    # ---- continuous heap profiler (obs/memprof.py; GLOBAL scope — the
    # server's background memory sampler re-reads all four every tick) --
    # sampling rate in Hz (0 = off AND tracemalloc stopped — tracing
    # taxes every allocation, so off must mean off; a tracemalloc
    # snapshot is far pricier than a stack walk, hence the low default)
    "tidb_memprof_rate": 1,
    # seconds per aggregation window of the /debug/heap site store
    "tidb_memprof_window": 60,
    # rotated windows retained
    "tidb_memprof_history": 15,
    # max distinct allocation sites per window; beyond it the
    # least-recently-seen site folds into the '(evicted)' tombstone
    "tidb_memprof_max_sites": 256,
    # ---- flight recorder (obs/flight.py; GLOBAL scope — the server's
    # background segment writer re-reads both every tick; inert without
    # a data dir) --------------------------------------------------------
    # seconds between durable flight segments (0 pauses the writer
    # without stopping it)
    "tidb_flight_interval": 10,
    # retention bound: newest N segments kept per incarnation (in-file
    # compaction) and newest N incarnation files kept in the flight dir
    "tidb_flight_retention": 8,
}


@dataclass
class ResultSet:
    columns: List[str]
    rows: List[list]
    fields: Optional[list] = None  # FieldType per column (wire protocol)

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)


class SessionError(Exception):
    """Statement-level error with an optional MySQL wire code (the
    server maps ``mysql_code``/``sqlstate`` into its ERR packet;
    1105 = generic server error)."""

    def __init__(self, msg: str, mysql_code: int = 1105,
                 sqlstate: str = "HY000"):
        super().__init__(msg)
        self.mysql_code = mysql_code
        self.sqlstate = sqlstate


SLOW_QUERY_THRESHOLD_MS = 300.0  # fallback when the sysvar is unset/bad


class Session:
    """reference: session/session.go session struct."""

    def __init__(self, storage, current_db: str = "", domain=None):
        """`domain`: a per-server schema cache (domain.Domain) with its
        own lease + owner manager; None = the storage's shared embedded
        domain (lease 0 — always fresh; reference: sessions hold a Domain
        via domainMap)."""
        self.storage = storage
        if domain is None:
            from ..domain import shared_domain
            domain = shared_domain(storage)
        self.domain = domain
        self.current_db = current_db
        # session scope initialized from defaults overlaid with globals
        # (reference: session.go loadCommonGlobalVariablesIfNeeded); the
        # global scope lives ON the storage object — id(storage) keys
        # collide when CPython reuses a freed address
        self.sysvars: Dict[str, Datum] = dict(DEFAULT_SYSVARS)
        self.sysvars.update(getattr(storage, "_global_vars", {}))
        self.uservars: Dict[str, Datum] = {}
        self._txn = None
        # the torch device the device tier runs on (new_session resolves
        # it; None = the current CUDA device, raising without one)
        self.device = None
        self._explicit_txn = False
        self._pinned_is: Optional[InfoSchema] = None
        self.ddl = domain.ddl()
        self.last_affected = 0
        # (Level, Code, Message) triples of the LAST statement
        # (reference: StatementContext warnings, SHOW WARNINGS/ERRORS)
        self.last_warnings: List[tuple] = []
        # per-statement phase timings (reference: session.go DurationParse
        # :590 / DurationCompile :612 + slow-query logging).  parse_s is
        # the per-BATCH parse wall (reported once); "statements" carries
        # the per-statement phase list
        self.last_query_info: Dict[str, float] = {}
        # the last statement's observability scope (obs/context.QueryObs):
        # per-query device counters, per-operator RuntimeStats, span trace
        self.last_query_stats = None
        # live-statement state surfaced by information_schema.processlist:
        # stmt_running flips inside _execute_stmt; _stmt_mem is the
        # always-installed per-statement MemTracker (quota 0 = track only)
        self.stmt_running = False
        self._stmt_mem = None
        # the thread ident the current statement EXECUTES on (pool
        # worker / conn thread / embedded caller) — the continuous
        # profiler's statement-attribution key (obs/conprof.py): a
        # stack sample landing on this thread while stmt_running is
        # the statement's on-thread time
        self.stmt_thread_ident = 0
        # statement-pool admission state (server/pool.py): "queued" while
        # waiting for a worker, with the pending SQL for processlist
        self.stmt_state = ""
        self.pending_sql = ""
        # serving-path wait attribution handoff: the pool measures this
        # statement's queue/batch wait + admission verdict and deposits
        # it here right before invoking execute_stmt on a worker; the
        # statement scope consumes (and clears) it in _execute_one
        self.pending_wait = None
        # rendered EXPLAIN rows of the last planned statement — the
        # EXPLAIN FOR CONNECTION <id> payload (set before execution so a
        # live statement's plan is readable from another session)
        self.last_plan_rows = None
        # wire identity (the server fills this in after auth; embedded
        # sessions have no user)
        self.user = ""
        # internal sessions (auto-prewarm worker) execute real statements
        # but stay OUT of the observability fan-out (_finish_obs)
        self.internal = False
        # statement interruption (utils/interrupt.py): a process-unique
        # connection id (the KILL target / server thread id) + the guard
        # any thread may flip to abort the running statement
        self.conn_id = interrupt.register_session(self)
        self.guard = interrupt.StatementGuard(self.conn_id)
        self.killed = False  # plain KILL: server drops the conn after
        #                      the current command

    def _globals(self) -> Dict[str, Datum]:
        g = getattr(self.storage, "_global_vars", None)
        if g is None:
            g = self.storage._global_vars = {}
        return g

    # ---- schema cache (reference: domain.Reload via the Domain) --------
    def infoschema(self) -> InfoSchema:
        """Pinned per STATEMENT: every read within one statement — and
        the commit-time validator anchor — sees the same InfoSchema
        object even if the domain's background ticker reloads mid-flight
        (otherwise a plan built at version V could commit under an
        anchor captured at V+1, silently skipping index maintenance)."""
        if self._pinned_is is None:
            self._pinned_is = self.domain.info_schema()
        return self._pinned_is

    # ---- variables ------------------------------------------------------
    def get_sysvar(self, name: str, scope: str = "") -> Datum:
        if scope == "global":
            return self._globals().get(name, DEFAULT_SYSVARS.get(name))
        return self.sysvars.get(name, self._globals().get(
            name, DEFAULT_SYSVARS.get(name)))

    def get_uservar(self, name: str) -> Datum:
        return self.uservars.get(name)

    # ---- txn lifecycle (reference: session/txn.go TxnState) ------------
    def get_txn(self):
        if self._txn is None:
            self._txn = self.storage.begin()
            # schema validity re-check before the commit point (reference:
            # domain/schema_validator.go Check via 2pc.go:633): a DDL that
            # landed mid-transaction would make buffered writes miss index
            # maintenance, so the commit must abort and retry instead
            # anchor on the schema version this session PLANS with (the
            # domain cache may legitimately lag the store under its
            # lease; a stale-planned txn must fail the commit check)
            start_ver = self.infoschema().version
            storage = self.storage

            def schema_check(commit_ts):
                txn = storage.begin()
                try:
                    now_ver = Meta(txn).schema_version()
                finally:
                    txn.rollback()
                if now_ver != start_ver:
                    raise RetryableError(
                        "Information schema is changed during the "
                        "execution of the statement (schema version "
                        f"{start_ver} -> {now_ver})")
            self._txn.schema_check = schema_check
        return self._txn

    def in_txn(self) -> bool:
        return self._explicit_txn

    def commit_txn(self) -> None:
        if self._txn is not None:
            txn, self._txn = self._txn, None
            self._explicit_txn = False
            txn.commit()
            # flush live row-count deltas (reference: stats collector ->
            # mysql.stats_meta at commit); post-commit, non-transactional
            if txn.stats_delta:
                from ..statistics.table_stats import update_count_delta
                for tid, d in txn.stats_delta.items():
                    update_count_delta(self.storage, tid, d)

    def rollback_txn(self) -> None:
        if self._txn is not None:
            self._txn.rollback()
            self._txn = None
        self._explicit_txn = False

    def _finish_stmt(self, ok: bool) -> None:
        """Autocommit boundary (reference: session/tidb.go finishStmt):
        with autocommit=0 the implicit transaction stays open across
        statements until COMMIT/ROLLBACK, exactly like BEGIN."""
        if self._explicit_txn or not bool(self.get_sysvar("autocommit")):
            return  # statement-level rollback handled via checkpoints
        if ok:
            self.commit_txn()
        else:
            self.rollback_txn()

    # ---- entry -----------------------------------------------------------
    def execute(self, sql: str) -> List[Optional[ResultSet]]:
        t0 = time.perf_counter()
        stmts = parse(sql)
        t_parse = time.perf_counter() - t0
        out = []
        stmt_infos: List[Dict[str, float]] = []
        try:
            for i, s in enumerate(stmts):
                label = sql if len(stmts) == 1 else \
                    f"{sql[:200]} [stmt {i + 1}/{len(stmts)}]"
                try:
                    out.append(self._execute_one(
                        s, label,
                        parse_wall=t_parse if i == 0 else 0.0,
                        parse_t0=t0 if i == 0 else None,
                        n_stmts=len(stmts)))
                finally:
                    q = self.last_query_stats
                    if q is not None and q.info:
                        stmt_infos.append(q.info)
        finally:
            if stmt_infos:
                # batch scope throughout, so the fields ADD UP: total =
                # parse + sum(exec); plan is inside exec.  Per-statement
                # phases live in the "statements" list
                self.last_query_info = {
                    "parse_s": t_parse,
                    "plan_s": sum(x["plan_s"] for x in stmt_infos),
                    "exec_s": sum(x["exec_s"] for x in stmt_infos),
                    "total_s": t_parse + sum(x["exec_s"]
                                             for x in stmt_infos),
                    "statements": stmt_infos,
                }
        return out

    def execute_stmt(self, stmt: ast.StmtNode,
                     sql_text: str = "") -> Optional[ResultSet]:
        """One pre-parsed statement under the FULL observability
        lifecycle (QueryObs scope, statement-summary ingest, slow log,
        trace ring) — the server's COM_QUERY / COM_STMT_EXECUTE entry,
        so wire connections are first-class obs citizens exactly like
        :meth:`execute` callers."""
        return self._execute_one(stmt, sql_text or type(stmt).__name__)

    def _execute_one(self, s: ast.StmtNode, label: str,
                     parse_wall: float = 0.0,
                     parse_t0: Optional[float] = None,
                     n_stmts: int = 1) -> Optional[ResultSet]:
        from ..obs import context as obs_context
        qobs = obs_context.QueryObs(sql=label)
        if parse_t0 is not None:
            # TRUE per-batch parse wall, reported ONCE — not amortized
            # into every statement and re-added to each total_s
            qobs.tracer.add_complete("parse", parse_t0, parse_wall,
                                     args={"statements": n_stmts})
        tok = obs_context.activate(qobs)
        self.last_query_stats = qobs
        t1 = time.perf_counter()
        # serving-path wait attribution: consume the pool's measurement
        # (one statement each — cleared so a later non-pooled statement
        # on this session can't inherit it).  Waits predate this scope,
        # so they enter the trace as already-measured complete spans
        # ending where execution begins.
        wait, self.pending_wait = self.pending_wait, None
        queue_s = float(wait.get("queue_wait_s", 0.0)) if wait else 0.0
        batch_s = float(wait.get("batch_wait_s", 0.0)) if wait else 0.0
        if wait:
            qobs.admission_verdict = wait.get("admission_verdict", "")
            if queue_s > 0:
                qobs.tracer.add_complete(
                    "queue_wait", t1 - queue_s - batch_s, queue_s,
                    cat="serving",
                    args={"verdict": qobs.admission_verdict})
            if batch_s > 0:
                qobs.tracer.add_complete("batch_wait", t1 - batch_s,
                                         batch_s, cat="serving")
        self._plan_s = 0.0
        err = True
        n_rows = 0
        parked = False
        try:
            from ..ops import kernels
            with obs_context.span("execute", kind=type(s).__name__), \
                    kernels.use_device(self.device):
                rs = self._execute_stmt(s)
            n_rows = len(rs.rows) if isinstance(rs, ResultSet) \
                else self.last_affected
            err = False
            return rs
        except Exception as e:
            # a batch-round collect leg parking at the dispatch boundary
            # (ops/batching.Parked) is control flow, not a statement: it
            # must stay invisible to statements_summary / slow log /
            # /metrics — the member's REPLAY execution reports instead
            from ..ops.batching import Parked
            parked = isinstance(e, Parked)
            raise
        finally:
            obs_context.deactivate(tok)
            t_exec = time.perf_counter() - t1
            info = {"parse_s": parse_wall,
                    "plan_s": self._plan_s,
                    "exec_s": t_exec,
                    "total_s": parse_wall + t_exec}
            if wait:
                # waits stay OUTSIDE total_s (they are not execution);
                # statements_summary / slow_query / the "queue" phase
                # histogram attribute them separately
                info["queue_s"] = queue_s
                info["batch_s"] = batch_s
            qobs.info = info
            if not parked:
                self._finish_obs(s, qobs, info, err, n_rows)

    def _finish_obs(self, stmt: ast.StmtNode, qobs, info: Dict[str, float],
                    err: bool, rows_returned: int = 0) -> None:
        """Post-statement observability fan-out: query metrics, the trace
        ring (/debug/trace), the structured slow-query log, the
        statement-summary store (THE designated stmtsummary write hook —
        qlint OB403), and the bucket-prewarm feedback file.  Never
        raises.  INTERNAL sessions (the auto-prewarm worker) skip the
        fan-out entirely: their warming executions must not inflate
        statements_summary (the worker ranks from it — feeding its own
        runs back in would self-amplify), the slow log, or /metrics."""
        if self.internal:
            return
        from ..obs import metrics as obs_metrics
        from ..obs import slowlog as obs_slowlog
        from ..obs import stmtsummary
        from ..obs.feedback import maybe_emit
        from ..obs.trace import publish_trace
        try:
            kind = type(stmt).__name__.replace("Stmt", "").lower()
            thr = SLOW_QUERY_THRESHOLD_MS
            try:
                thr = float(self.get_sysvar("tidb_slow_log_threshold"))
            except (TypeError, ValueError):
                pass
            total_ms = info["total_s"] * 1e3
            # classify on the statement's OWN exec wall: the batch parse
            # time rides statement 0's total_s for reporting, but must
            # not tip statement 0 over the slow threshold on behalf of
            # the whole batch
            slow = info["exec_s"] * 1e3 > thr
            obs_metrics.observe_query(kind, info["exec_s"], slow=slow,
                                      error=err)
            # spans only: Chrome trace events derive from them on demand
            # (session.last_trace, tools/trace2json.py) — storing both
            # would double ring memory and /debug/trace payloads.
            # Bookkeeping statements (SET/USE/txn control) stay out of
            # the bounded ring: bench-style clients interleave them with
            # every query and would evict the traces /debug/trace is for
            if not isinstance(stmt, (ast.SetStmt, ast.UseStmt,
                                     ast.BeginStmt, ast.CommitStmt,
                                     ast.RollbackStmt, ast.EmptyStmt)):
                publish_trace({
                    "sql": qobs.sql[:512], "ts": qobs.started_at,
                    "total_ms": round(total_ms, 3), "error": err,
                    "spans": qobs.tracer.spans(),
                })
            # digest/sample from the statement's OWN source slice: a
            # batch label ("... [stmt 2/3]") would fall back to raw-text
            # normalization and never share a digest with the
            # standalone form
            src = getattr(stmt, "src", "") or qobs.sql
            sql_digest = digest_text = ""
            if not isinstance(stmt, ast.EmptyStmt):
                sql_digest, digest_text = stmtsummary.normalize(src)
            if slow:
                obs_slowlog.log_slow(obs_slowlog.build_record(
                    src, info, qobs, conn_id=self.conn_id,
                    db=self.current_db, success=not err,
                    sql_digest=sql_digest))
            if not isinstance(stmt, ast.EmptyStmt):
                try:
                    interval = float(self.get_sysvar(
                        "tidb_stmt_summary_refresh_interval") or 0)
                except (TypeError, ValueError):
                    interval = stmtsummary.DEFAULT_REFRESH_INTERVAL_S
                try:
                    max_count = int(self.get_sysvar(
                        "tidb_stmt_summary_max_stmt_count") or 0)
                except (TypeError, ValueError):
                    max_count = stmtsummary.DEFAULT_MAX_STMT_COUNT
                # the summary's MEM column is the statement's high-water
                # mark: live-set release accounting (chunk free / spill)
                # makes `consumed` drop as buffers go away
                mem = self._stmt_mem.peak \
                    if self._stmt_mem is not None else 0
                stmtsummary.ingest(
                    sql=src, sql_digest=sql_digest,
                    digest_text=digest_text, stmt_type=kind,
                    schema_name=self.current_db,
                    plan_digest=qobs.plan_digest, info=info,
                    device=qobs.device_totals(),
                    rows_returned=rows_returned, error=err, max_mem=mem,
                    plan_rows=qobs.plan_rows,
                    queued=qobs.admission_verdict == "queued",
                    refresh_interval_s=interval,
                    max_stmt_count=max_count)
            if not err:
                maybe_emit(qobs)
                # cross-query micro-batching learns family eligibility
                # here: statements that executed a params-compiled fused
                # dispatch (the `batchable` marker) make their digest a
                # coalescing candidate for the statement pool
                if sql_digest and qobs.device_totals().get("batchable"):
                    from ..ops.batching import note_family
                    note_family(sql_digest)
        except Exception:
            logging.getLogger("tinysql_tpu").warning(
                "observability fan-out failed", exc_info=True)

    def query(self, sql: str) -> ResultSet:
        out = [r for r in self.execute(sql) if r is not None]
        if len(out) != 1:
            raise SessionError(f"expected one result set, got {len(out)}")
        return out[0]

    def _execute_stmt(self, stmt: ast.StmtNode) -> Optional[ResultSet]:
        # arm the interruption guard + memory quota for THIS statement.
        # Done here (not in execute()) because the server's query/prepared
        # paths enter per statement through this method directly.
        deadline = None
        if isinstance(stmt, ast.SelectStmt):
            # max_execution_time applies to SELECT (MySQL semantics);
            # value is validated at SET time, so a bad stored value is a
            # config bug — fall back to no deadline instead of failing
            try:
                met = int(self.get_sysvar("max_execution_time") or 0)
            except (TypeError, ValueError):
                met = 0
            if met > 0:
                deadline = time.monotonic() + met / 1000.0
        self.guard.begin(deadline)
        gtok = interrupt.activate(self.guard)
        try:
            quota = int(self.get_sysvar("tidb_mem_quota_query") or 0)
        except (TypeError, ValueError):
            quota = 0
        try:
            ratio = float(
                self.get_sysvar("tidb_mem_quota_spill_ratio") or 0)
        except (TypeError, ValueError):
            ratio = 0.0
        # the tracker is ALWAYS installed (quota 0 = track, never abort):
        # information_schema.processlist reports its live byte count and
        # statements_summary its per-statement high-water mark.  The
        # soft watermark (ratio x quota) is where spill-capable
        # operators flip into partitioned mode (ops/spill.py)
        wm = int(quota * ratio) if quota > 0 and 0 < ratio <= 1 else 0
        self._stmt_mem = memory.MemTracker(quota if quota > 0 else 0,
                                           spill_watermark=wm)
        mtok = memory.activate(self._stmt_mem)
        self.stmt_thread_ident = threading.get_ident()
        self.stmt_running = True
        try:
            return self._execute_stmt_guarded(stmt)
        finally:
            self.stmt_running = False
            memory.deactivate(mtok)
            interrupt.deactivate(gtok)

    def _execute_stmt_guarded(self, stmt: ast.StmtNode) \
            -> Optional[ResultSet]:
        # statement-level rollback inside an explicit txn (reference:
        # session/txn.go StmtRollback): a failed statement undoes only its
        # own buffered writes, the transaction stays open
        in_txn_scope = self._explicit_txn or not bool(
            self.get_sysvar("autocommit"))
        cp = self._txn.checkpoint() if (in_txn_scope and self._txn) else None
        self.last_affected = 0  # per-statement affected-rows counter
        self._pinned_is = None  # each statement pins a fresh InfoSchema
        if not isinstance(stmt, ast.ShowStmt):
            # statement-scoped warning sink (reference StatementContext
            # warnings); SHOW itself must not clear what it reports
            self.last_warnings = []
        try:
            rs = self._dispatch(stmt)
            self._finish_stmt(ok=True)
            return rs
        except Exception as e:
            from ..ops.batching import Parked
            if not isinstance(stmt, ast.ShowStmt) \
                    and not isinstance(e, Parked):
                # SHOW ERRORS reports the failed statement (reference:
                # fetchShowWarnings(errors=true)); typed errors carry
                # their MySQL code (kill 1317, timeout 3024, OOM 8175),
                # 1105 = generic server error.  A batch-round park is
                # control flow, not a failure — no phantom warning
                self.last_warnings.append(
                    ("Error", getattr(e, "mysql_code", 1105), str(e)))
            if cp is not None and self._txn is not None:
                self._txn.restore(cp)
            elif in_txn_scope and self._txn is not None:
                # the failed statement itself lazily created the implicit
                # txn (cp is None), so its partial writes are the txn's
                # ONLY writes — roll the txn back, else a later COMMIT
                # would persist them (statement atomicity)
                self.rollback_txn()
            else:
                self._finish_stmt(ok=False)
            raise

    # ---- dispatch (reference: planbuilder.go:243 Build switch) ----------
    def _dispatch(self, stmt: ast.StmtNode) -> Optional[ResultSet]:
        if isinstance(stmt, ast.SelectStmt):
            return self._exec_select(stmt)
        if isinstance(stmt, ast.InsertStmt):
            return self._exec_insert(stmt)
        if isinstance(stmt, ast.DeleteStmt):
            return self._exec_delete(stmt)
        if isinstance(stmt, ast.UpdateStmt):
            return self._exec_update(stmt)
        if isinstance(stmt, (ast.CreateDatabaseStmt, ast.DropDatabaseStmt,
                             ast.CreateTableStmt, ast.DropTableStmt,
                             ast.CreateIndexStmt, ast.DropIndexStmt,
                             ast.AlterTableStmt, ast.TruncateTableStmt)):
            return self._exec_ddl(stmt)
        if isinstance(stmt, ast.UseStmt):
            from ..catalog.memtables import DB_NAME as INFO_SCHEMA_DB
            if (stmt.db.lower() != INFO_SCHEMA_DB
                    and not self.infoschema().schema_exists(stmt.db)):
                raise SessionError(f"Unknown database '{stmt.db}'")
            self.current_db = stmt.db
            return None
        if isinstance(stmt, ast.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, ast.BeginStmt):
            self.commit_txn()
            self.get_txn()  # hooks the schema validator on the fresh txn
            self._explicit_txn = True
            return None
        if isinstance(stmt, ast.CommitStmt):
            self.commit_txn()
            return None
        if isinstance(stmt, ast.RollbackStmt):
            self.rollback_txn()
            return None
        if isinstance(stmt, ast.ShowStmt):
            return self._exec_show(stmt)
        if isinstance(stmt, ast.ExplainStmt):
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.TraceStmt):
            return self._exec_trace(stmt)
        if isinstance(stmt, ast.AnalyzeTableStmt):
            return self._exec_analyze(stmt)
        if isinstance(stmt, ast.AdminStmt):
            return self._exec_admin(stmt)
        if isinstance(stmt, ast.KillStmt):
            # KILL [QUERY] <id> (reference: executor/simple.go Kill +
            # server.Kill): resolves through the process-global session
            # registry, so embedded sessions and server connections are
            # both killable
            if not interrupt.kill(stmt.conn_id, stmt.query_only):
                raise SessionError(f"Unknown thread id: {stmt.conn_id}",
                                   mysql_code=1094)
            return None
        if isinstance(stmt, ast.EmptyStmt):
            return None
        raise SessionError(f"unsupported statement {type(stmt).__name__}")

    # ---- SELECT ---------------------------------------------------------
    def _use_tpu(self) -> bool:
        """The device switch.  A device error fails the statement: the
        port never re-runs it on the CPU tier behind the caller's back."""
        return bool(self.get_sysvar("tidb_use_tpu"))

    def _exec_select(self, stmt: ast.SelectStmt) -> ResultSet:
        from ..obs import context as obs_context
        qobs = obs_context.current()
        t0 = time.perf_counter()
        builder = PlanBuilder(self)
        with obs_context.span("plan"):
            logical = builder.build_select(stmt)
        columns = [c.name for c in logical.schema.columns]
        use_tpu = self._use_tpu()
        with obs_context.span("place", tpu=use_tpu):
            phys = self._optimize(logical, use_tpu)
        t_plan = time.perf_counter() - t0
        from ..planner.explain import explain_text, plan_digest
        # published BEFORE execution: a concurrently-running statement's
        # plan is readable via EXPLAIN FOR CONNECTION <id> / processlist
        self.last_plan_rows = explain_text(phys)
        if qobs is not None:
            qobs.plan_digest = plan_digest(phys)
            qobs.plan_rows = self.last_plan_rows
        rows = self._run_phys(phys, use_tpu, qobs)
        # compile/plan vs run split surfaces in last_query_info (the
        # reference's DurationCompile analogue; exec_s wraps both)
        self._plan_s = t_plan
        return ResultSet(columns, rows,
                         [c.ret_type for c in logical.schema.columns])

    def _run_phys(self, phys, use_tpu: bool, qobs) -> List[list]:
        from ..obs.runtime_stats import instrument_tree
        ex = build_executor(phys, use_tpu=use_tpu)
        instrument_tree(ex, qobs)
        ex.open(ExecContext(self.get_txn(), self.sysvars,
                            self.infoschema(), self.storage))
        try:
            return ex.drain()
        finally:
            ex.close()

    def select_metadata(self, stmt) -> Optional[tuple]:
        """(column names, FieldTypes) of a SELECT WITHOUT executing it —
        COM_STMT_PREPARE result metadata (reference: prepare-time column
        info in the writeResultset protocol contract).  Builds the
        logical plan only and clears its own InfoSchema pin (a prepare
        must not leave later statements planning against a stale
        catalog)."""
        if not isinstance(stmt, ast.SelectStmt):
            return None
        try:
            builder = PlanBuilder(self)
            logical = builder.build_select(stmt)
            return ([c.name for c in logical.schema.columns],
                    [c.ret_type for c in logical.schema.columns])
        finally:
            self._pinned_is = None

    def _optimize(self, logical, use_tpu: bool):
        """Route between the two optimizer frameworks (reference:
        planner/optimize.go:29-56 EnableCascadesPlanner switch)."""
        min_rows = float(self.get_sysvar("tidb_tpu_min_rows") or 0)
        shards = 0
        if use_tpu and bool(self.get_sysvar("tidb_mesh_parallel")):
            # the reference sized its device mesh here; the port has no
            # mesh tier yet
            raise NotImplementedError(
                "the multi-device mesh tier (tidb_mesh_parallel) is not "
                "ported yet: ROADMAP queue 1, item 10")
        verify = bool(self.get_sysvar("tidb_qlint_verify"))
        if bool(self.get_sysvar("tidb_enable_cascades_planner")):
            from ..planner.cascades import find_best_plan
            phys = find_best_plan(logical, tpu=use_tpu,
                                  tpu_min_rows=min_rows,
                                  mesh_shards=shards)
            if verify:
                from ..analysis.plan_device import verify_plan
                verify_plan(phys)
            return phys
        return optimize(logical, tpu=use_tpu, tpu_min_rows=min_rows,
                        mesh_shards=shards, verify=verify)

    def _run_select_plan(self, stmt: ast.SelectStmt, txn) -> List[list]:
        builder = PlanBuilder(self)
        use_tpu = self._use_tpu()
        phys = self._optimize(builder.build_select(stmt), use_tpu)
        ex = build_executor(phys, use_tpu=use_tpu)
        ex.open(ExecContext(txn, self.sysvars, self.infoschema(),
                            self.storage))
        try:
            return ex.drain()
        finally:
            ex.close()

    def eval_const_expr(self, e: ast.ExprNode) -> Datum:
        rw = ExprRewriter(Schema([]), PlanBuilder(self))
        return rw.rewrite(e).eval([])

    # ---- INSERT / DELETE -------------------------------------------------
    def _exec_insert(self, stmt: ast.InsertStmt) -> None:
        db = stmt.table.db or self.current_db
        if not db:
            raise SessionError("No database selected")
        info = self.infoschema().table_by_name(db, stmt.table.name)
        self._ensure_writable(info)
        ex = InsertExec(self, stmt, info, db)
        self.last_affected = ex.execute(self.get_txn())
        return None

    def _ensure_writable(self, info) -> None:
        """Bulk-loaded tables exist only as a columnar replica; the
        first write statement must materialize the row store first or
        its commit invalidates the replica and drops every untouched
        row (columnar/store.py ensure_row_store)."""
        if self.storage is not None:
            from ..columnar.store import ensure_row_store
            ensure_row_store(self.storage, info)

    def _exec_delete(self, stmt: ast.DeleteStmt) -> None:
        builder = PlanBuilder(self)
        src = stmt.table
        ds = builder._build_table_source(src)
        info = ds.table_info
        self._ensure_writable(info)
        handle_col = ExprColumn(new_int_type(), name=HANDLE_COL_NAME,
                                table=ds.alias)
        ds.schema = Schema(ds.schema.columns + [handle_col])
        plan = self._where_plan(builder, ds, stmt.where)
        use_tpu = self._use_tpu()
        phys = self._optimize(plan, use_tpu)
        txn = self.get_txn()
        ex = build_executor(phys, use_tpu=use_tpu)
        ex.open(ExecContext(txn, self.sysvars, self.infoschema(),
                            self.storage))
        try:
            rows = ex.drain()
        finally:
            ex.close()
        dex = DeleteExec(self, info)
        self.last_affected = dex.execute(txn, rows)
        return None

    @staticmethod
    def _where_plan(builder, ds, where):
        """DML read plan for a WHERE over one table — the same
        decorrelation the SELECT front door runs (IN/EXISTS subquery
        conjuncts -> semi/anti joins; the join mirrors the scan schema,
        hidden handle included, so the write executors see full rows)."""
        if where is None:
            return ds
        from ..planner.decorrelate import apply_where_subqueries
        plan, residual = apply_where_subqueries(builder, ds, where)
        rw = ExprRewriter(plan.schema, builder)
        conds = []
        for conj in residual:
            conds.extend(split_cnf(rw.rewrite(conj)))
        if conds:
            plan = LogicalSelection(conds, plan)
        return plan

    def _exec_update(self, stmt: ast.UpdateStmt) -> None:
        """UPDATE t SET c = expr [...] WHERE ... — scan qualifying rows
        (same planned read path as DELETE, hidden handle included), then
        read-modify-write through the row store so the 2PC
        prewrite/commit machinery (and its failpoints/chaos matrix)
        covers the statement unchanged."""
        from ..executor.write import UpdateExec
        builder = PlanBuilder(self)
        ds = builder._build_table_source(stmt.table)
        info = ds.table_info
        self._ensure_writable(info)
        handle_col = ExprColumn(new_int_type(), name=HANDLE_COL_NAME,
                                table=ds.alias)
        ds.schema = Schema(ds.schema.columns + [handle_col])
        scan_schema = ds.schema
        plan = self._where_plan(builder, ds, stmt.where)
        # bind SET targets/expressions against the scan schema BEFORE
        # optimization prunes it (rows arrive in full-schema order)
        rw = ExprRewriter(scan_schema, builder)
        assigns = []
        cols_by_name = {c.name.lower(): c for c in info.public_columns()}
        # the only legal SET-target qualifier is the table's visible
        # name in this statement (the alias when one is set — MySQL
        # rejects the base name once aliased)
        visible = (stmt.table.as_name or stmt.table.source.name).lower()
        for a in stmt.assignments:
            q = (a.column.table or "").lower()
            ci = cols_by_name.get(a.column.name.lower())
            if ci is None or (q and q != visible):
                bad = f"{q}.{a.column.name}" if q else a.column.name
                raise SessionError(
                    f"Unknown column '{bad}' in 'field list'")
            expr = rw.rewrite(a.expr).resolve_indices(scan_schema)
            assigns.append((ci, expr))
        use_tpu = self._use_tpu()
        phys = self._optimize(plan, use_tpu)
        txn = self.get_txn()
        ex = build_executor(phys, use_tpu=use_tpu)
        ex.open(ExecContext(txn, self.sysvars, self.infoschema(),
                            self.storage))
        try:
            rows = ex.drain()
        finally:
            ex.close()
        uex = UpdateExec(self, info, assigns)
        self.last_affected = uex.execute(txn, rows)
        return None

    def add_warning(self, level: str, code: int, msg: str) -> None:
        self.last_warnings.append((level, code, msg))

    # ---- DDL (implicit commit, reference: session commits before DDL) ---
    def _exec_ddl(self, stmt) -> None:
        self.commit_txn()
        d = self.ddl
        # IF [NOT] EXISTS Notes ride the DDL layer's AUTHORITATIVE
        # existence checks (the ops return True on a no-op), recorded
        # only AFTER the op succeeded — a failing statement must not
        # leave success-path warnings behind
        if isinstance(stmt, ast.CreateDatabaseStmt):
            if d.create_database(stmt.name, stmt.if_not_exists):
                self.add_warning("Note", 1007,
                                 f"Can't create database '{stmt.name}'; "
                                 "database exists")
        elif isinstance(stmt, ast.DropDatabaseStmt):
            if d.drop_database(stmt.name, stmt.if_exists):
                self.add_warning("Note", 1008,
                                 f"Can't drop database '{stmt.name}'; "
                                 "database doesn't exist")
            if self.current_db.lower() == stmt.name.lower():
                self.current_db = ""
        elif isinstance(stmt, ast.CreateTableStmt):
            db = stmt.table.db or self.current_db
            if not db:
                raise SessionError("No database selected")
            if d.create_table(db, stmt):
                self.add_warning("Note", 1050,
                                 f"Table '{stmt.table.name}' already "
                                 "exists")
        elif isinstance(stmt, ast.DropTableStmt):
            for tn in stmt.tables:
                db = tn.db or self.current_db
                if d.drop_table(db, tn.name, stmt.if_exists):
                    self.add_warning("Note", 1051,
                                     f"Unknown table '{db}.{tn.name}'")
        elif isinstance(stmt, ast.CreateIndexStmt):
            d.add_index(stmt.table.db or self.current_db, stmt.table.name,
                        stmt.index_name, stmt.columns, stmt.unique)
        elif isinstance(stmt, ast.DropIndexStmt):
            d.drop_index(stmt.table.db or self.current_db, stmt.table.name,
                         stmt.index_name)
        elif isinstance(stmt, ast.TruncateTableStmt):
            d.truncate_table(stmt.table.db or self.current_db,
                             stmt.table.name)
        elif isinstance(stmt, ast.AlterTableStmt):
            db = stmt.table.db or self.current_db
            for spec in stmt.specs:
                if spec.tp == "add_column":
                    d.add_column(db, stmt.table.name, spec.column)
                elif spec.tp == "drop_column":
                    d.drop_column(db, stmt.table.name, spec.name)
                elif spec.tp == "add_index":
                    cons = spec.constraint
                    d.add_index(db, stmt.table.name, cons.name,
                                list(cons.columns), cons.tp == "unique")
                elif spec.tp == "drop_index":
                    d.drop_index(db, stmt.table.name, spec.name)
        self._pinned_is = None  # next statement re-pins post-DDL schema
        self.domain.reload()
        return None

    # ---- SET -------------------------------------------------------------
    #: sysvars that must be non-negative integers, validated AT SET TIME
    #: (reference: variable sysvar type validation; a bad value must fail
    #: the SET, not silently disable the feature at read time)
    _UINT_SYSVARS = ("max_execution_time", "tidb_mem_quota_query",
                     "tidb_stmt_summary_refresh_interval",
                     "tidb_stmt_summary_max_stmt_count",
                     "tidb_auto_prewarm_top_k",
                     "tidb_auto_prewarm_interval",
                     "tidb_auto_prewarm_budget_ms",
                     "tidb_auto_prewarm_cooldown",
                     "tidb_max_server_connections",
                     "tidb_aio_loops",
                     "tidb_aio_frame_timeout_ms",
                     "tidb_stmt_pool_size",
                     "tidb_stmt_pool_queue_depth",
                     "tidb_admission_mem_limit",
                     "tidb_batch_max_size",
                     "tidb_batch_window_ms",
                     "tidb_batch_stack_max",
                     "tidb_metrics_interval",
                     "tidb_metrics_retention",
                     "tidb_spill_partitions",
                     "tidb_spill_max_depth",
                     "tidb_slo_p99_ms",
                     "tidb_conprof_rate",
                     "tidb_conprof_window",
                     "tidb_conprof_history",
                     "tidb_conprof_max_stacks",
                     "tidb_memprof_rate",
                     "tidb_memprof_window",
                     "tidb_memprof_history",
                     "tidb_memprof_max_sites",
                     "tidb_flight_interval",
                     "tidb_flight_retention")

    @staticmethod
    def _validate_uint_sysvar(name: str, v: Datum) -> int:
        if isinstance(v, bool) or isinstance(v, float):
            # 1232: Incorrect argument type (floats are not valid here)
            raise SessionError(
                f"Incorrect argument type to variable '{name}'",
                mysql_code=1232, sqlstate="42000")
        if isinstance(v, str):
            try:
                v = int(v.strip())
            except ValueError:
                raise SessionError(
                    f"Incorrect argument type to variable '{name}'",
                    mysql_code=1232, sqlstate="42000")
        if not isinstance(v, int):
            raise SessionError(
                f"Incorrect argument type to variable '{name}'",
                mysql_code=1232, sqlstate="42000")
        if v < 0:
            raise SessionError(
                f"Variable '{name}' can't be set to the value of '{v}'",
                mysql_code=1231, sqlstate="42000")
        return v

    def _exec_set(self, stmt: ast.SetStmt) -> None:
        for scope, name, expr in stmt.assignments:
            v = self.eval_const_expr(expr)
            if scope == "user":
                self.uservars[name] = v
                continue
            if name in self._UINT_SYSVARS:
                v = self._validate_uint_sysvar(name, v)
            if name in ("tidb_mem_quota_spill_ratio",
                        "tidb_device_profile_rate"):
                # fractions validated to [0, 1] at SET time (spill
                # ratio: 0 disables the soft watermark; profile rate:
                # 0 disables dispatch sampling entirely)
                try:
                    fv = float(v if not isinstance(v, bool) else "x")
                except (TypeError, ValueError):
                    raise SessionError(
                        f"Incorrect argument type to variable '{name}'",
                        mysql_code=1232, sqlstate="42000")
                if not 0.0 <= fv <= 1.0:
                    raise SessionError(
                        f"Variable '{name}' can't be set to the value "
                        f"of '{v}'", mysql_code=1231, sqlstate="42000")
                v = fv
            if name == "tidb_wire_mode":
                # enum validated at SET time (reference: sysvar type
                # validation): the accept loop reads this per connection
                # and must never see a junk mode
                mv = str(v).strip().lower() if v is not None else ""
                if mv not in ("legacy", "aio"):
                    raise SessionError(
                        f"Variable 'tidb_wire_mode' can't be set to the "
                        f"value of '{v}'", mysql_code=1231,
                        sqlstate="42000")
                v = mv
            if name == "tidb_wal_fsync":
                # enum validated at SET time, applied to the live WAL
                # immediately (no-op on a volatile store): the fsync
                # policy is a store property, not a per-session one
                pv = str(v).strip().lower() if v is not None else ""
                if pv not in ("off", "relaxed", "strict"):
                    raise SessionError(
                        f"Variable 'tidb_wal_fsync' can't be set to the "
                        f"value of '{v}'", mysql_code=1231,
                        sqlstate="42000")
                v = pv
            if name == "tidb_gc_safepoint":
                # retention seconds, numeric >= 0 (0 disables GC)
                try:
                    gv = float(v if not isinstance(v, bool) else "x")
                except (TypeError, ValueError):
                    raise SessionError(
                        f"Incorrect argument type to variable '{name}'",
                        mysql_code=1232, sqlstate="42000")
                if gv < 0:
                    raise SessionError(
                        f"Variable '{name}' can't be set to the value "
                        f"of '{v}'", mysql_code=1231, sqlstate="42000")
                v = gv
            if name == "tidb_failpoints":
                # validate + apply atomically BEFORE storing: a bad spec
                # must fail the SET and leave the armed set unchanged
                from .. import fail
                try:
                    fail.configure(str(v) if v else "")
                except ValueError as e:
                    raise SessionError(str(e), mysql_code=1231,
                                       sqlstate="42000")
            if scope == "global":
                self._globals()[name] = v
            else:
                self.sysvars[name] = v
            if name == "tidb_compile_cache_dir":
                # no meaning under torch: kernels.set_compile_cache_dir
                # accepts and ignores it (see DEFAULT_SYSVARS)
                from ..ops import kernels
                kernels.set_compile_cache_dir(str(v) if v else "")
            elif name == "tidb_device_profile_rate":
                # the dispatch path is process-global: apply immediately
                # (ops/profiler.py owns the sampling decision)
                from ..ops import profiler
                profiler.set_rate(float(v))
            elif name == "tidb_slo_p99_ms":
                # arm the slo-burn inspection rule + the `slo` ring
                # source (obs/inspect.py owns the objective state)
                from ..obs import inspect as obs_inspect
                obs_inspect.set_slo_p99_ms(float(v))
            elif name == "tidb_wal_fsync":
                wal = getattr(getattr(self.storage, "mvcc", None),
                              "wal", None)
                if wal is not None:
                    wal.set_fsync_policy(str(v))
        return None

    # ---- SHOW (reference: executor/show.go) ------------------------------
    def _exec_show(self, stmt: ast.ShowStmt) -> ResultSet:
        from ..expression import like_to_regex
        pat = like_to_regex(stmt.pattern) if stmt.pattern else None
        isc = self.infoschema()
        if stmt.tp == "databases":
            names = sorted(d.name for d in isc.all_schemas())
            rows = [[n] for n in names if pat is None or pat.match(n)]
            return ResultSet(["Database"], rows)
        if stmt.tp == "tables":
            db = stmt.db or self.current_db
            if not db:
                raise SessionError("No database selected")
            names = sorted(t.name for t in isc.schema_tables(db)
                           if t.state == SchemaState.PUBLIC)
            rows = [[n] for n in names if pat is None or pat.match(n)]
            return ResultSet([f"Tables_in_{db}"], rows)
        if stmt.tp == "columns":
            db = stmt.table.db or stmt.db or self.current_db
            t = isc.table_by_name(db, stmt.table.name)
            rows = []
            for c in t.public_columns():
                tp = c.ft.type_name()
                if c.ft.flen >= 0 and tp in ("varchar", "char"):
                    tp = f"{tp}({c.ft.flen})"
                null = "NO" if c.ft.not_null else "YES"
                key = ("PRI" if c.ft.flag & 0x2 else
                       ("UNI" if c.ft.flag & 0x4 else ""))
                rows.append([c.name, tp, null, key,
                             to_string(c.default), ""])
            return ResultSet(["Field", "Type", "Null", "Key", "Default",
                              "Extra"], rows)
        if stmt.tp == "create_table":
            db = stmt.table.db or self.current_db
            t = isc.table_by_name(db, stmt.table.name)
            return ResultSet(["Table", "Create Table"],
                             [[t.name, _show_create_table(t)]])
        if stmt.tp == "indexes":
            db = stmt.table.db or self.current_db
            t = isc.table_by_name(db, stmt.table.name)
            rows = []
            for idx in t.public_indices():
                for seq, ic in enumerate(idx.columns):
                    rows.append([t.name, 0 if idx.unique else 1, idx.name,
                                 seq + 1, ic.name])
            return ResultSet(["Table", "Non_unique", "Key_name",
                              "Seq_in_index", "Column_name"], rows)
        if stmt.tp == "variables":
            merged = dict(DEFAULT_SYSVARS)
            merged.update(self._globals())
            if not stmt.global_scope:
                merged.update(self.sysvars)
            rows = [[k, to_string(v)] for k, v in sorted(merged.items())
                    if pat is None or pat.match(k)]
            return ResultSet(["Variable_name", "Value"], rows)
        if stmt.tp == "create_database":
            from ..catalog.infoschema import DatabaseNotExist
            d = isc.schema_by_name(stmt.db)
            if d is None:
                raise DatabaseNotExist(stmt.db)
            return ResultSet(
                ["Database", "Create Database"],
                [[d.name, f"CREATE DATABASE `{d.name}` /*!40100 DEFAULT "
                          "CHARACTER SET utf8mb4 */"]])
        if stmt.tp == "processlist":
            # SHOW [FULL] PROCESSLIST (reference: executor/show.go
            # fetchShowProcessList) — same feed as the
            # information_schema.processlist mem-table
            from ..catalog.memtables import memtable_rows
            rows = []
            for (cid, user, db, cmd, time_ms, state, mem,
                 info, _digest) in memtable_rows(isc, "processlist"):
                info_out = info if stmt.full else info[:100]
                rows.append([cid, user, "", db, cmd, time_ms // 1000,
                             state, info_out, mem])
            return ResultSet(["Id", "User", "Host", "db", "Command",
                              "Time", "State", "Info", "Mem"], rows)
        if stmt.tp in ("warnings", "errors"):
            rows = [[lv, cd, msg] for lv, cd, msg in self.last_warnings
                    if stmt.tp == "warnings" or lv == "Error"]
            return ResultSet(["Level", "Code", "Message"], rows)
        raise SessionError(f"unsupported SHOW {stmt.tp}")

    # ---- EXPLAIN ---------------------------------------------------------
    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        if stmt.for_conn is not None:
            # EXPLAIN FOR CONNECTION <id> (reference: common_plans.go
            # ExplainFor): render the target session's last placed plan
            # through the process-global registry — works for live
            # statements (the plan publishes before execution) and for
            # idle connections (their most recent plan)
            target = interrupt.lookup(stmt.for_conn)
            if target is None:
                raise SessionError(
                    f"Unknown thread id: {stmt.for_conn}",
                    mysql_code=1094)
            rows = getattr(target, "last_plan_rows", None)
            if not rows:
                raise SessionError(
                    f"connection {stmt.for_conn} has no recorded plan "
                    "(no SELECT/EXPLAIN executed yet)")
            return ResultSet(["id", "estRows", "task", "operator info"],
                             [list(r) for r in rows])
        if not isinstance(stmt.stmt, ast.SelectStmt):
            raise SessionError("EXPLAIN supports SELECT only for now")
        from ..obs import context as obs_context
        builder = PlanBuilder(self)
        use_tpu = self._use_tpu()
        with obs_context.span("plan"):
            logical = builder.build_select(stmt.stmt)
        with obs_context.span("place", tpu=use_tpu):
            phys = self._optimize(logical, use_tpu)
        if stmt.analyze:
            # EXPLAIN ANALYZE (reference: explain.go with RuntimeStats):
            # run the statement under the active obs scope, then render
            # the plan annotated with actRows / wall time / device
            # counters next to the estimates
            from ..obs.runtime_stats import instrument_tree
            from ..planner.explain import (EXPLAIN_ANALYZE_COLUMNS,
                                           explain_analyze_text,
                                           explain_text, plan_digest)
            self.last_plan_rows = explain_text(phys)
            qobs = obs_context.current()
            if qobs is not None:
                qobs.plan_digest = plan_digest(phys)
                qobs.plan_rows = self.last_plan_rows
            ex = build_executor(phys, use_tpu=use_tpu)
            instrument_tree(ex, qobs)
            ex.open(ExecContext(self.get_txn(), self.sysvars,
                                self.infoschema(), self.storage))
            try:
                ex.drain()
            finally:
                ex.close()
            return ResultSet(list(EXPLAIN_ANALYZE_COLUMNS),
                             explain_analyze_text(phys, qobs))
        from ..planner.explain import explain_text
        rows = explain_text(phys)
        self.last_plan_rows = rows
        return ResultSet(["id", "estRows", "task", "operator info"], rows)

    # ---- TRACE (reference: executor/trace.go) ---------------------------
    def _exec_trace(self, stmt: ast.TraceStmt) -> ResultSet:
        """TRACE <stmt>: execute the statement FOR REAL inside the
        current observability scope (the span tracer obs/trace.py was
        already recording everything a render needs), then return the
        span tree as rows — span (depth-indented), parent, start offset
        + duration in µs, and the recording thread's serving role.  The
        traced statement's own resultset is discarded (the trace IS the
        result, TiDB semantics); its side effects are not."""
        from ..obs import context as obs_context
        from ..obs.trace import TRACE_COLUMNS, trace_rows
        if stmt.stmt is None or isinstance(stmt.stmt, ast.TraceStmt):
            raise SessionError("TRACE expects a statement")
        qobs = obs_context.current()
        before = len(qobs.tracer.spans()) if qobs is not None else 0
        # the traced statement gets its own execute span (the outer
        # TRACE's wrapper span is still open at render time, so this is
        # what roots the rendered tree)
        with obs_context.span("execute", kind=type(stmt.stmt).__name__):
            self._dispatch(stmt.stmt)
        if qobs is None:
            return ResultSet(list(TRACE_COLUMNS), [])
        # only the spans the traced statement recorded: a batch's
        # earlier statements (or the pool's wait spans) stay out
        return ResultSet(list(TRACE_COLUMNS),
                         trace_rows(qobs.tracer.spans()[before:]))

    @property
    def last_trace(self):
        """Chrome trace-event JSON of the last statement (load in
        chrome://tracing / Perfetto; tools/trace2json.py exports the
        ring)."""
        q = self.last_query_stats
        return q.tracer.chrome_trace(label=q.sql[:200]) \
            if q is not None else None

    # ---- ANALYZE (stats phase wires this up) ----------------------------
    def _exec_analyze(self, stmt: ast.AnalyzeTableStmt) -> None:
        from ..statistics.analyze import analyze_table
        for tn in stmt.tables:
            db = tn.db or self.current_db
            info = self.infoschema().table_by_name(db, tn.name)
            analyze_table(self, info)
        return None

    # ---- ADMIN -----------------------------------------------------------
    def _exec_admin(self, stmt: ast.AdminStmt) -> ResultSet:
        txn = self.storage.begin()
        m = Meta(txn)
        if stmt.tp in ("show_ddl", "show_ddl_jobs"):
            jobs = m.history_jobs()[-20:]
            queued = m._load_queue()
            txn.rollback()
            rows = []
            for j in reversed(queued):
                rows.append([j.id, j.tp.name, j.schema_id, j.table_id,
                             j.state.name, j.row_count, j.error or ""])
            for j in reversed(jobs):
                rows.append([j.id, j.tp.name, j.schema_id, j.table_id,
                             j.state.name, j.row_count, j.error or ""])
            return ResultSet(["JOB_ID", "TYPE", "SCHEMA_ID", "TABLE_ID",
                              "STATE", "ROW_COUNT", "ERROR"], rows)
        if stmt.tp == "check_table":
            txn.rollback()
            from ..executor.admin import check_table
            for tn in stmt.tables:
                db = tn.db or self.current_db
                info = self.infoschema().table_by_name(db, tn.name)
                check_table(self.storage, info)
            return ResultSet(["Result"], [["OK"]])
        txn.rollback()
        raise SessionError(f"unsupported ADMIN {stmt.tp}")


def _show_create_table(t: TableInfo) -> str:
    parts = []
    for c in t.public_columns():
        tp = c.ft.type_name()
        if c.ft.flen >= 0 and tp in ("varchar", "char"):
            tp = f"{tp}({c.ft.flen})"
        s = f"  `{c.name}` {tp}"
        if c.ft.is_unsigned:
            s += " unsigned"
        if c.ft.not_null:
            s += " NOT NULL"
        if c.default is not None:
            s += f" DEFAULT '{c.default}'"
        if c.ft.flag & 0x200:
            s += " AUTO_INCREMENT"
        parts.append(s)
    pk = t.get_pk_handle_col()
    if pk is not None:
        parts.append(f"  PRIMARY KEY (`{pk.name}`)")
    for idx in t.public_indices():
        cols = ", ".join(f"`{ic.name}`" for ic in idx.columns)
        if idx.primary:
            parts.append(f"  PRIMARY KEY ({cols})")
        elif idx.unique:
            parts.append(f"  UNIQUE KEY `{idx.name}` ({cols})")
        else:
            parts.append(f"  KEY `{idx.name}` ({cols})")
    body = ",\n".join(parts)
    return f"CREATE TABLE `{t.name}` (\n{body}\n)"


def new_session(storage=None, db: str = "", device=None) -> Session:
    """Bootstrap entry (reference: session.BootstrapSession +
    CreateSession).  ``device`` is where the device tier runs: None means
    the current CUDA device and raises ``RuntimeError`` when CUDA is
    absent (never a silent drop to the CPU); tests pass ``"cpu"``."""
    from ..ops import kernels
    dev = kernels.resolve_device(device)
    if storage is None:
        storage = new_mock_storage()
    sess = Session(storage, db)
    sess.device = dev
    return sess

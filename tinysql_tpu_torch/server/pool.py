"""Bounded statement-execution pool + same-digest coalescer.

Replaces the wire server's unbounded run-on-the-connection-thread model
for heavy statements: SELECT / INSERT / DELETE submitted by connection
threads execute on at most ``tidb_stmt_pool_size`` worker threads, with
a bounded queue in front (``tidb_stmt_pool_queue_depth``) guarded by
``server/admission.py``.  Everything else (SET, SHOW, KILL, BEGIN /
COMMIT, USE, EXPLAIN, DDL, ...) keeps executing directly on the
connection thread — deliberately, so KILL and introspection always work
even when every worker is wedged (the ``admissionDelay`` chaos drill).

Queued statements are first-class citizens: ``processlist`` shows them
with state ``queued`` (session.stmt_state, TIME = wait-so-far), KILL
while queued cancels without ever occupying a worker, and a plain KILL
/ server shutdown wakes the waiting connection thread with a typed
error.

Wait attribution: the pool measures each entry's queue wait (submit →
worker claim) and batch wait (claim → the leg that produced its
result), feeds the pool-side sum to ``server/admission.py``
(``queue_wait_s_sum`` → /metrics + the time-series ring), and deposits
the per-statement measurement on the session (``pending_wait``) right
before invoking it — the statement scope turns it into ``queue_wait``
/ ``batch_wait`` trace spans, ``statements_summary`` columns, and
``slow_query`` fields.  Workers run each statement inside a
``contextvars`` copy of the submitting thread's context, so the span
chain parents across the thread hop (the devpipe idiom).

Coalescing: when a worker dequeues a SELECT whose normalized-SQL digest
belongs to a learned batchable family (ops/batching.py — statements
that executed a params-compiled fused dispatch), it pulls every
same-digest statement already waiting (up to ``tidb_batch_max_size``,
topping up within ``tidb_batch_window_ms``) and drives the group
through one batch round: collect (park each member's ParamTable at the
warm program boundary), dispatch (stacked — all ParamTables on a
leading batch axis through ONE vmap-batched program when
``tidb_batch_stack_max`` >= 2 and the layouts agree; back-to-back
through the solo program otherwise), replay (each member consumes its
precomputed output and finishes normally).  Members that never reach a
batchable dispatch complete solo during collect — fallback is
transparent.
"""
from __future__ import annotations

import contextvars
import logging
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

from . import admission
from .. import fail
from ..parser import ast
from ..utils.interrupt import QueryKilled

log = logging.getLogger("tinysql_tpu.pool")

#: live pools (weak — a pool dies with its Server); /metrics sums their
#: queued/running gauges so the queued-vs-running split is scrapeable.
#: Guarded (qlint CC7xx triage): the sampler thread snapshots the set
#: while servers register pools (and GC discards dead ones) on other
#: threads — iterating a WeakSet under concurrent mutation raises
#: RuntimeError out of the /metrics scrape
_POOLS: "weakref.WeakSet" = weakref.WeakSet()
_POOLS_MU = threading.Lock()


def read_global_int(storage, name: str, default: int) -> int:
    """GLOBAL-scope sysvar as an int (DEFAULT_SYSVARS fallback) — THE
    config-read helper for server-side components that have no session
    (the pool, the accept loop's connection cap)."""
    from ..session.session import DEFAULT_SYSVARS
    g = getattr(storage, "_global_vars", {})
    try:
        return int(g.get(name, DEFAULT_SYSVARS.get(name, default)))
    except (TypeError, ValueError):
        return default


def read_global_str(storage, name: str, default: str) -> str:
    """GLOBAL-scope sysvar as a string (the ``tidb_wire_mode`` read in
    the accept loop)."""
    from ..session.session import DEFAULT_SYSVARS
    g = getattr(storage, "_global_vars", {})
    v = g.get(name, DEFAULT_SYSVARS.get(name, default))
    return default if v is None else str(v)


def gauges() -> dict:
    """Aggregate queued/running across every live pool (the /metrics
    feed)."""
    out = {"queued": 0, "running": 0}
    with _POOLS_MU:
        pools = list(_POOLS)
    for p in pools:
        snap = p.snapshot()
        if not snap["closed"]:
            out["queued"] += snap["queued"]
            out["running"] += snap["running"]
    return out

#: statement classes that execute on the pool; the rest run directly on
#: the connection thread (control plane must outlive a wedged pool)
_POOLED_STMTS = (ast.SelectStmt, ast.InsertStmt, ast.DeleteStmt,
                 ast.UpdateStmt)


class PoolClosed(Exception):
    """Typed shutdown error (generic 1105 on the wire)."""
    mysql_code = 1105
    sqlstate = "HY000"

    def __init__(self):
        super().__init__("server is shutting down")


class _Entry:
    __slots__ = ("session", "stmt", "label", "digest", "done", "result",
                 "error", "state", "queued_at", "batchable", "ctx",
                 "queued_mono", "claimed_at", "queue_wait_s", "verdict",
                 "on_done")

    def __init__(self, session, stmt, label: str, digest: str,
                 batchable: bool, on_done=None):
        # completion callback for async submitters (the aio front end):
        # invoked exactly once from complete(), on whatever thread
        # completed the entry (pool worker, canceller, closer).  It must
        # only ENQUEUE — socket writes stay on the event loop.
        self.on_done = on_done
        self.session = session
        self.stmt = stmt
        self.label = label
        self.digest = digest
        self.batchable = batchable
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.state = "queued"
        self.queued_at = time.time()
        # the submitting thread's context, captured NOW: workers run the
        # statement inside a copy of it, so spans recorded during
        # execution parent to whatever span was live at submit time (the
        # devpipe cross-thread idiom) instead of silently starting
        # a fresh chain on the worker thread
        self.ctx = contextvars.copy_context()
        # wait attribution (monotonic clock): queue_wait_s is filled at
        # claim time; verdict is "queued" when the entry had to wait
        # behind the pool, "admitted" when a worker was free
        self.queued_mono = time.monotonic()
        self.claimed_at = self.queued_mono
        self.queue_wait_s = 0.0
        self.verdict = "admitted"

    def claim(self) -> None:
        """A worker took this entry off the queue: freeze its measured
        queue wait.  The pool-side accumulator is fed later, at
        execution start (past the kill pre-checks) — an entry killed
        while queued never executes, never ingests its wait into
        statements_summary, and so must not count on the pool side
        either, or the two surfaces drift apart under KILL traffic."""
        self.claimed_at = time.monotonic()
        self.queue_wait_s = max(0.0, self.claimed_at - self.queued_mono)

    def wait_info(self, batch_wait_s: float = 0.0) -> dict:
        return {"queue_wait_s": self.queue_wait_s,
                "batch_wait_s": max(0.0, batch_wait_s),
                "admission_verdict": self.verdict}

    def complete(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.state = "done"
        self.done.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception:  # a callback bug must not kill the worker
                log.warning("entry on_done callback failed", exc_info=True)


class StatementPool:
    def __init__(self, storage):
        self.storage = storage
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queue: deque = deque()
        self._workers: List[threading.Thread] = []
        self._running = 0
        self._closed = False
        with _POOLS_MU:
            _POOLS.add(self)

    # ---- config (GLOBAL sysvars, read live) -----------------------------
    def _gvar(self, name: str, default: int) -> int:
        return read_global_int(self.storage, name, default)

    # ---- submit (connection threads / event loops) ----------------------
    def routes_to_pool(self, stmt) -> bool:
        """Does this statement execute on pool workers?  Control
        statements (and everything while pooling is off) run directly on
        the calling thread — the aio front end uses this to decide
        between async submission and inline execution."""
        return self._gvar("tidb_stmt_pool_size", 4) > 0 \
            and isinstance(stmt, _POOLED_STMTS)

    def run(self, session, stmt, label: str):
        """Execute one statement with admission control; blocks the
        calling connection thread until the pool completes it.  Control
        statements bypass the pool entirely."""
        if not self.routes_to_pool(stmt):
            return session.execute_stmt(stmt, label)
        return self._wait(self.submit(session, stmt, label))

    def submit(self, session, stmt, label: str, on_done=None) -> _Entry:
        """Enqueue one POOLED statement and return its entry without
        waiting (the aio front end's async half; ``run`` is submit +
        ``_wait``).  Admission control runs here — a shed statement
        raises :class:`~.admission.AdmissionRejected` and no entry is
        ever queued.  ``on_done`` fires exactly once at completion, on
        the completing thread."""
        size = self._gvar("tidb_stmt_pool_size", 4)
        digest = ""
        batchable = False
        if isinstance(stmt, ast.SelectStmt) \
                and self._gvar("tidb_batch_max_size", 16) >= 2 \
                and not session.in_txn() \
                and bool(session.get_sysvar("autocommit")):
            from ..ops import batching
            # normalize only once families exist: a cold server (or one
            # whose workload never takes a batchable fused path) skips
            # the per-statement tokenize entirely
            if batching.have_families():
                from ..obs import stmtsummary
                digest, _ = stmtsummary.normalize(
                    getattr(stmt, "src", "") or label)
                batchable = batching.family_batchable(digest)
        entry = _Entry(session, stmt, label, digest, batchable,
                       on_done=on_done)
        with self._cv:
            if self._closed:
                raise PoolClosed()
            admission.check_admit(
                len(self._queue),
                self._gvar("tidb_stmt_pool_queue_depth", 64),
                self._gvar("tidb_admission_mem_limit", 0))
            # a KILL delivered before this statement was submitted aimed
            # at the PREVIOUS statement (MySQL: current-or-nothing)
            session.guard.killed = False
            if self._running >= size or self._queue:
                admission.count_queued()
                entry.verdict = "queued"
            self._queue.append(entry)
            session.stmt_state = "queued"
            session.pending_sql = label
            session.queue_ts = entry.queued_at
            self._ensure_workers(size)
            self._cv.notify()
        return entry

    def cancel_if_queued(self, entry: _Entry,
                         err: BaseException) -> bool:
        """KILL / shutdown path for async submitters: remove a
        still-queued entry and fail it with ``err`` so no worker ever
        touches it (the aio twin of ``_wait``'s poll-cancel).  Returns
        False when a worker already claimed the entry — it then finishes
        through the statement's own interrupt checks."""
        with self._cv:
            if entry.state != "queued":
                return False
            try:
                self._queue.remove(entry)
            except ValueError:
                return False  # a worker grabbed it between checks
        # complete OUTSIDE the pool lock: on_done may hand the result to
        # an event loop (its own lock + wake pipe) — keep the lock order
        # one-way (pool only ever acquires loop-side state lock-free)
        self._fail_entry(entry, err)
        return True

    def _wait(self, entry: _Entry):
        """Poll-wait so KILL / shutdown reach a QUEUED statement without
        a worker ever touching it."""
        sess = entry.session
        while not entry.done.wait(0.05):
            if sess.guard.killed or sess.killed or self._closed:
                with self._cv:
                    if entry.state == "queued":
                        try:
                            self._queue.remove(entry)
                        except ValueError:
                            continue  # a worker grabbed it; keep waiting
                        self._fail_entry(
                            entry, PoolClosed() if self._closed
                            and not sess.guard.killed else QueryKilled())
                # running entries finish through the statement's own
                # interrupt checks — keep waiting for the worker
        if entry.error is not None:
            raise entry.error
        return entry.result

    @staticmethod
    def _clear_queued(session) -> None:
        session.stmt_state = ""
        session.pending_sql = ""

    @classmethod
    def _fail_entry(cls, entry: "_Entry", err: BaseException) -> None:
        """Complete an entry with an error, clearing its session's
        queued processlist state (an abandoned 'queued' row would
        outlive the pool)."""
        cls._clear_queued(entry.session)
        entry.complete(error=err)

    # ---- workers ---------------------------------------------------------
    def _ensure_workers(self, size: int) -> None:
        # caller holds the lock; workers spawn on demand up to the
        # CURRENT pool-size sysvar (growth applies immediately, shrink
        # applies to future spawns)
        self._workers = [t for t in self._workers if t.is_alive()]
        if len(self._workers) < min(size, len(self._queue)
                                    + self._running + 1):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"stmt-pool-{len(self._workers)}")
            self._workers.append(t)
            t.start()

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                # concurrency is enforced at CLAIM time against the LIVE
                # pool-size sysvar: lowering tidb_stmt_pool_size takes
                # effect immediately (surplus workers idle), not just
                # for future spawns.  Size 0 ("pooling off") stops NEW
                # enqueues in run(), but already-queued entries still
                # drain on one worker — never strand a waiter
                while not self._closed and (
                        not self._queue
                        or self._running >= max(
                            1, self._gvar("tidb_stmt_pool_size", 4))):
                    self._cv.wait(timeout=0.25)
                if self._closed:
                    while self._queue:
                        self._fail_entry(self._queue.popleft(),
                                         PoolClosed())
                    return
                entry = self._queue.popleft()
                entry.claim()
                self._running += 1
            try:
                self._serve(entry)
            finally:
                with self._cv:
                    self._running -= 1
                    self._cv.notify()

    def _serve(self, entry: _Entry) -> None:
        # the chaos wedge: an armed admissionDelay sleeps (or errors)
        # the WORKER with the entry claimed — queue builds behind it,
        # KILL and control statements must keep working
        try:
            fail.inject("admissionDelay")
        except Exception as e:
            self._fail_entry(entry, e)
            return
        group = [entry]
        try:
            if entry.batchable:
                group += self._form_group(entry)
            if len(group) == 1:
                self._run_one(entry)
            else:
                self._run_batch(group)
        except BaseException as e:
            # backstop: NO claimed entry may ever be left incomplete —
            # a waiter with an unset done event would hang its
            # connection thread forever with no error and no KILL path
            for m in group:
                if not m.done.is_set():
                    self._fail_entry(m, e)
            if not isinstance(e, Exception):
                raise  # SystemExit/KeyboardInterrupt still propagate
            log.warning("statement-pool worker error", exc_info=True)

    def _form_group(self, leader: _Entry) -> List[_Entry]:
        """Pull same-digest batchable statements off the queue, topping
        up for at most ``tidb_batch_window_ms``.  Only what is still
        queued joins: an idle worker dequeues a same-digest statement
        in :meth:`_worker_loop` and leads a round of its own, so with
        several workers a storm splits into several rounds (ROADMAP
        queue 1, item 7)."""
        max_size = self._gvar("tidb_batch_max_size", 16)
        window_s = self._gvar("tidb_batch_window_ms", 2) / 1e3
        deadline = time.monotonic() + window_s
        members: List[_Entry] = []
        while True:
            with self._cv:
                for e in list(self._queue):
                    if len(members) + 1 >= max_size:
                        break
                    if e.batchable and e.digest == leader.digest:
                        self._queue.remove(e)
                        e.claim()
                        e.state = "batched"
                        members.append(e)
                remaining = deadline - time.monotonic()
                if len(members) + 1 >= max_size or remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
        return members

    @staticmethod
    def _exec_entry(entry: _Entry, rnd=None):
        """Run the entry's statement INSIDE the context captured at
        submit time (cross-thread span parenting, the devpipe
        idiom): the statement's parse→plan→execute span chain parents
        to whatever span was live on the submitting thread instead of
        starting an orphan chain on the worker.  The batch round (when
        given) is activated inside that copied context — activating it
        on the worker's own context would be invisible there."""
        entry.session.pending_wait = entry.wait_info(
            batch_wait_s=(time.monotonic() - entry.claimed_at)
            if rnd is not None else 0.0)

        def _invoke():
            if rnd is None:
                return entry.session.execute_stmt(entry.stmt, entry.label)
            from ..ops import batching
            tok = batching.activate(rnd)
            try:
                return entry.session.execute_stmt(entry.stmt, entry.label)
            finally:
                batching.deactivate(tok)
        return entry.ctx.run(_invoke)

    def _run_one(self, entry: _Entry) -> None:
        sess = entry.session
        self._clear_queued(sess)
        entry.state = "running"
        if sess.guard.killed or sess.killed:
            entry.complete(error=QueryKilled())
            return
        admission.count_admitted()
        admission.record_queue_wait(entry.queue_wait_s)
        try:
            entry.complete(result=self._exec_entry(entry))
        except BaseException as e:
            entry.complete(error=e)

    def _run_batch(self, group: List[_Entry]) -> None:
        """Drive one coalesced group through collect / dispatch / replay
        (module docstring; ops/batching.py has the protocol contract)."""
        from ..ops import batching
        rnd = batching.BatchRound(
            stack_max=self._gvar("tidb_batch_stack_max", 16))
        pending: List[_Entry] = []
        for e in group:
            sess = e.session
            self._clear_queued(sess)
            e.state = "running"
            if sess.guard.killed or sess.killed:
                e.complete(error=QueryKilled())
                continue
            admission.count_admitted()
            rnd.collecting = True
            try:
                result = self._exec_entry(e, rnd)
            except batching.Parked:
                # wait accounting deferred to the replay leg: a parked
                # member can still be killed before it ever executes,
                # and a killed member must not count on the pool side
                # (the claim() contract)
                pending.append(e)
            except BaseException as ex:
                admission.record_queue_wait(e.queue_wait_s)
                e.complete(error=ex)
            else:
                admission.record_queue_wait(e.queue_wait_s)
                e.complete(result=result)
            finally:
                rnd.collecting = False
        if not pending:
            return
        occ = rnd.dispatch()
        log.debug("batch round: %d member(s) through one program", occ)
        for e in pending:
            # a KILL that landed while this member sat parked (collect
            # of later members, the round dispatch) must abort it here:
            # the replay's own guard.begin() would silently clear the
            # kill flag before any interrupt check could fire
            if e.session.guard.killed or e.session.killed:
                e.complete(error=QueryKilled())
                continue
            admission.record_queue_wait(e.queue_wait_s)
            rnd.replaying = True
            try:
                # the replay leg re-deposits wait info (the parked
                # collect leg consumed the first deposit but is
                # invisible to observability): batch_wait now spans
                # claim -> replay, i.e. the time spent waiting on the
                # round's other members + the shared dispatch
                e.complete(result=self._exec_entry(e, rnd))
            except BaseException as ex:
                e.complete(error=ex)
            finally:
                rnd.replaying = False

    # ---- introspection / lifecycle --------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {"queued": len(self._queue), "running": self._running,
                    "workers": sum(1 for t in self._workers
                                   if t.is_alive()),
                    "closed": self._closed}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            while self._queue:
                self._fail_entry(self._queue.popleft(), PoolClosed())
            self._cv.notify_all()

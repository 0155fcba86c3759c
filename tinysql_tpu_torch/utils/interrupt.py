"""Statement interruption: per-session kill flag + execution deadline.

The volcano interruption design (reference: executor/executor.go
``handleNoDelay``/killed-flag checks inside Next loops, plus
expensivequery.go's max_execution_time enforcement): every session owns
one :class:`StatementGuard`; the session arms it per statement (reset
kill flag, compute the ``max_execution_time`` deadline) and installs it
in a contextvar so every block boundary — ``Executor.drain``, the
all-consuming agg/join/sort loops, the BlockPipeline producer (context
is copied across the thread), the distsql worker pool, and
``Backoffer.backoff`` — can call :func:`check` without plumbing.

``KILL [QUERY] <conn_id>`` resolves through the process-global session
registry here: every Session gets a unique ``conn_id`` at construction
(the MySQL thread id the server hands out in its handshake), and
:func:`kill` flips the target's guard from ANY thread.  A plain ``KILL``
additionally marks the session dead so its server connection closes
after the current command.

Error surface (MySQL codes): kill -> 1317 ER_QUERY_INTERRUPTED,
deadline -> 3024 ER_QUERY_TIMEOUT.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
import weakref
from typing import Dict, Optional


class QueryKilled(Exception):
    """ER_QUERY_INTERRUPTED."""
    mysql_code = 1317
    sqlstate = "70100"

    def __init__(self, msg: str = "Query execution was interrupted"):
        super().__init__(msg)


class QueryTimeout(Exception):
    """ER_QUERY_TIMEOUT."""
    mysql_code = 3024
    sqlstate = "HY000"

    def __init__(self, msg: str = "Query execution was interrupted, "
                                  "maximum statement execution time "
                                  "exceeded"):
        super().__init__(msg)


class StatementGuard:
    """Kill flag + deadline for ONE session's current statement.  The
    flag is a plain bool written from other threads (GIL-atomic); the
    deadline is a monotonic timestamp or None."""

    __slots__ = ("conn_id", "killed", "deadline")

    def __init__(self, conn_id: int = 0):
        self.conn_id = conn_id
        self.killed = False
        self.deadline: Optional[float] = None

    def begin(self, deadline: Optional[float] = None) -> None:
        """Arm for a fresh statement.  A kill that raced in BETWEEN
        statements is dropped, matching MySQL (KILL QUERY affects the
        statement executing at the time, or nothing)."""
        self.killed = False
        self.deadline = deadline

    def kill(self) -> None:
        self.killed = True

    def check(self) -> None:
        if self.killed:
            raise QueryKilled()
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryTimeout()


_GUARD: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_stmt_guard", default=None)


def activate(guard: StatementGuard):
    return _GUARD.set(guard)


def deactivate(token) -> None:
    _GUARD.reset(token)


def current() -> Optional[StatementGuard]:
    return _GUARD.get()


def check() -> None:
    """THE block-boundary hook: raises QueryKilled / QueryTimeout when
    the current statement was killed or ran past its deadline; no-op
    outside a guarded statement."""
    g = _GUARD.get()
    if g is not None:
        g.check()


# ---- session registry (KILL target resolution) ----------------------------

_reg_mu = threading.Lock()
_next_conn_id = itertools.count(1)
#: conn_id -> weakref to the owning Session
_SESSIONS: Dict[int, "weakref.ref"] = {}


def register_session(session) -> int:
    """Assign a process-unique connection id and index the session for
    KILL resolution.  Dead entries are swept opportunistically."""
    cid = next(_next_conn_id)
    ref = weakref.ref(session, lambda _r, cid=cid: _drop(cid))
    with _reg_mu:
        _SESSIONS[cid] = ref
    return cid


def _drop(cid: int) -> None:
    with _reg_mu:
        _SESSIONS.pop(cid, None)


def lookup(conn_id: int):
    with _reg_mu:
        ref = _SESSIONS.get(conn_id)
    return ref() if ref is not None else None


def sessions():
    """Snapshot of live registered sessions as ``(conn_id, session)``
    pairs (the ``information_schema.processlist`` feed).  Dead weakrefs
    are skipped; the strong refs live only as long as the caller's
    iteration."""
    with _reg_mu:
        refs = list(_SESSIONS.items())
    out = []
    for cid, ref in refs:
        sess = ref()
        if sess is not None:
            out.append((cid, sess))
    return out


def executing_threads() -> Dict[int, object]:
    """``thread ident -> session`` for sessions whose statement is
    currently EXECUTING on that thread (``session.stmt_thread_ident``,
    stamped when the statement is armed) — the continuous profiler's
    attribution feed (obs/conprof.py): a stack sample landing on one of
    these threads is on-thread time of that session's live statement.
    Queued statements (no worker yet) and helper threads a statement
    spawns (devpipe producer, distsql workers) are deliberately absent.
    """
    out: Dict[int, object] = {}
    for _cid, sess in sessions():
        if not getattr(sess, "stmt_running", False):
            continue
        tid = getattr(sess, "stmt_thread_ident", 0)
        if tid:
            out[tid] = sess
    return out


#: kill observers (the aio front end's wake hook): a parked idle
#: connection has NO blocked reader thread to notice ``session.killed``,
#: so the event loop registers a callback here and :func:`kill` invokes
#: it AFTER the flags flip — the loop's self-pipe then closes the victim
#: within one tick.  Callbacks must only enqueue/wake, never block.
_KILL_OBSERVERS: list = []
_obs_mu = threading.Lock()


def add_kill_observer(fn) -> None:
    """Register ``fn(conn_id, query_only)`` to run after every kill."""
    with _obs_mu:
        if fn not in _KILL_OBSERVERS:
            _KILL_OBSERVERS.append(fn)


def remove_kill_observer(fn) -> None:
    with _obs_mu:
        try:
            _KILL_OBSERVERS.remove(fn)
        except ValueError:
            pass


def kill(conn_id: int, query_only: bool = True) -> bool:
    """KILL [QUERY] <conn_id>.  Returns False when the id is unknown.
    ``query_only=False`` (plain KILL) also marks the session killed so
    its server connection drops after the current command."""
    sess = lookup(conn_id)
    if sess is None:
        return False
    guard = getattr(sess, "guard", None)
    if guard is not None:
        guard.kill()
    if not query_only:
        sess.killed = True
    with _obs_mu:
        observers = list(_KILL_OBSERVERS)
    for fn in observers:
        try:
            fn(conn_id, query_only)
        except Exception:  # a wake-hook bug must not fail the KILL
            pass
    return True

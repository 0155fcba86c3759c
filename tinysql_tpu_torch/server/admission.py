"""Admission control for the statement-execution pool.

The serving contract (ROADMAP open item 2): heavy multi-client load
must degrade by QUEUEING then SHEDDING — typed, retryable errors — and
never by unbounded thread/memory growth or a wedged accept loop.  The
gate runs at submit time in ``server/pool.py`` and folds the live
signals the engine already publishes:

- **pool queue depth** vs ``tidb_stmt_pool_queue_depth`` — the primary
  backpressure signal;
- **aggregate memory pressure**: the sum of every running statement's
  MemTracker bytes (statement quotas; the always-installed tracker feeding
  ``processlist.mem_bytes``) vs ``tidb_admission_mem_limit`` — when the
  in-flight set already holds that much, new work is shed instead of
  queued behind statements that may OOM-abort anyway;
- the reference also halves the queue cap while a device loss pins
  planning to the CPU (its ``ops/degrade.py``).  The port has no such
  pin: a device error fails the statement and the next one uses the
  card again (ROADMAP queue 1, item 6 decides what a lost card should
  do in a server), so no statement is ever CPU-pinned and the cap is
  never halved;
- the ``admissionQueueFull`` failpoint, which forces the queue-full
  verdict for chaos drills.

A rejection is MySQL error 1041 (ER_OUT_OF_RESOURCES) with an explicit
retry hint — clients are expected to back off and retry, exactly like
TiDB's server-busy shedding.

Counter-write discipline: ``STATS`` is written only through
:func:`_count` in this module (qlint OB401/OB402 — admission.py is an
owning module); /metrics renders the snapshot.
"""
from __future__ import annotations

import threading
from typing import Dict

from .. import fail

#: process-total admission verdicts: admitted = began executing,
#: queued = waited in the pool queue first, rejected = shed with 1041.
#: queue_wait_s_sum accumulates every pooled statement's measured wait
#: for a worker (pool claim time minus submit time) — the pool-side
#: half of the per-statement queue_wait attribution, so
#: statements_summary's sum_queue_wait_ms can be reconciled against the
#: serving tier's own accounting over any metrics_history window
STATS = {"admitted": 0, "queued": 0, "rejected": 0,
         "queue_wait_s_sum": 0.0}

#: process-total CONNECTION admission verdicts (the 1040 gate at
#: accept, both wire modes): accepts = connections handed to a front
#: end, sheds = connects refused with ERR 1040 before any handshake.
#: The ``tinysql_conn_accepts/sheds_total`` ring metrics read this —
#: the connection-pressure inspection rule's evidence.
CONN_STATS = {"accepts": 0, "sheds": 0}
_mu = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _mu:
        STATS[key] = STATS.get(key, 0) + n


def _count_conn(key: str, n: int = 1) -> None:
    with _mu:
        CONN_STATS[key] = CONN_STATS.get(key, 0) + n


def stats_snapshot() -> Dict[str, int]:
    with _mu:
        return dict(STATS)


def conn_stats_snapshot() -> Dict[str, int]:
    with _mu:
        return dict(CONN_STATS)


def reset_stats() -> None:
    """Tests only."""
    with _mu:
        for k in STATS:
            STATS[k] = 0
        for k in CONN_STATS:
            CONN_STATS[k] = 0


class AdmissionRejected(Exception):
    """MySQL 1041 ER_OUT_OF_RESOURCES: the server is shedding load.
    The message always carries the retry hint — rejection is a
    backpressure signal, not a statement failure."""

    mysql_code = 1041
    sqlstate = "HY000"

    def __init__(self, reason: str):
        super().__init__(
            f"server overloaded ({reason}); retry later with backoff")
        self.reason = reason


def aggregate_stmt_mem() -> int:
    """Live bytes held by RUNNING statements across every registered
    session (the processlist feed's MemTracker sum)."""
    from ..utils import interrupt
    total = 0
    for _cid, sess in interrupt.sessions():
        if getattr(sess, "stmt_running", False):
            mt = getattr(sess, "_stmt_mem", None)
            if mt is not None:
                total += mt.consumed
    return total


def effective_queue_cap(queue_cap: int) -> int:
    """The configured cap.  The reference halves it during a device-loss
    cooldown; the port has no cooldown (module docstring)."""
    return queue_cap


def check_admit(queue_len: int, queue_cap: int,
                mem_limit: int = 0) -> None:
    """Raise :class:`AdmissionRejected` when the statement must be shed;
    plain return means it may run or queue.  The caller holds the pool
    lock, so ``queue_len`` is exact."""
    if fail.eval_point("admissionQueueFull"):
        _count("rejected")
        raise AdmissionRejected("admission queue full [failpoint]")
    cap = effective_queue_cap(queue_cap)
    if cap > 0 and queue_len >= cap:
        _count("rejected")
        raise AdmissionRejected(
            f"statement queue full: {queue_len} waiting, cap {cap}")
    if mem_limit > 0:
        used = aggregate_stmt_mem()
        if used >= mem_limit:
            _count("rejected")
            raise AdmissionRejected(
                f"statement memory pressure: {used} bytes in flight, "
                f"tidb_admission_mem_limit {mem_limit}")


def check_connect(open_count: int, cap: int) -> bool:
    """The CONNECTION-admission verdict at accept time (both wire
    modes): True admits (counted), False means the accept loop must
    refuse with ERR 1040 as the first packet (counted as a shed).
    ``cap`` is ``tidb_max_server_connections`` (0 = unlimited)."""
    if cap > 0 and open_count >= cap:
        _count_conn("sheds")
        return False
    _count_conn("accepts")
    return True


def count_admitted() -> None:
    _count("admitted")


def count_queued() -> None:
    _count("queued")


def record_queue_wait(seconds: float) -> None:
    """One claimed entry's measured wait for a worker (called by the
    pool at claim time, queued and immediately-admitted entries both —
    an 'admitted' wait is just very small)."""
    _count("queue_wait_s_sum", float(seconds))

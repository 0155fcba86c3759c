"""Per-query memory quota (reference: util/memory.Tracker +
``tidb_mem_quota_query`` with the CANCEL OOM action) — now with LIVE-SET
accounting and a soft spill watermark.

A statement always runs with a :class:`MemTracker` installed in a
contextvar; the chunk layer (chunk/column.py) charges every column-buffer
allocation — ``Column.__init__`` capacity, ``_grow`` deltas,
``from_numpy`` materializations — against it and RELEASES the charge when
the buffer is freed (``Column.__del__`` / ``free``), so ``consumed`` is
the statement's live working set, not a monotonic allocation total.
``peak`` keeps the high-water mark for ``statements_summary``.

Two thresholds, one graceful-degradation ladder:

- ``spill_watermark`` (``tidb_mem_quota_spill_ratio`` × the quota): a SOFT
  line.  Crossing it flips ``spill_requested()`` true and fires any
  registered pressure callbacks — spill-capable operators (ops/spill.py:
  hybrid hash join, hash agg, sort/topn) switch into partitioned spill
  mode instead of dying, turning the quota into a working-set bound.
- ``quota`` (``tidb_mem_quota_query``): the HARD line.  Before raising,
  ``consume`` gives registered pressure callbacks one chance to evict
  (spill partitions release through :meth:`release`); only if the total
  is still over does :class:`MemQuotaExceeded` (MySQL error 8175) abort
  the statement — the true last resort after recursive-repartition
  exhaustion in the spill layer.

Zero-copy views (``Column.wrap_raw`` over replica arrays) are never
charged.  The spill layer's own partition buffers charge through
``consume_soft`` (track + watermark, never raise): the layer whose job
is REDUCING pressure must not be killed by its own bookkeeping.

:func:`soft_scope` extends the same exemption to a spill-mode operator's
INPUT materialization: a cold scan (no replica to serve zero-copy views)
must accumulate the child's chunks into one charged buffer before the
partitioner can take over and release it — killing the statement inside
that transient would defeat the spill it was about to perform.  Charges
made inside the scope route through ``consume_soft`` (tracked, visible
in ``peak``/processlist, watermark still fires); the very next hard
``consume`` outside the scope re-enforces the quota against the full
live set.  The scope rides a contextvar, so pipeline producer threads
(spawned under a copied context) inherit it.
"""
from __future__ import annotations

import contextvars
import threading
from typing import Callable, List, Optional

#: process-total statements aborted by quota (exported to /metrics)
_aborts_mu = threading.Lock()
_ABORTS = 0

#: depth of the active soft-ingest scope (see :func:`soft_scope`)
_SOFT_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_mem_soft_scope", default=0)


class MemQuotaExceeded(Exception):
    """TiDB error 8175 (ErrMemoryExceedForQuery)."""
    mysql_code = 8175
    sqlstate = "HY000"

    def __init__(self, consumed: int, quota: int, detail: str = ""):
        super().__init__(
            "Out Of Memory Quota! query tried to allocate "
            f"{consumed} bytes with tidb_mem_quota_query = {quota}"
            + (f" ({detail})" if detail else ""))
        self.consumed = consumed
        self.quota = quota


class MemTracker:
    """Live-byte accumulator with a hard quota and a soft spill
    watermark.  ``consume``/``release`` are called from the statement
    thread and any pipeline producer threads (context is copied across).
    With a quota armed it locks (the abort decision must see a consistent
    total); with quota 0 — the always-installed tracker feeding
    ``processlist.mem_bytes`` — it is a bare ``+=``: display-only
    accounting tolerates the rare torn update under producer threads, and
    the hot allocation path stays lock-free."""

    __slots__ = ("quota", "consumed", "peak", "spill_watermark",
                 "spill_engaged", "_spill_live", "_aborted", "_spilling",
                 "_in_evict", "_cbs", "_mu")

    def __init__(self, quota: int, spill_watermark: int = 0):
        self.quota = int(quota)
        self.consumed = 0
        self.peak = 0
        #: soft line (bytes); 0 = no watermark (spill only when forced)
        self.spill_watermark = int(spill_watermark)
        #: sticky: a spill ROUTE ran for this statement (SpillContext
        #: marks it at route entry).  From then on the hard abort defers
        #: to the spill layer's ladder (typed 8175 at
        #: recursive-repartition exhaustion) — the statement chose
        #: graceful degradation, so transient over-quota staging
        #: (ingest, key extraction, output assembly over a still-live
        #: materialized input) must not kill it.  A context that opens
        #: and closes WITHOUT running a route (sort/topn single-run,
        #: agg falling back to sort-based grouping) does NOT engage:
        #: hard enforcement resumes at its close.
        self.spill_engaged = False
        #: live SpillContext count: the abort also defers while one is
        #: open (its staging is in flight even before the route runs)
        self._spill_live = 0
        self._aborted = False
        self._spilling = False     # watermark crossed at least once
        self._in_evict = False     # re-entrancy guard for callbacks
        self._cbs: List[Callable[[], None]] = []
        self._mu = threading.Lock()

    # ---- pressure callbacks (ops/spill.py registers) --------------------
    def on_pressure(self, cb: Callable[[], None]) -> None:
        """Register a spill callback: invoked (outside the lock) when the
        soft watermark is crossed and again as a last chance before a
        hard-quota abort.  Callbacks must be idempotent and must only
        FREE memory (via :meth:`release`), never allocate unboundedly."""
        with self._mu:
            if cb not in self._cbs:
                self._cbs.append(cb)

    def remove_pressure(self, cb) -> None:
        with self._mu:
            try:
                self._cbs.remove(cb)
            except ValueError:
                pass

    # ---- spill engagement (ops/spill.SpillContext drives) ---------------
    def spill_enter(self) -> None:
        """A SpillContext opened: defer the hard abort while it lives."""
        with self._mu:
            self._spill_live += 1

    def spill_exit(self) -> None:
        with self._mu:
            if self._spill_live > 0:
                self._spill_live -= 1

    def spill_engage(self) -> None:
        """A spill route actually ran: the deferral becomes sticky (the
        route's output assembly outlives its context)."""
        self.spill_engaged = True

    def spill_requested(self) -> bool:
        """True once live bytes crossed the soft watermark — operators
        poll this at block boundaries to flip into spill mode."""
        if self._spilling:
            return True
        return (self.spill_watermark > 0
                and self.consumed >= self.spill_watermark)

    def headroom(self) -> int:
        """Bytes left below the soft watermark (0 when none / no
        watermark armed) — the spill layer's resident-partition budget."""
        if self.spill_watermark <= 0:
            return 0
        return max(self.spill_watermark - self.consumed, 0)

    # ---- accounting ------------------------------------------------------
    def consume(self, n: int) -> None:
        global _ABORTS
        if n <= 0:
            return
        if _SOFT_SCOPE.get():
            # spill-mode ingest transient (see soft_scope): tracked, never
            # aborts — the partitioner releases it right after
            self.consume_soft(n)
            return
        if self.quota <= 0:
            self.consumed += n
            if self.consumed > self.peak:
                self.peak = self.consumed
            return
        with self._mu:
            self.consumed += n
            if self.consumed > self.peak:
                self.peak = self.consumed
            over = self.quota < self.consumed
            cross = (not self._spilling and self.spill_watermark > 0
                     and self.consumed >= self.spill_watermark)
            if cross:
                self._spilling = True
            cbs = list(self._cbs) if (over or cross) else ()
        # callbacks run OUTSIDE the lock: they release() through us
        if cbs and not self._in_evict:
            self._in_evict = True
            try:
                for cb in cbs:
                    try:
                        cb()
                    except MemQuotaExceeded:
                        raise
                    except Exception:
                        pass  # a broken spiller must not mask the abort
            finally:
                self._in_evict = False
        if not over:
            return
        if self._in_evict:
            # an eviction callback's own transient allocations must not
            # abort the statement mid-spill; the post-evict re-check in
            # the frame that triggered eviction still enforces the quota
            return
        with self._mu:
            still_over = self.quota < self.consumed
            consumed = self.consumed
            engaged = self.spill_engaged or self._spill_live > 0
        if still_over and engaged:
            # this statement engaged memory-adaptive execution (a spill
            # context is live, or a spill route already ran) and the
            # evictors had their chance: what remains over quota is
            # staging the spill layer owns — ingest accumulation,
            # whole-input key extraction, output assembly over a
            # still-live materialized input.  The abort defers to that
            # layer's ladder (recursive repartition -> typed 8175 at
            # exhaustion); statements that never engage keep the
            # immediate hard kill below.
            return
        with self._mu:
            still_over = self.quota < self.consumed
            consumed = self.consumed
            # the statement-abort counter counts STATEMENTS: the first
            # over-quota consume trips it; re-raises while the doomed
            # statement unwinds (producer thread, cleanup allocs) don't
            first = still_over and not self._aborted
            if still_over:
                self._aborted = True
        if still_over:
            if first:
                with _aborts_mu:
                    _ABORTS += 1
            raise MemQuotaExceeded(consumed, self.quota)

    def consume_soft(self, n: int) -> None:
        """Track ``n`` bytes without ever raising: the spill layer's own
        partition residency.  Watermark state still updates so
        ``spill_requested`` / ``headroom`` see the true live set, and
        crossing the watermark fires the pressure callbacks once (so a
        spill layer whose own residency is the pressure evicts itself)."""
        if n <= 0:
            return
        if self.quota <= 0:
            self.consumed += n
            if self.consumed > self.peak:
                self.peak = self.consumed
            return
        with self._mu:
            self.consumed += n
            if self.consumed > self.peak:
                self.peak = self.consumed
            cross = (not self._spilling and self.spill_watermark > 0
                     and self.consumed >= self.spill_watermark)
            if cross:
                self._spilling = True
            cbs = list(self._cbs) if cross else ()
        if cbs and not self._in_evict:
            self._in_evict = True
            try:
                for cb in cbs:
                    try:
                        cb()
                    except Exception:
                        pass
            finally:
                self._in_evict = False

    def release(self, n: int) -> None:
        """Return ``n`` bytes to the budget (buffer freed / partition
        spilled out).  Floored at 0: over-release from mismatched pairing
        must not wrap the live set negative."""
        if n <= 0:
            return
        if self.quota <= 0:
            c = self.consumed - n
            self.consumed = c if c > 0 else 0
            return
        with self._mu:
            c = self.consumed - n
            self.consumed = c if c > 0 else 0


_TRACKER: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_mem_tracker", default=None)


def activate(tracker: MemTracker):
    return _TRACKER.set(tracker)


def deactivate(token) -> None:
    _TRACKER.reset(token)


def current() -> Optional[MemTracker]:
    return _TRACKER.get()


def consume(n: int) -> None:
    """The allocation hook: charges the active statement's tracker —
    one contextvar read plus a lock-free ``+=`` without a quota (the
    session installs a quota-0 tracker for every statement so
    ``processlist`` can report live bytes), the locked quota path
    otherwise; a bare contextvar read outside any statement."""
    t = _TRACKER.get()
    if t is not None:
        t.consume(n)


def consume_tracked(n: int) -> Optional[MemTracker]:
    """Charge ``n`` bytes and return the tracker that was charged (None
    outside any statement) — the chunk layer pairs the release against
    the SAME tracker at buffer free, so a column outliving its statement
    can never corrupt a later statement's books."""
    t = _TRACKER.get()
    if t is not None and n > 0:
        t.consume(n)
    return t


class soft_scope:
    """``with memory.soft_scope():`` — charges inside route through
    :meth:`MemTracker.consume_soft` (tracked + watermark, never 8175).
    Used by spill-mode operators around the input-materialization copies
    (_drain_chunk accumulator growth, the materialization ``compact()``)
    that the partitioner immediately consumes and releases; everything
    else in the subtree keeps hard enforcement.  Nestable; thread-safe
    via contextvar (producer threads under copied contexts inherit)."""

    __slots__ = ("_tok",)

    def __enter__(self):
        self._tok = _SOFT_SCOPE.set(_SOFT_SCOPE.get() + 1)
        return self

    def __exit__(self, *exc):
        _SOFT_SCOPE.reset(self._tok)
        return False


def aborts_total() -> int:
    with _aborts_mu:
        return _ABORTS

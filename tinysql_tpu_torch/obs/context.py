"""Per-query observability scope, threaded through ``contextvars``.

The device layer (ops/kernels.py, ops/progcache.py) reports every
counter increment through ``record`` / ``record_hwm``; this module fans
each one out to

- the active statement's ``QueryObs`` (its query-total counters), and
- the ``RuntimeStats`` of the operator whose ``next()`` frame is live
  (set by ``runtime_stats.instrument_tree`` wrappers),

so two sessions executing concurrently collect disjoint per-query
counters — the global ``kernels.STATS`` dict stays monotonic for
``/metrics`` but is no longer the only (and corruptible) attribution
path.  ``contextvars`` gives thread- and task-local scoping for free;
the devpipe producer thread opts in by running inside
``contextvars.copy_context()`` of its creator (executor/devpipe.py
BlockPipeline), which also parents its spans correctly.

Accumulator vs high-water-mark semantics: ``record`` adds, ``record_hwm``
keeps the max seen *within the query scope* (e.g. ``pipe_depth_hwm`` —
a deep staging queue in query N must not bleed into query N+1).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, List, Optional

from .trace import Tracer

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_obs_query", default=None)
_CURRENT_OP: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_obs_op", default=None)
_CURRENT_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "tinysql_obs_span", default=None)


class RuntimeStats:
    """Per-operator runtime stats (reference: util/execdetails
    RuntimeStats): actual rows emitted, Next loops, inclusive wall time
    in open+next, and the device counters attributed while this
    operator's ``next()`` frame was the innermost live one."""

    __slots__ = ("label", "act_rows", "loops", "wall_s", "open_s",
                 "device", "_mu")

    def __init__(self, label: str):
        self.label = label
        self.act_rows = 0
        self.loops = 0
        self.wall_s = 0.0
        self.open_s = 0.0
        self.device: Dict[str, float] = {}
        self._mu = threading.Lock()

    def add_device(self, key: str, n) -> None:
        with self._mu:
            self.device[key] = self.device.get(key, 0) + n

    def hwm_device(self, key: str, n) -> None:
        with self._mu:
            if n > self.device.get(key, 0):
                self.device[key] = n

    def to_dict(self) -> dict:
        with self._mu:
            dev = dict(self.device)
        return {"label": self.label, "act_rows": self.act_rows,
                "loops": self.loops, "time_ms": round(self.wall_s * 1e3, 3),
                "open_ms": round(self.open_s * 1e3, 3), "device": dev}


class QueryObs:
    """One statement's observability scope: query-total device counters,
    per-operator RuntimeStats (keyed by physical plan node identity),
    and the span tracer.  Mutated from the executing thread and any
    devpipe producer threads it spawns — counter paths take the lock."""

    def __init__(self, sql: str = ""):
        self.sql = sql
        self.started_at = time.time()
        self.tracer = Tracer()
        self.plan_digest = ""
        #: rendered EXPLAIN rows of the placed plan (set by the session
        #: select/explain paths; statements_summary samples them)
        self.plan_rows = None
        #: serving-path wait attribution (set by the session from the
        #: statement pool's measurement): "admitted" ran immediately,
        #: "queued" waited for a worker first, "" never went through the
        #: pool (control statements, embedded execution, pooling off)
        self.admission_verdict = ""
        self.info: Dict[str, float] = {}
        self._mu = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._ops: Dict[int, RuntimeStats] = {}
        self._op_order: List[RuntimeStats] = []
        self._buckets: set = set()

    # ---- counters -------------------------------------------------------
    def add_counter(self, key: str, n) -> None:
        with self._mu:
            self._counters[key] = self._counters.get(key, 0) + n

    def hwm_counter(self, key: str, n) -> None:
        with self._mu:
            if n > self._counters.get(key, 0):
                self._counters[key] = n

    def device_totals(self) -> Dict[str, float]:
        """This query's device counters (the per-query replacement for a
        global ``kernels.stats_snapshot``/``stats_delta`` pair)."""
        with self._mu:
            return dict(self._counters)

    # ---- observed shape buckets ----------------------------------------
    def add_bucket(self, b: int) -> None:
        with self._mu:
            self._buckets.add(b)

    def observed_shape_buckets(self):
        """Power-of-two buckets this query's kernels ACTUALLY padded to
        (recorded by kernels.bucket while the scope was active) — ground
        truth for the prewarm feedback loop, covering fused-pipeline
        input shapes that never flow through an operator's next()."""
        with self._mu:
            return sorted(self._buckets)

    # ---- per-operator stats --------------------------------------------
    def op_stats(self, plan_node, label: str) -> RuntimeStats:
        key = id(plan_node)
        with self._mu:
            st = self._ops.get(key)
            if st is None:
                st = self._ops[key] = RuntimeStats(label)
                self._op_order.append(st)
            return st

    def op_stats_for(self, plan_node) -> Optional[RuntimeStats]:
        with self._mu:
            return self._ops.get(id(plan_node))

    def operators(self) -> List[dict]:
        with self._mu:
            ops = list(self._op_order)
        return [st.to_dict() for st in ops]

    def summary(self) -> dict:
        return {"sql": self.sql, "plan_digest": self.plan_digest,
                "info": dict(self.info), "device": self.device_totals(),
                "operators": self.operators()}


# ---- scope management ----------------------------------------------------

def activate(qobs: QueryObs):
    """Install ``qobs`` as the current statement scope; returns the token
    for ``deactivate``."""
    return _CURRENT.set(qobs)


def deactivate(token) -> None:
    _CURRENT.reset(token)


def current() -> Optional[QueryObs]:
    return _CURRENT.get()


def current_op() -> Optional[RuntimeStats]:
    return _CURRENT_OP.get()


def push_op(st: RuntimeStats):
    return _CURRENT_OP.set(st)


def pop_op(token) -> None:
    _CURRENT_OP.reset(token)


# ---- the device-layer fan-out (called by kernels.stats_add et al.) -------

def record(key: str, n) -> None:
    q = _CURRENT.get()
    if q is None:
        return
    q.add_counter(key, n)
    op = _CURRENT_OP.get()
    if op is not None:
        op.add_device(key, n)


def record_hwm(key: str, n) -> None:
    q = _CURRENT.get()
    if q is None:
        return
    q.hwm_counter(key, n)
    op = _CURRENT_OP.get()
    if op is not None:
        op.hwm_device(key, n)


def record_bucket(b: int) -> None:
    """Called by kernels.bucket: the actual padded shape this query is
    about to compile/dispatch for."""
    q = _CURRENT.get()
    if q is not None:
        q.add_bucket(b)


# ---- spans ---------------------------------------------------------------

@contextlib.contextmanager
def span(name: str, cat: str = "query", **args):
    """Nested span on the current statement's tracer; no-op (None) when
    no statement scope is active.  Nesting rides a contextvar stack, so
    spans recorded on a copied context (devpipe producer) parent to the
    span that was live at copy time."""
    q = _CURRENT.get()
    if q is None:
        yield None
        return
    parent = _CURRENT_SPAN.get()
    s = q.tracer.begin(name, cat=cat,
                       parent=parent.sid if parent else None,
                       args=args or None)
    tok = _CURRENT_SPAN.set(s)
    try:
        yield s
    finally:
        _CURRENT_SPAN.reset(tok)
        q.tracer.end(s)

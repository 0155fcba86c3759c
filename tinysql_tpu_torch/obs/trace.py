"""Lightweight nested span tracer with Chrome trace-event export.

One ``Tracer`` per statement (owned by its ``QueryObs``).  Spans are
recorded as *complete* events — name, category, start, duration, thread
id, span id, parent id — cheap enough to leave always-on: a statement
records a handful of lifecycle spans (parse → plan → place → execute)
plus one span per program dispatch / D2H drain / compile-cache miss /
pipeline stage block.

Cross-thread parenting: the devpipe producer thread runs inside a
``contextvars`` copy of the creator's context, so a ``stage`` span's
parent is whatever span was live when the pipeline was constructed (the
operator's ``next()`` frame), even though it executes on another thread.
Chrome's viewer lanes by ``tid``; our own JSON keeps explicit ``parent``
ids so tests (and tools/trace2json.py) can verify the nesting.

A process-global ring buffer keeps the last N query traces for the
status server's ``/debug/trace`` endpoint (``TINYSQL_TRACE_RING`` caps
N, default 32).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

_ids = itertools.count(1)


class Span:
    __slots__ = ("sid", "name", "cat", "start_s", "dur_s", "tid",
                 "tname", "parent", "args")

    def __init__(self, name: str, cat: str, parent: Optional[int],
                 args: Optional[dict] = None):
        self.sid = next(_ids)
        self.name = name
        self.cat = cat
        self.start_s = time.perf_counter()
        self.dur_s = 0.0
        self.tid = threading.get_ident()
        # the recording thread's NAME rides along so TRACE <stmt> and
        # offline tooling can classify the span by serving role
        # (obs/conprof.classify) without a live thread table
        self.tname = threading.current_thread().name
        self.parent = parent
        self.args = args or {}

    def to_dict(self) -> dict:
        return {"id": self.sid, "name": self.name, "cat": self.cat,
                "ts_us": round(self.start_s * 1e6, 1),
                "dur_us": round(self.dur_s * 1e6, 1),
                "tid": self.tid, "thread": self.tname,
                "parent": self.parent, "args": self.args}


class Tracer:
    """Span sink for one statement.  Append-only under a lock — the
    devpipe producer thread and the consumer record concurrently."""

    def __init__(self):
        self._mu = threading.Lock()
        self._spans: List[Span] = []

    def begin(self, name: str, cat: str = "query",
              parent: Optional[int] = None,
              args: Optional[dict] = None) -> Span:
        return Span(name, cat, parent, args)

    def end(self, span: Span) -> None:
        span.dur_s = time.perf_counter() - span.start_s
        with self._mu:
            self._spans.append(span)

    def add_complete(self, name: str, start_s: float, dur_s: float,
                     cat: str = "query", parent: Optional[int] = None,
                     args: Optional[dict] = None) -> Span:
        """Record an already-measured interval (e.g. the batch parse wall
        measured before the statement scope existed)."""
        s = Span(name, cat, parent, args)
        s.start_s = start_s
        s.dur_s = dur_s
        with self._mu:
            self._spans.append(s)
        return s

    def spans(self) -> List[dict]:
        with self._mu:
            return [s.to_dict() for s in self._spans]

    def chrome_trace(self, pid: int = 0,
                     label: str = "") -> Dict[str, list]:
        """chrome://tracing / Perfetto ``traceEvents`` JSON (via the
        shared ``spans_to_events`` converter)."""
        out = {"traceEvents": spans_to_events(self.spans(), pid=pid)}
        if label:
            out["otherData"] = {"query": label}
        return out


def spans_to_events(spans: List[dict], pid: int = 0,
                    label: str = "") -> List[dict]:
    """THE span-dict -> Chrome-trace-event conversion, shared by
    ``Tracer.chrome_trace`` and tools/trace2json.py so the two export
    surfaces cannot drift.  Spans become phase-``X`` complete events;
    thread lanes come from the recording thread's ident; ``label``
    (when given) names the process track."""
    events: List[dict] = []
    tids: Dict[int, int] = {}
    for sp in spans:
        tids.setdefault(sp.get("tid", 0), len(tids))
    if label:
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": label}})
    for tid, lane in tids.items():
        events.append({"ph": "M", "pid": pid, "tid": lane,
                       "name": "thread_name",
                       "args": {"name": ("main" if lane == 0
                                         else f"stage-{lane}")}})
    for sp in spans:
        events.append({
            "ph": "X", "pid": pid, "tid": tids[sp.get("tid", 0)],
            "name": sp.get("name", "?"), "cat": sp.get("cat", "query"),
            "ts": sp.get("ts_us", 0.0), "dur": sp.get("dur_us", 0.0),
            "args": dict(sp.get("args") or {}, span_id=sp.get("id"),
                         parent=sp.get("parent")),
        })
    return events


# ---- TRACE <stmt> rendering -----------------------------------------------

#: TRACE <stmt> result columns (session/_exec_trace)
TRACE_COLUMNS = ("span", "parent", "start_offset_us", "duration_us",
                 "thread_role")


def trace_rows(spans: List[dict]) -> List[list]:
    """Render recorded span dicts as the ``TRACE <stmt>`` resultset:
    depth-indented span name (tree order: children by start time under
    their parent), parent span name, start offset relative to the
    earliest span (µs), duration (µs), and the recording thread's
    serving role (obs/conprof.classify over the captured thread name —
    a devpipe stage span reads ``devpipe`` even though it parents into
    the statement's chain)."""
    from .conprof import classify
    if not spans:
        return []
    by_id = {sp["id"]: sp for sp in spans}
    children: Dict[Optional[int], List[dict]] = {}
    for sp in spans:
        parent = sp.get("parent")
        if parent is not None and parent not in by_id:
            parent = None  # parent never ended (e.g. the outer execute)
        children.setdefault(parent, []).append(sp)
    for sibs in children.values():
        sibs.sort(key=lambda s: s.get("ts_us", 0.0))
    t0 = min(sp.get("ts_us", 0.0) for sp in spans)
    out: List[list] = []

    def render(sp: dict, depth: int) -> None:
        parent = by_id.get(sp.get("parent"))
        pname = ""
        if parent is not None:
            pname = str(parent.get("name", ""))
        out.append(["  " * depth + str(sp.get("name", "?")),
                    pname,
                    round(sp.get("ts_us", 0.0) - t0, 1),
                    round(sp.get("dur_us", 0.0), 1),
                    classify(str(sp.get("thread", "")))])
        for child in children.get(sp["id"], []):
            render(child, depth + 1)

    for root in children.get(None, []):
        render(root, 0)
    return out


# ---- process-global ring of recent query traces (/debug/trace) ----------

def _ring_cap() -> int:
    try:
        return max(1, int(os.environ.get("TINYSQL_TRACE_RING", "32")))
    except ValueError:
        return 32


_ring_mu = threading.Lock()
_RING: deque = deque(maxlen=_ring_cap())


def publish_trace(entry: dict) -> None:
    """Append one finished statement's trace record:
    ``{"sql", "ts", "total_ms", "spans", "chrome"}``."""
    with _ring_mu:
        _RING.append(entry)


def recent_traces(n: Optional[int] = None) -> List[dict]:
    with _ring_mu:
        out = list(_RING)
    return out[-n:] if n else out


def clear_traces() -> None:
    with _ring_mu:
        _RING.clear()

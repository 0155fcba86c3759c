"""Executor-tree instrumentation: collect per-operator RuntimeStats via
the Open/Next/Close interface.

``instrument_tree`` walks an executor tree (the ``children`` lists) and
wraps each node's ``open``/``next``/``close`` *instance* methods with
timing + row-count closures.  No executor class changes: the wrappers
shadow the class methods per instance, so internal calls like
``Executor.drain`` (``self.next()``) and parent→child pulls hit the
instrumented path.

Attribution model:

- ``act_rows`` / ``loops`` — rows emitted by / calls into ``next()``.
- ``wall_s`` — INCLUSIVE time in ``next()`` (children included), the
  reference's EXPLAIN ANALYZE `time` semantics.
- device counters — while an operator's ``next()`` frame runs, it is
  pushed as the *current op* (a contextvar), and every
  ``kernels.stats_add`` lands on the innermost live operator: the one
  actually dispatching programs / pulling D2H.  Device work done by a
  devpipe producer thread attributes to the operator that created the
  pipeline (BlockPipeline copies the creator's context).

DevPipeExec builds its per-operator fallback tree lazily inside
``open``/``next``; it checks for the ``_obs_qobs`` attribute this module
plants and instruments the fallback tree with the same scope, so a
pipeline bail-out still yields per-operator stats.
"""
from __future__ import annotations

import time
from typing import Optional

from .context import QueryObs, pop_op, push_op


def _plan_of(ex):
    """The physical plan node an executor was built from (tagged by
    executor builders as ``_obs_plan``; TPU/CPU executors that keep a
    ``plan`` attribute work untagged)."""
    p = getattr(ex, "_obs_plan", None)
    if p is None:
        p = getattr(ex, "plan", None)
    return p if p is not None else ex


def _label(ex, plan) -> str:
    op = getattr(plan, "op_name", None)
    if callable(op):
        try:
            name = op()
        except Exception:
            name = type(ex).__name__
    else:
        name = type(ex).__name__
    if getattr(plan, "use_tpu", False):
        name += "(TPU)"
    return name


def instrument_node(ex, qobs: QueryObs) -> None:
    """Wrap one executor instance's open/next/close (idempotent)."""
    if getattr(ex, "_obs_wrapped", False):
        return
    ex._obs_wrapped = True
    ex._obs_qobs = qobs  # DevPipeExec fallback-tree hook
    plan = _plan_of(ex)
    if qobs.op_stats_for(plan) is not None:
        # a delegate pair shares one plan node (DevPipeExec and the root
        # of its per-operator fallback tree): the outer wrapper already
        # counts every chunk the inner one emits — wrapping both would
        # double actRows/loops/wall
        return
    st = qobs.op_stats(plan, _label(ex, plan))
    orig_open, orig_next, orig_close = ex.open, ex.next, ex.close

    def open_(ctx):
        t0 = time.perf_counter()
        tok = push_op(st)
        try:
            return orig_open(ctx)
        finally:
            pop_op(tok)
            st.open_s += time.perf_counter() - t0

    def next_():
        t0 = time.perf_counter()
        tok = push_op(st)
        try:
            chk = orig_next()
        finally:
            pop_op(tok)
            st.wall_s += time.perf_counter() - t0
        st.loops += 1
        if chk is not None:
            st.act_rows += chk.num_rows()
        return chk

    def close_():
        tok = push_op(st)
        try:
            return orig_close()
        finally:
            pop_op(tok)

    ex.open = open_
    ex.next = next_
    ex.close = close_


def instrument_tree(root, qobs: Optional[QueryObs]) -> None:
    """Instrument every node reachable through ``children`` (and the
    devpipe fallback tree, when one already exists)."""
    if qobs is None or root is None:
        return
    stack = [root]
    seen = set()
    while stack:
        ex = stack.pop()
        if id(ex) in seen:
            continue
        seen.add(id(ex))
        instrument_node(ex, qobs)
        stack.extend(getattr(ex, "children", ()) or ())
        fb = getattr(ex, "_fallback", None)
        if fb is not None:
            stack.append(fb)

"""Bucket-estimate hook for AOT prewarming (tools/warm.py).

Every device kernel pads its inputs to a power-of-two bucket
(ops/kernels.bucket), so the set of buckets a plan will touch is
derivable BEFORE execution from the planner's cardinality estimates:
each physical node's ``stats_row_count`` (ANALYZE stats through
derive_stats — the reference's task.go GetCost inputs) maps to the
bucket its kernels will compile for, plus the next bucket up as
headroom for stats drift (inserts growing a table past the boundary
must not pay a cold compile on the first query that sees them).

Estimates drift; measurements don't.  ``merge_feedback`` folds a
per-query RuntimeStats feedback file (obs/feedback.py JSONL, written
when ``TINYSQL_STATS_FEEDBACK`` is set; consumed by ``tools/warm.py
--from-stats``) into the prewarm set, so buckets that OBSERVED operator
cardinalities hit — but the estimates missed — also compile ahead of
time.
"""
from __future__ import annotations

import json
from typing import Optional, Set


def buckets_for_rows(rows: int) -> Set[int]:
    """THE bucket-plus-growth-headroom policy, shared by the estimate
    path (below), the feedback writer (obs/feedback.py) and the feedback
    reader (merge_feedback): the bucket ``rows`` pads to, plus the next
    bucket up so drift past the boundary never pays a cold compile."""
    if rows <= 0:
        return set()
    from ..ops.kernels import bucket
    nb = bucket(rows)
    return {nb, nb * 2}


def bucket_estimates(plan, session_vars=None) -> Set[int]:
    """Power-of-two buckets a placed physical plan is expected to hit,
    from per-node cardinality estimates (plus one growth bucket each).
    When ``session_vars`` carries a block budget (tidb_device_block_rows)
    the block bucket joins the set — block-wise streaming pads every
    block to it."""
    from ..ops.kernels import bucket
    out: Set[int] = set()

    def walk(p) -> None:
        est = int(max(getattr(p, "stats_row_count", 0.0) or 0.0, 0))
        out.update(buckets_for_rows(est))
        scan = getattr(p, "scan", None)
        if scan is not None:  # TableReader wraps its scan out-of-tree
            walk(scan)
        for c in getattr(p, "children", []):
            walk(c)

    walk(plan)
    budget = _block_budget(session_vars)
    if budget > 0:
        out.add(bucket(budget))
    return out


def merge_feedback(path: str, into: Optional[Set[int]] = None) -> Set[int]:
    """Union the buckets recorded in a RuntimeStats feedback JSONL file
    (obs/feedback.py records: ``{"plan_digest", "buckets", "operators"}``
    — records also carrying only ``operators``/``act_rows`` are
    re-bucketed here) into ``into``.  Unreadable files or lines are
    skipped: feedback is advisory, never load-bearing."""
    out: Set[int] = into if into is not None else set()
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        bl = rec.get("buckets", [])
        for b in (bl if isinstance(bl, list) else []):
            try:
                out.add(int(b))
            except (TypeError, ValueError):
                continue
        ops = rec.get("operators", [])
        for op in (ops if isinstance(ops, list) else []):
            try:
                rows = int(op.get("act_rows", 0) or 0)
            except (TypeError, ValueError, AttributeError):
                continue
            out.update(buckets_for_rows(rows))
    return out


def _block_budget(session_vars) -> int:
    if not session_vars:
        return 0
    try:
        return int(session_vars.get("tidb_device_block_rows", 0) or 0)
    except Exception:
        return 0

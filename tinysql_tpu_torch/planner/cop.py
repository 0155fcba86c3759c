"""Coprocessor pushdown pass (reference: planner/core/task.go — the
copTask/rootTask boundary.  finishCopTask :273 decides what crosses from
storage-side execution to root; here the pass runs bottom-up over the
built physical tree, after the device enforcer).

- HashAgg over a TableReader (not TPU-placed): split into PARTIAL1 in the
  coprocessor + FINAL at root (reference: attach2Task for aggregation;
  the aggregation/descriptor.go Split schema).
- TopN / Limit over a TableReader: copy into the cop request as a
  per-region pre-cut; the root operator still merges (task.go:392-452).
"""
from __future__ import annotations

from typing import List

from ..distsql.exprpb import _ft_to_pb, can_push, expr_to_pb
from ..expression import Column, Schema
from ..expression.aggregation import (AGG_AVG, AGG_COUNT, AGG_FIRST_ROW,
                                      AGG_MAX, AGG_MIN, AGG_SUM, AggMode)
from .physical import (PhysicalHashAgg, PhysicalLimit, PhysicalPlan,
                       PhysicalProjection, PhysicalTableReader, PhysicalTopN)

_PUSHABLE_AGGS = {AGG_COUNT, AGG_SUM, AGG_AVG, AGG_MAX, AGG_MIN,
                  AGG_FIRST_ROW}


def push_to_cop(p: PhysicalPlan) -> PhysicalPlan:
    p.children = [push_to_cop(c) for c in p.children]
    if isinstance(p, PhysicalHashAgg) and not getattr(p, "use_tpu", False):
        child = p.children[0] if p.children else None
        if (isinstance(child, PhysicalTableReader)
                and child.scan.pushed_agg is None):
            _try_push_agg(p, child)
    elif isinstance(p, PhysicalTopN):
        child = p.children[0] if p.children else None
        if (isinstance(child, PhysicalTableReader)
                and child.scan.pushed_agg is None
                and child.scan.pushed_topn is None
                and all(can_push(e) for e in child.scan.filters)
                and all(can_push(e) for e, _ in p.by)):
            child.scan.pushed_topn = {
                "by": [(expr_to_pb(e), d) for e, d in p.by],
                "n": p.offset + p.count,
            }
    elif isinstance(p, PhysicalLimit):
        # limit is expression-free: it pre-cuts through any row-preserving
        # 1:1 operator chain (projections) down to the reader
        child = p.children[0] if p.children else None
        while isinstance(child, PhysicalProjection):
            child = child.children[0]
        if (isinstance(child, PhysicalTableReader)
                and child.scan.pushed_agg is None
                and child.scan.pushed_topn is None
                and all(can_push(e) for e in child.scan.filters)):
            child.scan.pushed_limit = p.offset + p.count
    return p


def _try_push_agg(agg: PhysicalHashAgg, reader: PhysicalTableReader) -> bool:
    if not all(can_push(e) for e in reader.scan.filters):
        return False  # unfiltered partials would aggregate wrong rows
    if not all(can_push(e) for e in agg.group_by):
        return False
    for d in agg.aggs:
        if d.name not in _PUSHABLE_AGGS or d.distinct:
            return False
        if not all(can_push(a) for a in d.args):
            return False

    # partial output layout: [gb cols..., per-desc partial slots...]
    n_gb = len(agg.group_by)
    partial_pbs: List[dict] = []
    final_descs = []
    out_cols: List[Column] = [
        Column(e.ret_type, index=i) for i, e in enumerate(agg.group_by)]
    base = n_gb
    for d in agg.aggs:
        pr_types = d.partial_result_types()
        ordinals = list(range(base, base + len(pr_types)))
        partials, final = d.split(ordinals)
        for pd in partials:
            partial_pbs.append({
                "name": pd.name,
                "args": [expr_to_pb(a) for a in pd.args],
                "distinct": pd.distinct,
                "ret": _ft_to_pb(pd.ret_type),
            })
        for ft, o in zip(pr_types, ordinals):
            out_cols.append(Column(ft, index=o))
        final_descs.append(final)
        base += len(pr_types)

    reader.scan.pushed_agg = {
        "group_by": [expr_to_pb(e) for e in agg.group_by],
        "aggs": partial_pbs,
    }
    # the reader now emits partial rows
    reader.schema = Schema(list(out_cols))
    reader.stats_row_count = max(agg.stats_row_count, 1.0)

    # rewire the root agg to FINAL mode over the partial rows
    agg.group_by = [Column(e.ret_type, index=i)
                    for i, e in enumerate(agg.group_by)]
    agg.aggs = final_descs
    return True

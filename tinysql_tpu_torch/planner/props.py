"""Order properties for the physical search (reference:
planner/property/physical_property.go:31 — required sort order threaded
through findBestTask — and cascades/enforcer_rules.go: a Sort enforcer is
added only when the child cannot PROVIDE the required order).

Reduced shape: a property is a list of (column unique_id, desc) pairs.
Readers provide ascending clustered-pk / index-column order (the scan
layer iterates the ordered keyspace; region scatter-gather preserves
range order); Sort/TopN provide their by-order; row-filtering operators
pass their child's order through.  `satisfies` = required is a prefix of
provided.  Consumers: Sort elimination + TopN->Limit in to_physical,
the merge-join child gate, and the order-aware access-path choice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..expression import Column, Expression
from .physical import (PhysicalIndexReader, PhysicalLimit, PhysicalMergeJoin,
                       PhysicalPlan, PhysicalProjection, PhysicalSelection,
                       PhysicalSort, PhysicalTableReader, PhysicalTopN)

OrderProp = List[Tuple[int, bool]]  # (column unique_id, desc)


def required_of(by: List[Tuple[Expression, bool]]) -> Optional[OrderProp]:
    """Sort items -> property; None when any key is a non-Column
    expression (computed keys are never provided by storage order)."""
    out: OrderProp = []
    for e, desc in by:
        if not isinstance(e, Column):
            return None
        out.append((e.unique_id, bool(desc)))
    return out


def provided_order(p: PhysicalPlan) -> OrderProp:
    """The order `p` emits (empty = none guaranteed)."""
    if isinstance(p, PhysicalTableReader):
        uid = getattr(p.scan, "order_col_uid", None)
        return [(uid, False)] if uid is not None else []
    if isinstance(p, PhysicalIndexReader):
        uids = getattr(p.scan, "order_col_uids", None) or []
        return [(u, False) for u in uids]
    if isinstance(p, (PhysicalSort, PhysicalTopN)):
        req = required_of(p.by)
        return req or []
    if isinstance(p, PhysicalMergeJoin):
        # emits left-side key order ascending (sorted-stream merge)
        lk = p.left_keys
        if len(lk) == 1 and isinstance(lk[0], Column):
            return [(lk[0].unique_id, False)]
        return []
    if isinstance(p, (PhysicalSelection, PhysicalLimit)):
        return provided_order(p.children[0])
    if isinstance(p, PhysicalProjection):
        child = provided_order(p.children[0])
        # identity output columns keep their source order
        ident = {e.unique_id for e in p.exprs if isinstance(e, Column)}
        out = []
        for uid, desc in child:
            if uid not in ident:
                break  # order beyond a dropped column is meaningless
            out.append((uid, desc))
        return out
    return []


def mark_keep_order(p: PhysicalPlan) -> None:
    """Record that a consumer RELIES on this subtree's emitted order
    (EXPLAIN shows keep order:true on the reader, reference explain
    format); walks through row-order-preserving operators."""
    while isinstance(p, (PhysicalSelection, PhysicalProjection,
                         PhysicalLimit)):
        p = p.children[0]
    scan = getattr(p, "scan", None)
    if scan is not None:
        scan.keep_order = True


def satisfies(provided: OrderProp, required: Optional[OrderProp]) -> bool:
    if required is None:
        return False
    if not required:
        return True
    return provided[:len(required)] == required

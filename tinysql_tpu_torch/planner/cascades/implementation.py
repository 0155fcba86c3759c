"""Cascades implementation phase: PHYSICAL enumeration with per-(group,
required-order-property) cost winners and order enforcers.

Reference: planner/cascades/implementation_rules.go:1-431 (one
ImplementationRule per logical operand producing physical candidates),
enforcer_rules.go (OrderEnforcer adds a Sort when a group cannot provide
the required property natively), optimize.go:245 implGroup (memoized
per-group winners under a required property).

This phase makes cascades' physical choices INDEPENDENT of the System-R
tail: a join group carries both a hash and a merge candidate (the merge
one requiring key order from its children, possibly via enforcers), a
Sort group can be absorbed by an order-providing child, and the winner is
the min-cost candidate — so cascades can legitimately pick a different
physical plan than System-R's rule-based tail (e.g. hash join where the
merge gate would fire but keep-order scans cost more than the hash
build).  Physical nodes are built through the SAME construction helpers
as the System-R tail (optimizer.phys_*), so operator semantics can never
drift between frameworks.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

from ...expression import Column
from ..logical import (LogicalAggregation, LogicalDataSource, LogicalJoin,
                       LogicalLimit, LogicalPlan, LogicalProjection,
                       LogicalSelection, LogicalSort, LogicalTableDual,
                       LogicalTopN)
from ..physical import (PhysicalHashJoin, PhysicalIndexLookUpReader,
                        PhysicalIndexReader, PhysicalLimit,
                        PhysicalMergeJoin, PhysicalPlan, PhysicalSort,
                        PhysicalTableDual, PhysicalTableReader, PhysicalTopN)
from ..props import mark_keep_order, provided_order, required_of, satisfies
from .memo import Group, GroupExpr

# ---- cost factors (the task.go GetCost shapes, flattened) -----------------
# Scans: a keep-order scan walks regions sequentially (the scatter-gather
# concurrency of an unordered scan is lost — reference: copTask keepOrder
# costing), so providing order from storage is priced above a plain scan.
SCAN = 1.0
KEEP_ORDER_SCAN = 1.4
INDEX_SCAN = 1.1
LOOKUP = 3.0            # IndexLookUp double-read per row
HASH_BUILD = 2.0        # build-side per-row cost (hash table construction)
SORT_UNIT = 1.0         # per row x log2(rows) for an enforced sort
SEL_F = 0.2
PROJ_F = 0.1
JOIN_OUT_F = 0.1

Impl = Tuple[float, float, PhysicalPlan]  # (cost, est_rows, plan)


class NoImplementationRule(NotImplementedError):
    """Raised when a memo group's operator has no implementation rule —
    the ONLY signal on which find_best_plan may fall back to the shared
    System-R tail (a bare NotImplementedError from deeper code must
    propagate, not silently downgrade the framework)."""


def implement_group(group: Group, prop: tuple = ()) -> Impl:
    """Min-cost physical implementation of `group` whose output satisfies
    the required order `prop` ([(unique_id, desc)] tuple) — natively or
    through a Sort enforcer; memoized per (group, prop)."""
    key = tuple(prop)
    hit = group.impl.get(key)
    if hit is not None:
        return hit
    best: Optional[Impl] = None
    for ge in group.exprs:
        for cand in _implementations(ge, key):
            if best is None or cand[0] < best[0]:
                best = cand
    if key:
        # enforcer alternative (enforcer_rules.go): implement unordered,
        # sort on top — also the fallback when nothing provides the
        # order natively
        base = implement_group(group, ())
        enforced = _enforce_order(base, key, group)
        if enforced is not None and (best is None
                                     or enforced[0] < best[0]):
            best = enforced
    if best is None:
        # operator shape outside the implementation rules: the caller
        # (find_best_plan) falls back to the logical winner + shared tail
        raise NoImplementationRule(
            f"no implementation rule for {type(group.exprs[0].op).__name__}"
            if group.exprs else "empty group")
    group.impl[key] = best
    return best


def _enforce_order(base: Impl, prop: tuple, group: Group) -> Optional[Impl]:
    cost, rows, plan = base
    by = []
    for uid, desc in prop:
        idx = next((i for i, c in enumerate(plan.schema.columns)
                    if c.unique_id == uid), None)
        if idx is None:
            return None
        by.append((plan.schema.columns[idx].clone_with_index(idx),
                   bool(desc)))
    sort_cost = SORT_UNIT * rows * max(math.log2(max(rows, 2.0)), 1.0)
    return (cost + sort_cost, rows, PhysicalSort(by, plan))


def _reader_cost(plan: PhysicalPlan, rows: float, ordered: bool) -> float:
    if isinstance(plan, PhysicalIndexLookUpReader):
        return rows * LOOKUP
    if isinstance(plan, PhysicalIndexReader):
        return rows * INDEX_SCAN
    return rows * (KEEP_ORDER_SCAN if ordered else SCAN)


def _implementations(ge: GroupExpr, prop: tuple) -> Iterator[Impl]:
    """Physical candidates of one group expression whose output satisfies
    `prop` NATIVELY (the enforcer alternative is handled by the
    caller)."""
    from ..optimizer import (phys_aggregation, phys_datasource, phys_join,
                             phys_projection, phys_selection)
    op = ge.op
    want = list(prop)

    if isinstance(op, LogicalDataSource):
        plan = phys_datasource(op, order_hint=want or None)
        rows = max(getattr(plan, "stats_row_count", 1.0), 1.0)
        provided = provided_order(plan)
        if not prop:
            yield (_reader_cost(plan, rows, False), rows, plan)
        elif satisfies(provided, want):
            mark_keep_order(plan)
            yield (_reader_cost(plan, rows, True), rows, plan)
        return

    if isinstance(op, LogicalSelection):
        # row filters pass order through: push the requirement down
        ccost, crows, child = implement_group(ge.children[0], prop)
        rows = max(crows * 0.5, 1.0)
        yield (ccost + crows * SEL_F, rows, phys_selection(op, child))
        return

    if isinstance(op, LogicalProjection):
        ident = {e.unique_id for e in op.exprs if isinstance(e, Column)}
        if prop and not all(uid in ident for uid, _ in prop):
            return  # computed outputs: order cannot pass through
        ccost, crows, child = implement_group(ge.children[0], prop)
        yield (ccost + crows * PROJ_F, crows, phys_projection(op, child))
        return

    if isinstance(op, LogicalAggregation):
        if prop:
            return  # hash agg provides no order; enforcer covers it
        ccost, crows, child = implement_group(ge.children[0], ())
        out = max(math.sqrt(crows), 1.0) if op.group_by else 1.0
        yield (ccost + crows, out, phys_aggregation(op, child))
        return

    if isinstance(op, LogicalJoin):
        # hash join: unordered children, no provided order
        if not prop:
            lc, lr, lplan = implement_group(ge.children[0], ())
            rc, rr, rplan = implement_group(ge.children[1], ())
            out = max(lr, rr) if op.eq_conditions else lr * rr
            cost = lc + rc + lr + HASH_BUILD * rr + out * JOIN_OUT_F
            yield (cost, max(out, 1.0),
                   phys_join(op, lplan, rplan, PhysicalHashJoin))
        # merge join: key-ordered children (native or enforced inside),
        # emits left-key ascending order
        mk = _merge_keys(op)
        if mk is not None:
            (la, ra) = mk
            if satisfies([(la, False)], want) or not prop:
                lc, lr, lplan = implement_group(ge.children[0],
                                                ((la, False),))
                rc, rr, rplan = implement_group(ge.children[1],
                                                ((ra, False),))
                out = max(lr, rr)
                cost = lc + rc + lr + rr + out * JOIN_OUT_F
                yield (cost, max(out, 1.0),
                       phys_join(op, lplan, rplan, PhysicalMergeJoin))
        return

    if isinstance(op, LogicalSort):
        req = required_of(op.by)
        if req is not None and satisfies(req, want):
            # absorb the sort into an order-providing child (or an
            # enforcer inside it — cost decides); output IS the order
            yield implement_group(ge.children[0], tuple(req))
        elif not prop:
            ccost, crows, child = implement_group(ge.children[0], ())
            by = [(e.resolve_indices(child.schema), d) for e, d in op.by]
            sc = SORT_UNIT * crows * max(math.log2(max(crows, 2.0)), 1.0)
            yield (ccost + sc, crows, PhysicalSort(by, child))
        return

    if isinstance(op, LogicalTopN):
        n = float(op.offset + op.count)
        req = required_of(op.by)
        if req is not None and (satisfies(req, want) or not prop):
            # ordered child: TopN degenerates to Limit (cascades :800
            # TopN->index shape, via the property framework)
            ccost, crows, child = implement_group(ge.children[0],
                                                  tuple(req))
            yield (ccost + min(crows, n), min(crows, n),
                   PhysicalLimit(op.offset, op.count, child))
        if not prop:
            ccost, crows, child = implement_group(ge.children[0], ())
            by = [(e.resolve_indices(child.schema), d) for e, d in op.by]
            yield (ccost + crows, min(crows, n),
                   PhysicalTopN(by, op.offset, op.count, child))
        return

    if isinstance(op, LogicalLimit):
        # ONLY the empty property (reference ImplLimit): pushing a
        # required order BELOW a limit would change which rows survive
        # it — an ORDER BY above a LIMIT must sort the limit's output
        # (the enforcer), never reorder its input
        if prop:
            return
        ccost, crows, child = implement_group(ge.children[0], ())
        n = float(op.offset + op.count)
        yield (ccost, min(crows, n),
               PhysicalLimit(op.offset, op.count, child))
        return

    if isinstance(op, LogicalTableDual):
        if not prop:
            yield (1.0, float(op.row_count),
                   PhysicalTableDual(op.schema, op.row_count))
        return


def _merge_keys(op: LogicalJoin):
    """(left_uid, right_uid) when a merge join is admissible: single
    plain-column equi key, inner/left join (MergeJoinExec's surface)."""
    if op.tp not in ("inner", "left") or len(op.eq_conditions) != 1:
        return None
    a, b = op.eq_conditions[0]
    if not (isinstance(a, Column) and isinstance(b, Column)):
        return None
    return a.unique_id, b.unique_id

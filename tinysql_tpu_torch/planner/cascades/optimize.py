"""Cascades search driver (reference: planner/cascades/optimize.go —
exploration phase :131 to rule fixpoint, then implementation phase :245
picking cost winners per group).

Implementation winners are computed bottom-up over the memo with the same
cost shapes as the System-R task model (scan rows via the access-path
chooser, per-operator factors); the winning logical tree is then extracted
and converted through the shared physical tail (to_physical ->
place_devices -> push_to_cop), so device placement and coprocessor
pushdown behave identically across both optimizer frameworks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ..logical import (LogicalAggregation, LogicalDataSource, LogicalJoin,
                       LogicalLimit, LogicalPlan, LogicalProjection,
                       LogicalSelection, LogicalSort, LogicalTableDual,
                       LogicalTopN)
from .memo import Group, GroupExpr, Memo
from .rules import DEFAULT_RULES

MAX_EXPLORE_ROUNDS = 16


def explore(memo: Memo, group: Group) -> None:
    """Apply transformation rules to fixpoint (reference: onPhaseExploration
    optimize.go:131-190)."""
    for _ in range(MAX_EXPLORE_ROUNDS):
        if group.explored:
            return
        group.explored = True
        for ge in list(group.exprs):
            for child in ge.children:
                explore(memo, child)
            if ge.explored:
                continue
            ge.explored = True
            for rule in DEFAULT_RULES:
                for binding in rule.pattern.match_expr(ge):
                    if rule.on_transform(memo, group, binding):
                        group.explored = False
        if group.explored:
            return


# ---- implementation phase: cost winners per group -------------------------

def _ds_cost(ds: LogicalDataSource) -> Tuple[float, float]:
    """(cost, est_rows) for the best access path of a data source."""
    from ..access import choose_path
    stats = None
    storage = getattr(ds, "storage", None)
    if storage is not None:
        from ...statistics.table_stats import load_stats
        stats = load_stats(storage, ds.table_info.id)
    path = choose_path(ds, stats)
    return max(path.cost, 1.0), max(path.est_rows, 1.0)


def implement(group: Group) -> Tuple[float, float, LogicalPlan]:
    """Pick the min-cost expression in the group; returns
    (cost, est_rows, extracted logical tree) — memoized on the group
    (reference: implGroup optimize.go:245-300)."""
    if group.best is not None:
        return group.best
    best = None
    for ge in group.exprs:
        child_results = [implement(c) for c in ge.children]
        cost, rows = _expr_cost(ge, child_results)
        if best is None or cost < best[0]:
            tree = _shallow_copy(ge.op)
            tree.children = [r[2] for r in child_results]
            best = (cost, rows, tree)
    assert best is not None, "empty group"
    group.best = best
    return best


def _shallow_copy(op: LogicalPlan) -> LogicalPlan:
    import copy
    c = copy.copy(op)
    c.children = []
    return c


def _expr_cost(ge: GroupExpr, childs) -> Tuple[float, float]:
    op = ge.op
    ccost = sum(c[0] for c in childs)
    crows = childs[0][1] if childs else 1.0
    if isinstance(op, LogicalDataSource):
        return _ds_cost(op)
    if isinstance(op, LogicalSelection):
        return ccost + crows * 0.2, max(crows * 0.5, 1.0)
    if isinstance(op, LogicalProjection):
        return ccost + crows * 0.1, crows
    if isinstance(op, LogicalAggregation):
        out = max(math.sqrt(crows), 1.0) if op.group_by else 1.0
        return ccost + crows, out
    if isinstance(op, LogicalJoin):
        lrows, rrows = childs[0][1], childs[1][1]
        out = max(lrows, rrows) if op.eq_conditions else lrows * rrows
        return ccost + lrows + 2.0 * rrows + out * 0.1, max(out, 1.0)
    if isinstance(op, LogicalSort):
        return ccost + crows * max(math.log2(max(crows, 2.0)), 1.0), crows
    if isinstance(op, LogicalTopN):
        n = float(op.offset + op.count)
        return ccost + crows, min(crows, n)
    if isinstance(op, LogicalLimit):
        return ccost, min(crows, float(op.offset + op.count))
    if isinstance(op, LogicalTableDual):
        return 1.0, float(op.row_count)
    return ccost + crows, crows


def find_best_plan(logical: LogicalPlan, tpu: bool = True,
                   tpu_min_rows: float = 0.0, mesh_shards: int = 0):
    """Full cascades pipeline: pre-normalization -> memo -> explore ->
    implement -> shared physical tail (reference: Optimize/FindBestPlan
    optimize.go:105; the pre-passes mirror the System-R rewrites whose
    effects the transformation rule set does not replicate)."""
    from ..optimizer import normalize_logical, to_physical
    from ..derive_stats import derive_stats
    from ..device import place_devices
    from ..cop import push_to_cop
    logical = normalize_logical(logical, push_predicates=False)
    memo = Memo()
    root = memo.build(logical)
    explore(memo, root)
    try:
        # cascades' OWN implementation phase: physical candidates +
        # enforcers with per-group cost winners (implementation.py) — the
        # framework can pick different physical operators than System-R
        from .implementation import NoImplementationRule, implement_group
        phys = implement_group(root, ())[2]
    except NoImplementationRule:
        # operator shapes outside the implementation rules (mem-tables,
        # exotic ops): logical winner + the shared physical tail.
        # Genuine bugs in the implementation phase propagate — a silent
        # System-R downgrade would mask them.
        _, _, tree = implement(root)
        phys = to_physical(tree)
    phys = derive_stats(phys)
    phys = place_devices(phys, enabled=tpu, min_rows=tpu_min_rows,
                         mesh_shards=mesh_shards)
    return push_to_cop(phys)

"""Cascades transformation rules (reference:
planner/cascades/transformation_rules.go — the Transformation interface
with pattern + Match + OnTransform; the rule set mirrors the course's:
PushSelDownTableScan/Join/Projection/Aggregation, MergeAdjacentSelection,
PushTopNDownProjection, PushLimitDownProjection.

The reference's :497 stub (PushAggDownGather — partial aggregation through
the storage-gather boundary) and :800 stub (TopN onto index source) are
realized in this engine at the shared physical tail: planner/cop.py
push_to_cop splits aggregates into cop PARTIAL1 + root FINAL and pre-cuts
TopN per region, and planner/access.py compiles TopN-compatible index
ranges — both run on cascades output exactly as on the System-R path.
"""
from __future__ import annotations

import copy
from typing import List

from ...expression import Column, Expression
from ..logical import (JOIN_INNER, LogicalAggregation, LogicalDataSource,
                       LogicalJoin, LogicalLimit, LogicalPlan,
                       LogicalProjection, LogicalSelection, LogicalSort,
                       LogicalTopN)
from ..optimizer import substitute_column
from .memo import ANY, Group, GroupExpr, Memo, Pattern


def _mk_sel(conds, schema):
    s = LogicalSelection.__new__(LogicalSelection)
    LogicalPlan.__init__(s)
    s.conditions = conds
    s.schema = schema
    return s


def _mk_proj(exprs, schema):
    pr = LogicalProjection.__new__(LogicalProjection)
    LogicalPlan.__init__(pr)
    pr.exprs = exprs
    pr.schema = schema
    return pr


def _mk_topn(by, offset, count, schema):
    t = LogicalTopN.__new__(LogicalTopN)
    LogicalPlan.__init__(t)
    t.by = by
    t.offset = offset
    t.count = count
    t.schema = schema
    return t


def _mk_limit(offset, count, schema):
    t = LogicalLimit.__new__(LogicalLimit)
    LogicalPlan.__init__(t)
    t.offset = offset
    t.count = count
    t.schema = schema
    return t


class Transformation:
    pattern: Pattern = None

    def on_transform(self, memo: Memo, group: Group, binding) -> bool:
        """Insert equivalent expression(s) into `group`; returns True if
        the memo changed."""
        raise NotImplementedError


def _clone_ds(ds: LogicalDataSource) -> LogicalDataSource:
    c = LogicalDataSource(ds.db_name, ds.table_info, ds.alias,
                          list(ds.schema.columns))
    c.schema = ds.schema
    c.pushed_conds = list(ds.pushed_conds)
    c.all_conds = list(ds.all_conds)
    c.possible_indices = list(ds.possible_indices)
    if hasattr(ds, "storage"):
        c.storage = ds.storage
    return c


class PushSelDownDataSource(Transformation):
    """Selection(DataSource) => DataSource with merged pushed conds
    (reference: PushSelDownTableScan/TiKVSingleGather)."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalDataSource)])

    def on_transform(self, memo, group, binding):
        sel_ge, ds_ge = binding[0], binding[1][0]
        ds = _clone_ds(ds_ge.op)
        ds.pushed_conds.extend(sel_ge.op.conditions)
        ds.all_conds = list(ds.pushed_conds)
        return memo.insert_equivalent(group, ds, [])


class MergeAdjacentSelection(Transformation):
    """Selection(Selection(x)) => Selection(x) with merged CNF."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalSelection)])

    def on_transform(self, memo, group, binding):
        outer, inner = binding[0], binding[1][0]
        merged = _mk_sel(
            list(outer.op.conditions) + list(inner.op.conditions),
            group.schema)
        return memo.insert_equivalent(group, merged, list(inner.children))


class PushSelDownProjection(Transformation):
    """Selection(Projection(x)) => Projection(Selection(x)) for conditions
    expressible over the projection input."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalProjection)])

    def on_transform(self, memo, group, binding):
        sel_ge, proj_ge = binding[0], binding[1][0]
        proj = proj_ge.op
        pushable, retained = [], []
        for c in sel_ge.op.conditions:
            cols = c.collect_columns()
            if all(proj.schema.column_index(x) >= 0 for x in cols):
                pushable.append(substitute_column(c, proj.schema, proj.exprs))
            else:
                retained.append(c)
        if not pushable:
            return False
        child_group = proj_ge.children[0]
        new_sel = _mk_sel(pushable, child_group.schema)
        sel_group = Group(child_group.schema)
        sel_group.insert(GroupExpr(new_sel, [child_group]))
        new_proj = _mk_proj(list(proj.exprs), proj.schema)
        if retained:
            inner_proj_group = Group(proj.schema)
            inner_proj_group.insert(GroupExpr(new_proj, [sel_group]))
            top = _mk_sel(retained, group.schema)
            return memo.insert_equivalent(group, top, [inner_proj_group])
        return memo.insert_equivalent(group, new_proj, [sel_group])


class PushSelDownJoin(Transformation):
    """Selection(Join(l, r)) => Join' with side conditions pushed into new
    child selections (reference: PushSelDownJoin)."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalJoin)])

    def on_transform(self, memo, group, binding):
        from ..joinconds import classify_conjuncts
        sel_ge, join_ge = binding[0], binding[1][0]
        join: LogicalJoin = join_ge.op
        lgroup, rgroup = join_ge.children
        lsch, rsch = lgroup.schema, rgroup.schema
        new_eq, lp, rp, other, retained = classify_conjuncts(
            sel_ge.op.conditions, lsch, rsch, join.tp)
        new_join = copy.copy(join)
        new_join.eq_conditions = list(join.eq_conditions) + new_eq
        new_join.other_conditions = list(join.other_conditions) + other
        # inner join: the join's own one-side ON conditions push down WITH
        # the selection's.  Outer join: ON-clause outer-side conditions
        # must STAY on the join (they decide matching; a failing outer row
        # null-extends instead of being filtered) — only WHERE-side conds
        # (lp) push below the outer child.
        from ..logical import JOIN_INNER as _INNER
        if join.tp == _INNER:
            left_push = list(join.left_conditions) + lp
            new_join.left_conditions = []
        else:
            left_push = lp
            new_join.left_conditions = list(join.left_conditions)
        right_push = list(join.right_conditions) + rp
        new_join.right_conditions = []
        if not (left_push or right_push or new_eq):
            return False

        def wrap(child_group, conds):
            if not conds:
                return child_group
            s = _mk_sel(conds, child_group.schema)
            g = Group(child_group.schema)
            g.insert(GroupExpr(s, [child_group]))
            return g
        children = [wrap(lgroup, left_push), wrap(rgroup, right_push)]
        if retained:
            jg = Group(group.schema)
            jg.insert(GroupExpr(new_join, children))
            top = _mk_sel(retained, group.schema)
            return memo.insert_equivalent(group, top, [jg])
        return memo.insert_equivalent(group, new_join, children)


class PushSelDownAggregation(Transformation):
    """Selection(Agg(x)) => Agg(Selection(x)) for conditions over plain
    group-by columns (reference: PushSelDownAggregation)."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalAggregation)])

    def on_transform(self, memo, group, binding):
        sel_ge, agg_ge = binding[0], binding[1][0]
        agg: LogicalAggregation = agg_ge.op
        gb_uids = {c.unique_id for e in agg.group_by
                   for c in ([e] if isinstance(e, Column) else [])}
        push, retained = [], []
        for c in sel_ge.op.conditions:
            cols = c.collect_columns()
            if cols and all(x.unique_id in gb_uids for x in cols):
                push.append(c)
            else:
                retained.append(c)
        if not push:
            return False
        child_group = agg_ge.children[0]
        s = _mk_sel(push, child_group.schema)
        sg = Group(child_group.schema)
        sg.insert(GroupExpr(s, [child_group]))
        new_agg = copy.copy(agg)
        if retained:
            ag = Group(agg.schema)
            ag.insert(GroupExpr(new_agg, [sg]))
            top = _mk_sel(retained, group.schema)
            return memo.insert_equivalent(group, top, [ag])
        return memo.insert_equivalent(group, new_agg, [sg])


class PushTopNDownProjection(Transformation):
    """TopN(Projection(x)) => Projection(TopN(x)) when sort keys resolve
    below the projection (reference: PushTopNDownProjection)."""
    pattern = Pattern(LogicalTopN, [Pattern(LogicalProjection)])

    def on_transform(self, memo, group, binding):
        topn_ge, proj_ge = binding[0], binding[1][0]
        topn: LogicalTopN = topn_ge.op
        proj = proj_ge.op
        try:
            by = [(substitute_column(e, proj.schema, proj.exprs), d)
                  for e, d in topn.by]
        except Exception:
            return False
        child_group = proj_ge.children[0]
        inner = _mk_topn(by, topn.offset, topn.count, child_group.schema)
        tg = Group(child_group.schema)
        tg.insert(GroupExpr(inner, [child_group]))
        new_proj = _mk_proj(list(proj.exprs), proj.schema)
        return memo.insert_equivalent(group, new_proj, [tg])


class MergeLimitSortToTopN(Transformation):
    """Limit(Sort(x)) => TopN(x) (the System-R topn_pushdown analogue;
    makes per-region TopN pre-cut reachable from cascades plans)."""
    pattern = Pattern(LogicalLimit, [Pattern(LogicalSort)])

    def on_transform(self, memo, group, binding):
        lim_ge, sort_ge = binding[0], binding[1][0]
        lim: LogicalLimit = lim_ge.op
        topn = _mk_topn(list(sort_ge.op.by), lim.offset, lim.count,
                        group.schema)
        return memo.insert_equivalent(group, topn, list(sort_ge.children))


class PushLimitDownProjection(Transformation):
    """Limit(Projection(x)) => Projection(Limit(x))."""
    pattern = Pattern(LogicalLimit, [Pattern(LogicalProjection)])

    def on_transform(self, memo, group, binding):
        lim_ge, proj_ge = binding[0], binding[1][0]
        lim: LogicalLimit = lim_ge.op
        proj = proj_ge.op
        child_group = proj_ge.children[0]
        inner = _mk_limit(lim.offset, lim.count, child_group.schema)
        lg = Group(child_group.schema)
        lg.insert(GroupExpr(inner, [child_group]))
        new_proj = _mk_proj(list(proj.exprs), proj.schema)
        return memo.insert_equivalent(group, new_proj, [lg])


class PushSelDownSort(Transformation):
    """Selection(Sort(x)) => Sort(Selection(x)) — filtering before the
    sort is never worse (reference: PushSelDownSort
    transformation_rules.go:388)."""
    pattern = Pattern(LogicalSelection, [Pattern(LogicalSort)])

    def on_transform(self, memo, group, binding):
        sel_ge, sort_ge = binding[0], binding[1][0]
        child_group = sort_ge.children[0]
        s = _mk_sel(list(sel_ge.op.conditions), child_group.schema)
        sg = Group(child_group.schema)
        sg.insert(GroupExpr(s, [child_group]))
        new_sort = copy.copy(sort_ge.op)
        return memo.insert_equivalent(group, new_sort, [sg])


class EliminateProjection(Transformation):
    """Projection that is a 1:1 column passthrough of its child's schema
    merges the child group's expressions into its own (reference:
    EliminateProjection transformation_rules.go:623)."""
    # no child pattern: one binding per projection expression (the child
    # group is rescanned wholesale anyway)
    pattern = Pattern(LogicalProjection)

    def on_transform(self, memo, group, binding):
        proj_ge = binding[0]
        proj: LogicalProjection = proj_ge.op
        if not proj_ge.children:
            return False
        child_group = proj_ge.children[0]
        csch = child_group.schema.columns
        if len(proj.exprs) != len(csch):
            return False
        for e, oc, c in zip(proj.exprs, proj.schema.columns, csch):
            if not isinstance(e, Column) or e.unique_id != c.unique_id:
                return False
            if oc.unique_id != c.unique_id:
                return False  # renaming projection: parents reference
                # the NEW unique id — eliminating it would orphan them
        changed = False
        for cge in list(child_group.exprs):
            changed |= memo.insert_equivalent(group, cge.op,
                                              list(cge.children))
        return changed


class MergeAdjacentProjection(Transformation):
    """Projection(Projection(x)) => one Projection with the outer exprs
    substituted through the inner (reference: MergeAdjacentProjection
    transformation_rules.go:663)."""
    pattern = Pattern(LogicalProjection, [Pattern(LogicalProjection)])

    def on_transform(self, memo, group, binding):
        outer_ge, inner_ge = binding[0], binding[1][0]
        outer, inner = outer_ge.op, inner_ge.op
        # explicit resolvability check: substitute_column passes unknown
        # columns through unchanged, which would silently emit a merged
        # node referencing columns the new child does not produce
        for e in outer.exprs:
            if any(inner.schema.column_index(c) < 0
                   for c in e.collect_columns()):
                return False
        exprs = [substitute_column(e, inner.schema, inner.exprs)
                 for e in outer.exprs]
        merged = _mk_proj(exprs, outer.schema)
        return memo.insert_equivalent(group, merged,
                                      list(inner_ge.children))


class MergeAggregationProjection(Transformation):
    """Aggregation(Projection(x)) => Aggregation'(x) with group-by and
    argument expressions substituted through the projection (reference:
    MergeAggregationProjection transformation_rules.go:778 — a course
    stub there; realized per its header contract)."""
    pattern = Pattern(LogicalAggregation, [Pattern(LogicalProjection)])

    def on_transform(self, memo, group, binding):
        agg_ge, proj_ge = binding[0], binding[1][0]
        agg: LogicalAggregation = agg_ge.op
        proj = proj_ge.op
        for e in list(agg.group_by) + [a for d in agg.agg_funcs
                                       for a in d.args]:
            if any(proj.schema.column_index(c) < 0
                   for c in e.collect_columns()):
                return False
        gb = [substitute_column(e, proj.schema, proj.exprs)
              for e in agg.group_by]
        funcs = []
        for d in agg.agg_funcs:
            d2 = d.clone()
            d2.args = [substitute_column(a, proj.schema, proj.exprs)
                       for a in d.args]
            funcs.append(d2)
        new_agg = copy.copy(agg)
        new_agg.group_by = gb
        new_agg.agg_funcs = funcs
        return memo.insert_equivalent(group, new_agg,
                                      list(proj_ge.children))


class PushTopNDownOuterJoin(Transformation):
    """TopN(LeftJoin(l, r)) with every sort key from the OUTER side =>
    also TopN the left child (limit offset+count, offset 0): the join
    preserves every outer row, so the global top-(o+c) is within the
    outer top-(o+c) (the System-R topn_pushdown's join arm, reachable
    from cascades plans; reference TiDB PushTopNDownOuterJoin)."""
    pattern = Pattern(LogicalTopN, [Pattern(LogicalJoin)])

    def on_transform(self, memo, group, binding):
        from ..logical import JOIN_LEFT
        topn_ge, join_ge = binding[0], binding[1][0]
        topn: LogicalTopN = topn_ge.op
        join: LogicalJoin = join_ge.op
        if join.tp != JOIN_LEFT:
            return False
        lgroup, rgroup = join_ge.children
        lsch = lgroup.schema
        for e, _ in topn.by:
            cols = e.collect_columns()
            if not cols or not all(lsch.column_index(c) >= 0
                                   for c in cols):
                return False
        inner = _mk_topn(list(topn.by), 0, topn.offset + topn.count, lsch)
        lg = Group(lsch)
        lg.insert(GroupExpr(inner, [lgroup]))
        new_join = copy.copy(join)
        jg = Group(group.schema)
        jg.insert(GroupExpr(new_join, [lg, rgroup]))
        top = _mk_topn(list(topn.by), topn.offset, topn.count,
                       group.schema)
        return memo.insert_equivalent(group, top, [jg])


DEFAULT_RULES = [
    MergeLimitSortToTopN(),
    MergeAdjacentSelection(),
    PushSelDownDataSource(),
    PushSelDownProjection(),
    PushSelDownSort(),
    PushSelDownJoin(),
    PushSelDownAggregation(),
    PushTopNDownProjection(),
    PushTopNDownOuterJoin(),
    PushLimitDownProjection(),
    EliminateProjection(),
    MergeAdjacentProjection(),
    MergeAggregationProjection(),
]

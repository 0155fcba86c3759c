"""Subquery decorrelation: expression subqueries -> join operators.

Capability parity with reference planner/core/expression_rewriter.go's
subquery handling (PatternInExpr / ExistsSubqueryExpr -> LogicalJoin semi
variants) plus the decorrelation slice of rule_decorrelate.go, reduced to
the shapes this grammar produces:

- ``expr IN (SELECT c FROM ...)`` as a top-level WHERE conjunct becomes a
  SEMI join on ``expr = c``; ``NOT IN`` becomes a NULL-AWARE ANTI join
  (three-valued logic: any NULL build key kills every probe row, a NULL
  probe key passes only an empty build side).
- ``[NOT] EXISTS (SELECT ...)`` becomes a SEMI/ANTI join.  Correlated
  equality conjuncts in the subquery's WHERE (``inner.x = outer.y``) are
  pulled up as the join's equi-keys; other correlated conjuncts become
  join ``other_conditions``; fully-local conjuncts stay inside the
  subquery.  An uncorrelated EXISTS degenerates to a cartesian semi join
  (the executor only checks build-side emptiness).
- A scalar subquery anywhere in an expression is evaluated EAGERLY at
  plan time and folded to a Constant — the reference evaluates
  uncorrelated scalar subqueries during optimization the same way, and
  the literal parameterization erases the folded constant from
  program cache keys, so a changed subquery result is still a compiled
  program HIT.

The pass runs INSIDE PlanBuilder.build_select, before the residual WHERE
becomes a LogicalSelection, so everything downstream (pushdown, pruning,
reorder, the device enforcer) sees plain logical join nodes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..expression import Column, Expression, fold_constants, split_cnf
from ..parser import ast
from .logical import (JOIN_ANTI, JOIN_SEMI, LogicalJoin, LogicalPlan,
                      LogicalSelection, LogicalTableDual)


def split_and_conjuncts(e: ast.ExprNode) -> List[ast.ExprNode]:
    """Top-level AND split of a WHERE tree (parens transparent)."""
    if isinstance(e, ast.ParenExpr):
        return split_and_conjuncts(e.expr)
    if isinstance(e, ast.BinaryOp) and e.op == "and":
        return split_and_conjuncts(e.left) + split_and_conjuncts(e.right)
    return [e]


def _unwrap_not(e: ast.ExprNode) -> Tuple[ast.ExprNode, bool]:
    """Strip ParenExpr and count NOT wrappers -> (inner, negated)."""
    neg = False
    while True:
        if isinstance(e, ast.ParenExpr):
            e = e.expr
        elif isinstance(e, ast.UnaryOp) and e.op == "not":
            e = e.operand
            neg = not neg
        else:
            return e, neg


def _subquery_conjunct(e: ast.ExprNode):
    """(kind, node, negated) when `e` is a decorrelatable conjunct —
    kind 'in' (InExpr over a SubqueryExpr) or 'exists' — else None."""
    inner, neg = _unwrap_not(e)
    if isinstance(inner, ast.InExpr) and len(inner.items) == 1 \
            and isinstance(inner.items[0], ast.SubqueryExpr):
        return "in", inner, neg ^ inner.negated
    if isinstance(inner, ast.ExistsExpr):
        return "exists", inner, neg ^ inner.negated
    return None


def apply_where_subqueries(builder, p: LogicalPlan,
                           where: ast.ExprNode
                           ) -> Tuple[LogicalPlan, List[ast.ExprNode]]:
    """Rewrite every subquery-bearing top-level conjunct of `where` into
    a semi/anti join over `p`; returns (new plan, residual AST
    conjuncts).  Scalar subqueries inside residual conjuncts are handled
    later by the expression rewriter (eager evaluation)."""
    residual: List[ast.ExprNode] = []
    for conj in split_and_conjuncts(where):
        got = _subquery_conjunct(conj)
        if got is None:
            residual.append(conj)
            continue
        kind, node, negated = got
        if kind == "in":
            p = build_in_join(builder, p, node, negated)
        else:
            p = build_exists_join(builder, p, node, negated)
    return p, residual


def build_in_join(builder, p: LogicalPlan, ie: ast.InExpr,
                  negated: bool) -> LogicalJoin:
    """``expr [NOT] IN (SELECT c ...)`` -> semi / null-aware anti join.
    The subquery builds as a normal SELECT (aggregation, HAVING, its own
    subqueries all compose); it must produce exactly one column."""
    from .builder import ExprRewriter, PlanError
    sub = builder.build_select(ie.items[0].select)
    if len(sub.schema.columns) != 1:
        raise PlanError("Operand should contain 1 column(s)")
    rw = ExprRewriter(p.schema, builder)
    outer = fold_constants(rw.rewrite(ie.expr))
    join = LogicalJoin(JOIN_ANTI if negated else JOIN_SEMI, p, sub)
    join.eq_conditions.append((outer, sub.schema.columns[0]))
    # NOT IN is null-aware; NOT EXISTS (below) is not — a NULL correlated
    # key simply never matches there
    join.null_aware = negated
    return join


def build_exists_join(builder, p: LogicalPlan, ex: ast.ExistsExpr,
                      negated: bool) -> LogicalJoin:
    """``[NOT] EXISTS (SELECT ...)`` -> semi / anti join, decorrelating
    equality conjuncts that reference the outer scope."""
    from .builder import ExprRewriter, PlanError
    stmt = ex.select
    tp = JOIN_ANTI if negated else JOIN_SEMI
    if stmt.limit is not None and stmt.limit[1] == 0:
        # LIMIT 0: the subquery is empty by construction
        return LogicalJoin(tp, p, LogicalTableDual(row_count=0))
    if stmt.group_by or stmt.having or stmt.distinct or _has_aggs(stmt):
        # aggregate-shaped EXISTS: build the full subquery plan and use
        # it as an (uncorrelated) cartesian build side.  A correlated
        # column inside would fail name resolution — loudly.
        sub = builder.build_select(stmt)
        return LogicalJoin(tp, p, sub)
    if stmt.from_ is None:
        # EXISTS (SELECT <exprs>): one constant row, always non-empty
        return LogicalJoin(tp, p, LogicalTableDual(row_count=1))
    sub_p = builder.build_table_refs(stmt.from_)
    corr: List[Expression] = []
    if stmt.where is not None:
        rw = ExprRewriter(sub_p.schema, builder, outer_schema=p.schema)
        local: List[Expression] = []
        for c in split_cnf(rw.rewrite(stmt.where)):
            cols = c.collect_columns()
            if all(sub_p.schema.contains(x) for x in cols):
                local.append(fold_constants(c))
            else:
                corr.append(c)
        if local:
            sub_p = LogicalSelection(local, sub_p)
    join = LogicalJoin(tp, p, sub_p)
    for c in corr:
        pair = _eq_pair(c, p.schema, sub_p.schema)
        if pair is not None:
            join.eq_conditions.append(pair)
        else:
            join.other_conditions.append(c)
    return join


def _has_aggs(stmt: ast.SelectStmt) -> bool:
    for f in stmt.fields:
        if f.expr is not None and ast.has_agg(f.expr):
            return True
    return False


def _eq_pair(c: Expression, outer_schema,
             inner_schema) -> Optional[Tuple[Expression, Expression]]:
    """``inner_expr = outer_expr`` (either order) -> (outer, inner) pair
    for the semi join's equi-keys; None when the conjunct is not such an
    equality (it stays an other_condition)."""
    if getattr(c, "name", "") != "=" or len(c.children()) != 2:
        return None
    a, b = c.children()
    ac, bc = a.collect_columns(), b.collect_columns()
    if not ac or not bc:
        return None
    a_outer = all(outer_schema.contains(x) for x in ac)
    b_outer = all(outer_schema.contains(x) for x in bc)
    a_inner = all(inner_schema.contains(x) for x in ac)
    b_inner = all(inner_schema.contains(x) for x in bc)
    if a_outer and b_inner:
        return a, b
    if b_outer and a_inner:
        return b, a
    return None

"""Memo structure for the cascades search (reference: planner/memo —
group.go Group, group_expr.go GroupExpr, pattern.go Operand/Pattern,
expr_iter.go ExprIter).

A Group holds logically-equivalent expressions; a GroupExpr is one logical
operator whose children are Groups.  Fingerprints dedup expressions within
a group; the whole memo deduplicates subtrees by fingerprint so repeated
exploration converges.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..logical import (LogicalAggregation, LogicalDataSource, LogicalJoin,
                       LogicalLimit, LogicalPlan, LogicalProjection,
                       LogicalSelection, LogicalSort, LogicalTableDual,
                       LogicalTopN)

ANY = object()  # wildcard operand (reference: pattern.OperandAny)


class GroupExpr:
    __slots__ = ("op", "children", "explored")

    def __init__(self, op: LogicalPlan, children: List["Group"]):
        self.op = op          # logical node; its .children are NOT used
        self.children = children
        self.explored = False

    def fingerprint(self) -> str:
        return op_key(self.op) + "|" + ",".join(
            str(id(g)) for g in self.children)


class Group:
    __slots__ = ("exprs", "_fps", "schema", "explored", "best", "impl")

    def __init__(self, schema):
        self.exprs: List[GroupExpr] = []
        self._fps = set()
        self.schema = schema
        self.explored = False
        # implementation winner: (cost, est_rows, logical tree)
        self.best: Optional[Tuple[float, float, LogicalPlan]] = None
        # PHYSICAL winners per required order property:
        # {prop tuple: (cost, est_rows, PhysicalPlan)} (implementation.py)
        self.impl: Dict[tuple, tuple] = {}

    def insert(self, ge: GroupExpr) -> bool:
        fp = ge.fingerprint()
        if fp in self._fps:
            return False
        self._fps.add(fp)
        self.exprs.append(ge)
        self.explored = False
        return True


def op_key(p: LogicalPlan) -> str:
    """Operator identity WITHOUT children (parameters only)."""
    if isinstance(p, LogicalDataSource):
        conds = ",".join(sorted(c.key() for c in p.pushed_conds))
        return f"DS({p.table_info.id}|{p.alias}|{conds})"
    if isinstance(p, LogicalSelection):
        return "Sel(" + ",".join(sorted(c.key() for c in p.conditions)) + ")"
    if isinstance(p, LogicalProjection):
        return "Proj(" + ",".join(e.key() for e in p.exprs) + ")"
    if isinstance(p, LogicalAggregation):
        gb = ",".join(e.key() for e in p.group_by)
        ag = ",".join(f"{d.name}({','.join(a.key() for a in d.args)})"
                      for d in p.agg_funcs)
        return f"Agg({gb}|{ag})"
    if isinstance(p, LogicalJoin):
        eq = ",".join(f"{a.key()}={b.key()}" for a, b in p.eq_conditions)
        oth = ",".join(c.key() for c in p.other_conditions)
        lc = ",".join(c.key() for c in p.left_conditions)
        rc = ",".join(c.key() for c in p.right_conditions)
        return f"Join({p.tp}|{eq}|{oth}|{lc}|{rc})"
    if isinstance(p, LogicalSort):
        return "Sort(" + ",".join(
            f"{e.key()}{'-' if d else '+'}" for e, d in p.by) + ")"
    if isinstance(p, LogicalTopN):
        by = ",".join(f"{e.key()}{'-' if d else '+'}" for e, d in p.by)
        return f"TopN({by}|{p.offset},{p.count})"
    if isinstance(p, LogicalLimit):
        return f"Limit({p.offset},{p.count})"
    if isinstance(p, LogicalTableDual):
        return f"Dual({p.row_count})"
    return type(p).__name__


class Memo:
    def __init__(self):
        self._groups: Dict[str, Group] = {}  # subtree fingerprint -> group

    def build(self, p: LogicalPlan) -> Group:
        """Convert a logical tree into the memo (reference:
        memo.Convert2Group)."""
        child_groups = [self.build(c) for c in p.children]
        ge = GroupExpr(p, child_groups)
        fp = ge.fingerprint()
        g = self._groups.get(fp)
        if g is None:
            g = Group(p.schema)
            g.insert(ge)
            self._groups[fp] = g
        return g

    def insert_equivalent(self, group: Group, p: LogicalPlan,
                          children: List[Group]) -> bool:
        """Add an equivalent expression produced by a transformation rule."""
        return group.insert(GroupExpr(p, children))


# ---- pattern matching ------------------------------------------------------

class Pattern:
    """Two-level operand pattern (reference: pattern.Pattern).  `op_type`
    is a Logical* class or ANY; children match against the child groups'
    expressions."""

    def __init__(self, op_type, children: Optional[List["Pattern"]] = None):
        self.op_type = op_type
        self.children = children or []

    def match_expr(self, ge: GroupExpr):
        """Yield bindings: a tuple (ge, child_bindings...) where each child
        binding is a GroupExpr from the corresponding child group matching
        the child pattern (reference: ExprIter)."""
        if self.op_type is not ANY and not isinstance(ge.op, self.op_type):
            return
        if not self.children:
            yield (ge,)
            return
        if len(self.children) != len(ge.children):
            return

        def rec(i, acc):
            if i == len(self.children):
                yield tuple(acc)
                return
            for cge in ge.children[i].exprs:
                for sub in self.children[i].match_expr(cge):
                    yield from rec(i + 1, acc + [sub])
        for binding in rec(0, []):
            yield (ge,) + binding

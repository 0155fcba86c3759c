"""Shared join-conjunct classification (reference: the condition split in
rule_predicate_push_down.go).  Used by both optimizer frameworks so eq
extraction and side routing cannot drift between them.
"""
from __future__ import annotations

from typing import List, Tuple

from ..expression import Expression
from .logical import JOIN_INNER


def classify_conjuncts(conds: List[Expression], lsch, rsch, tp: str):
    """Split CNF `conds` for a join with child schemas (lsch, rsch).

    Returns (new_eq, left_push, right_push, other, retained):
    - new_eq: (left expr, right expr) equi-pairs extracted from `=` conds
    - left_push / right_push: one-side conditions safe to push below
    - other: cross-side non-equi conditions evaluated at the join
    - retained: conditions that must stay ABOVE the join (outer joins)
    """
    new_eq: List[Tuple[Expression, Expression]] = []
    left_push: List[Expression] = []
    right_push: List[Expression] = []
    other: List[Expression] = []
    retained: List[Expression] = []
    for c in conds:
        cols = c.collect_columns()
        on_left = all(lsch.contains(x) for x in cols)
        on_right = all(rsch.contains(x) for x in cols)
        if tp == JOIN_INNER:
            if getattr(c, "name", "") == "=":
                a, b = c.children()
                ac, bc = a.collect_columns(), b.collect_columns()
                if (ac and bc and all(lsch.contains(x) for x in ac)
                        and all(rsch.contains(x) for x in bc)):
                    new_eq.append((a, b))
                    continue
                if (ac and bc and all(rsch.contains(x) for x in ac)
                        and all(lsch.contains(x) for x in bc)):
                    new_eq.append((b, a))
                    continue
            if on_left:
                left_push.append(c)
            elif on_right:
                right_push.append(c)
            else:
                other.append(c)
        else:  # left outer join: only left-side conds push below
            if on_left:
                left_push.append(c)
            else:
                retained.append(c)
    return new_eq, left_push, right_push, other, retained

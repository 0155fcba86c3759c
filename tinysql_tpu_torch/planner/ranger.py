"""Filter -> key-range compilation (reference: util/ranger — points.go,
ranger.go:34-359 BuildTableRange/BuildIndexRange, detacher.go
DetachCondAndBuildRangeForIndex).

Given the CNF filter list on a data source and an ordered column prefix
(an index's columns, or the integer primary key), split the conditions into
*access conditions* (compiled into ranges the storage scan seeks directly)
and *remaining filters* (re-checked per row), and emit the ranges.

Supported shapes per column: `=`, IN (point sets), `<' `<=` `>` `>=`
(intervals), IS NULL (the null point — nulls sort first in the key codec).
Equality prefixes extend to the next index column; the first range column
terminates the prefix (reference detacher semantics).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..expression import Column, Constant, Expression, ScalarFunction
from ..mytypes import Datum, EvalType

# a bound value of None with incl=True means the NULL point; MIN/MAX are
# open bounds (full column range)
MIN = object()
MAX = object()


@dataclass
class Range:
    """Half-open-configurable range over an index column prefix.  `low` and
    `high` are datum tuples (shorter than the index width = prefix range)."""
    low: tuple
    high: tuple
    low_incl: bool = True
    high_incl: bool = True

    def is_point(self) -> bool:
        return (self.low == self.high and self.low_incl and self.high_incl
                and MIN not in self.low and MAX not in self.high)


FULL_RANGE = Range((MIN,), (MAX,), False, False)


def _flip(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}[op]


def _cond_on(e: Expression, col: Column):
    """Classify `e` as an access condition on `col`: returns
    (kind, payload) — ('eq', v) | ('in', [v...]) | ('lt'/'le'/'gt'/'ge', v)
    | ('isnull', None) — or None if not usable."""
    if not isinstance(e, ScalarFunction):
        return None
    name = e.name
    if name == "isnull" and isinstance(e.args[0], Column) \
            and e.args[0].unique_id == col.unique_id:
        return ("isnull", None)
    if name == "in":
        tgt = e.args[0]
        if (isinstance(tgt, Column) and tgt.unique_id == col.unique_id
                and all(isinstance(a, Constant) and a.value is not None
                        for a in e.args[1:])):
            vals = [_coerce(a.value, col) for a in e.args[1:]]
            if any(v is None for v in vals):
                return None  # un-coercible item: keep the whole IN a filter
            return ("in", vals)
        return None
    if name not in ("=", "<", "<=", ">", ">="):
        return None
    a, b = e.args
    if isinstance(a, Column) and isinstance(b, Constant):
        c, v, op = a, b, name
    elif isinstance(b, Column) and isinstance(a, Constant):
        c, v, op = b, a, _flip(name)
    else:
        return None
    if c.unique_id != col.unique_id or v.value is None:
        return None
    val = _coerce(v.value, col)
    if val is None:
        return None
    return {"=": ("eq", val), "<": ("lt", val), "<=": ("le", val),
            ">": ("gt", val), ">=": ("ge", val)}[op]


def _coerce(v: Datum, col: Column) -> Optional[Datum]:
    """Constant -> the column's key-codec family; None if incomparable
    (e.g. string constant against an int column stays a filter)."""
    et = col.eval_type
    if et is EvalType.INT:
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, int):
            return v
        if isinstance(v, float) and float(v).is_integer():
            return int(v)
        return None
    if et is EvalType.REAL:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        return None
    return str(v) if isinstance(v, str) else None


def detach_conditions(conds: List[Expression], index_cols: List[Column]
                      ) -> Tuple[List[Range], List[Expression],
                                 List[Expression]]:
    """Split CNF `conds` over the column prefix `index_cols`.

    Returns (ranges, access_conds, remaining_conds).  Empty access_conds
    means the index gives no seek advantage (full range)."""
    remaining = list(conds)
    access: List[Expression] = []
    prefixes: List[tuple] = [()]
    final: Optional[List[Range]] = None

    for col in index_cols:
        # gather every usable condition on this column
        eq_points: Optional[List[Datum]] = None
        lo, lo_incl, hi, hi_incl = MIN, False, MAX, False
        used: List[Expression] = []
        for e in list(remaining):
            kind = _cond_on(e, col)
            if kind is None:
                continue
            k, v = kind
            if k == "eq":
                pts = [v]
            elif k == "in":
                pts = sorted(set(v), key=lambda x: (x is None, x))
            elif k == "isnull":
                pts = [None]
            else:
                pts = None
            if pts is not None:
                eq_points = (pts if eq_points is None
                             else [p for p in eq_points if p in pts])
                used.append(e)
                continue
            # interval bound (intersect)
            if k in ("gt", "ge"):
                if lo is MIN or v > lo or (v == lo and k == "gt"):
                    lo, lo_incl = v, (k == "ge")
            else:
                if hi is MAX or v < hi or (v == hi and k == "lt"):
                    hi, hi_incl = v, (k == "le")
            used.append(e)
        if eq_points is not None:
            # equality point(s), filtered by any interval bounds gathered on
            # the same column (a = 5 AND a > 7 -> empty)
            def _in_bounds(v):
                if v is None:  # NULL point never satisfies an interval
                    return lo is MIN and hi is MAX
                if lo is not MIN and (v < lo or (v == lo and not lo_incl)):
                    return False
                if hi is not MAX and (v > hi or (v == hi and not hi_incl)):
                    return False
                return True
            eq_points = [v for v in eq_points if _in_bounds(v)]
            access.extend(used)
            for e in used:
                remaining.remove(e)
            prefixes = [p + (v,) for p in prefixes for v in eq_points]
            if not prefixes:  # contradictory IN/=: empty result
                return [], access, remaining
            continue
        if lo is not MIN or hi is not MAX:
            # range column terminates the prefix
            access.extend(used)
            for e in used:
                remaining.remove(e)
            final = [Range(p + (lo,), p + (hi,), lo_incl, hi_incl)
                     for p in prefixes]
        break

    if final is None:
        if prefixes == [()]:
            return [FULL_RANGE], [], remaining
        final = [Range(p, p, True, True) for p in prefixes]
    return final, access, remaining


# ===== handle (int primary key) ranges ======================================

def build_handle_ranges(conds: List[Expression], pk_col: Column
                        ) -> Tuple[Optional[List[Tuple[int, int]]],
                                   List[Expression], List[Expression]]:
    """Integer [lo, hi] (inclusive) handle ranges for the clustered PK.
    Returns (ranges|None, access_conds, remaining).  None = full scan."""
    ranges, access, remaining = detach_conditions(conds, [pk_col])
    if not access:
        return None, [], conds
    out: List[Tuple[int, int]] = []
    for r in ranges:
        lo = r.low[0] if r.low else MIN
        hi = r.high[0] if r.high else MAX
        if lo is None or hi is None:  # IS NULL on a NOT NULL pk: empty
            continue
        ilo = -(1 << 63) if lo is MIN else int(lo) + (0 if r.low_incl else 1)
        ihi = (1 << 63) - 1 if hi is MAX else int(hi) - (0 if r.high_incl else 1)
        if ilo <= ihi:
            out.append((ilo, ihi))
    return out, access, remaining

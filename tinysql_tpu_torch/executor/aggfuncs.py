"""Aggregate function state machines.

Capability parity with reference executor/aggfuncs/ (AggFunc iface
aggfuncs.go:63 — Alloc/Update/Merge/Append — with per-mode builders
builder.go, impls func_count.go/func_sum.go/func_avg.go/func_max_min.go/
func_first_row.go).  States support COMPLETE (rows->result),
PARTIAL1 (rows->partial) and FINAL (partials->result) so the same machinery
drives single-chip, parallel, and distributed (psum-merged) aggregation.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..expression import AggFuncDesc, AggMode
from ..expression.aggregation import (AGG_AVG, AGG_COUNT, AGG_FIRST_ROW,
                                      AGG_MAX, AGG_MIN, AGG_SUM)
from ..mytypes import Datum, EvalType, coerce_for_compare, to_real, wrap_i64


class AggState:
    """Per-group accumulator."""

    def update(self, vals: List[Datum]) -> None:  # one input row's arg values
        raise NotImplementedError

    def merge(self, partial: List[Datum]) -> None:  # partial-result columns
        raise NotImplementedError

    def partial(self) -> List[Datum]:
        raise NotImplementedError

    def result(self) -> Datum:
        raise NotImplementedError


class CountState(AggState):
    __slots__ = ("n", "distinct", "seen")

    def __init__(self, distinct=False):
        self.n = 0
        self.distinct = distinct
        self.seen = set() if distinct else None

    def update(self, vals):
        if any(v is None for v in vals):
            return
        if self.distinct:
            key = tuple(vals)
            if key in self.seen:
                return
            self.seen.add(key)
        self.n += 1

    def merge(self, partial):
        if partial[0] is not None:
            self.n += partial[0]

    def partial(self):
        return [self.n]

    def result(self):
        return self.n


class SumState(AggState):
    __slots__ = ("total", "has", "is_int", "distinct", "seen")

    def __init__(self, is_int: bool, distinct=False):
        self.total = 0 if is_int else 0.0
        self.has = False
        self.is_int = is_int
        self.distinct = distinct
        self.seen = set() if distinct else None

    def update(self, vals):
        v = vals[0]
        if v is None:
            return
        if self.distinct:
            if v in self.seen:
                return
            self.seen.add(v)
        if self.is_int:
            self.total = wrap_i64(self.total + int(v))
        else:
            self.total += to_real(v)
        self.has = True

    def merge(self, partial):
        v = partial[0]
        if v is None:
            return
        if self.is_int:
            self.total = wrap_i64(self.total + int(v))
        else:
            self.total += to_real(v)
        self.has = True

    def partial(self):
        return [self.total if self.has else None]

    def result(self):
        return self.total if self.has else None


class AvgState(AggState):
    """COMPLETE-mode avg; in distributed mode avg is split into sum+count
    partials and a FINAL avg over two columns (aggregation.py split)."""
    __slots__ = ("total", "n", "distinct", "seen")

    def __init__(self, distinct=False):
        self.total = 0.0
        self.n = 0
        self.distinct = distinct
        self.seen = set() if distinct else None

    def update(self, vals):
        v = vals[0]
        if v is None:
            return
        if self.distinct:
            if v in self.seen:
                return
            self.seen.add(v)
        self.total += to_real(v)
        self.n += 1

    def merge(self, partial):
        # partial = [sum, count]
        if partial[1]:
            self.total += to_real(partial[0] or 0.0)
            self.n += partial[1]

    def partial(self):
        return [self.total if self.n else None, self.n]

    def result(self):
        return self.total / self.n if self.n else None


class FinalAvgState(AggState):
    """FINAL avg over (sum, count) partial columns."""
    __slots__ = ("total", "n")

    def __init__(self):
        self.total = 0.0
        self.n = 0

    def update(self, vals):  # vals = [sum_partial, count_partial]
        self.merge(vals)

    def merge(self, partial):
        if partial[1]:
            self.total += to_real(partial[0] or 0.0)
            self.n += int(partial[1])

    def partial(self):
        return [self.total if self.n else None, self.n]

    def result(self):
        return self.total / self.n if self.n else None


class MaxMinState(AggState):
    __slots__ = ("best", "is_max")

    def __init__(self, is_max: bool):
        self.best: Optional[Datum] = None
        self.is_max = is_max

    def update(self, vals):
        v = vals[0]
        if v is None:
            return
        if self.best is None:
            self.best = v
            return
        a, b = coerce_for_compare(v, self.best)
        if (a > b) == self.is_max and a != b:
            self.best = v

    def merge(self, partial):
        self.update(partial)

    def partial(self):
        return [self.best]

    def result(self):
        return self.best


class FirstRowState(AggState):
    __slots__ = ("value", "seen")

    def __init__(self):
        self.value = None
        self.seen = False

    def update(self, vals):
        if not self.seen:
            self.value = vals[0]
            self.seen = True

    def merge(self, partial):
        self.update(partial)

    def partial(self):
        return [self.value]

    def result(self):
        return self.value


def new_state(desc: AggFuncDesc) -> AggState:
    """reference: aggfuncs/builder.go Build (by name + mode)."""
    name = desc.name
    if name == AGG_COUNT:
        if desc.mode is AggMode.FINAL:
            s = CountState()
            s.update = s.merge  # final count sums partial counts
            return s
        return CountState(desc.distinct)
    if name == AGG_SUM:
        is_int = desc.ret_type.eval_type is EvalType.INT
        if desc.mode is AggMode.FINAL:
            s = SumState(is_int)
            s.update = s.merge
            return s
        return SumState(is_int, desc.distinct)
    if name == AGG_AVG:
        if desc.mode is AggMode.FINAL:
            return FinalAvgState()
        return AvgState(desc.distinct)
    if name == AGG_MAX:
        return MaxMinState(True)
    if name == AGG_MIN:
        return MaxMinState(False)
    if name == AGG_FIRST_ROW:
        return FirstRowState()
    raise ValueError(f"unknown aggregate {name!r}")

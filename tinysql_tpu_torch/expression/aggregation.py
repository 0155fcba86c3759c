"""Planner-side aggregate descriptors with partial/final mode split.

Capability parity with reference expression/aggregation/ (descriptor.go,
base_func.go, per-func files) — the partial/final split IS the
reduce-scatter schema for the TPU path (SURVEY §2.11 P5): partial states
computed per shard, merged with psum/segment-merge, finalized once.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..mytypes import (EvalType, FieldType, new_int_type, new_real_type)
from .core import Column, Expression

AGG_COUNT = "count"
AGG_SUM = "sum"
AGG_AVG = "avg"
AGG_MAX = "max"
AGG_MIN = "min"
AGG_FIRST_ROW = "first_row"


class AggMode(enum.Enum):
    """reference: aggregation/descriptor.go AggFunctionMode."""
    COMPLETE = "complete"    # raw rows -> final result
    PARTIAL1 = "partial1"    # raw rows -> partial state
    FINAL = "final"          # partial states -> final result


@dataclass
class AggFuncDesc:
    name: str
    args: List[Expression]
    mode: AggMode = AggMode.COMPLETE
    distinct: bool = False
    ret_type: FieldType = None

    def __post_init__(self):
        if self.ret_type is None:
            self.ret_type = infer_agg_ret_type(self.name, self.args)

    def clone(self) -> "AggFuncDesc":
        return AggFuncDesc(self.name, list(self.args), self.mode,
                           self.distinct, self.ret_type)

    # ---- partial/final split (reference: descriptor.go Split) ----------
    def split(self, ordinal: List[int]) -> Tuple[List["AggFuncDesc"], "AggFuncDesc"]:
        """Returns (partial descs, final desc).  `ordinal` gives the column
        offsets where the partial outputs will land; the final desc's args
        are Columns over those offsets."""
        partials: List[AggFuncDesc] = []
        if self.name == AGG_AVG:
            sum_d = AggFuncDesc(AGG_SUM, list(self.args), AggMode.PARTIAL1,
                                self.distinct, new_real_type())
            cnt_d = AggFuncDesc(AGG_COUNT, list(self.args), AggMode.PARTIAL1,
                                self.distinct, new_int_type())
            partials = [sum_d, cnt_d]
            final = AggFuncDesc(
                AGG_AVG,
                [Column(new_real_type(), ordinal[0]),
                 Column(new_int_type(), ordinal[1])],
                AggMode.FINAL, False, self.ret_type)
            return partials, final
        part = AggFuncDesc(self.name, list(self.args), AggMode.PARTIAL1,
                           self.distinct, self.ret_type)
        partial_ret = part.partial_result_types()[0]
        final = AggFuncDesc(self.name, [Column(partial_ret, ordinal[0])],
                            AggMode.FINAL, False, self.ret_type)
        return [part], final

    def partial_result_types(self) -> List[FieldType]:
        if self.name == AGG_COUNT:
            return [new_int_type()]
        if self.name == AGG_AVG:
            return [new_real_type(), new_int_type()]
        return [self.ret_type]

    def __repr__(self):  # pragma: no cover
        d = "distinct " if self.distinct else ""
        return f"{self.name}({d}{', '.join(map(repr, self.args))})"


def infer_agg_ret_type(name: str, args: List[Expression]) -> FieldType:
    """reference: aggregation/base_func.go typeInfer*."""
    if name == AGG_COUNT:
        return new_int_type()
    if name == AGG_AVG:
        return new_real_type()
    if name == AGG_SUM:
        # no DECIMAL family: int sums stay int64 (wrap), real sums real
        if args and args[0].eval_type is EvalType.REAL:
            return new_real_type()
        if args and args[0].eval_type is EvalType.STRING:
            return new_real_type()
        # unsigned input sums stay unsigned (wrap mod 2^64 like MySQL
        # BIGINT UNSIGNED without the out-of-range error)
        return new_int_type(unsigned=bool(
            args and args[0].ret_type.is_unsigned))
    # max/min/first_row keep their arg type
    ft = args[0].ret_type.clone() if args else new_int_type()
    ft.flag &= ~0x1  # clear NOT NULL: aggs of empty groups yield NULL
    return ft

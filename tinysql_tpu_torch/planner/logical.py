"""Logical plan operators.

Capability parity with reference planner/core/logical_plans.go:601
(DataSource, Selection, Projection, Aggregation, Join, Sort, TopN, Limit,
TableDual) with schemas of expression Columns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..catalog.model import IndexInfo, TableInfo
from ..expression import AggFuncDesc, Column, Expression, Schema


class LogicalPlan:
    children: List["LogicalPlan"]
    schema: Schema

    def __init__(self):
        self.children = []
        self.schema = Schema([])

    def child(self, i: int = 0) -> "LogicalPlan":
        return self.children[i]

    def set_child(self, i: int, p: "LogicalPlan") -> None:
        self.children[i] = p

    def op_name(self) -> str:
        return type(self).__name__.replace("Logical", "")

    def __repr__(self):  # pragma: no cover
        return f"{self.op_name()}({', '.join(map(repr, self.children))})"


class LogicalDataSource(LogicalPlan):
    """reference: logical_plans.go DataSource."""

    def __init__(self, db_name: str, table_info: TableInfo, alias: str,
                 columns: List[Column]):
        super().__init__()
        self.db_name = db_name
        self.table_info = table_info
        self.alias = alias or table_info.name
        self.schema = Schema(columns)
        # filters pushed down to the scan (reference: pushedDownConds)
        self.pushed_conds: List[Expression] = []
        self.all_conds: List[Expression] = []
        # chosen access path is decided at physical time (index or table)
        self.possible_indices: List[IndexInfo] = list(table_info.public_indices())


class LogicalSelection(LogicalPlan):
    def __init__(self, conditions: List[Expression], child: LogicalPlan):
        super().__init__()
        self.conditions = conditions
        self.children = [child]
        self.schema = child.schema


class LogicalProjection(LogicalPlan):
    def __init__(self, exprs: List[Expression], schema: Schema,
                 child: LogicalPlan):
        super().__init__()
        self.exprs = exprs
        self.schema = schema
        self.children = [child]


class LogicalAggregation(LogicalPlan):
    def __init__(self, group_by: List[Expression],
                 agg_funcs: List[AggFuncDesc], schema: Schema,
                 child: LogicalPlan):
        super().__init__()
        self.group_by = group_by
        self.agg_funcs = agg_funcs
        self.schema = schema
        self.children = [child]


JOIN_INNER = "inner"
JOIN_LEFT = "left"
JOIN_RIGHT = "right"
JOIN_SEMI = "semi"
JOIN_ANTI = "anti"


class LogicalJoin(LogicalPlan):
    """reference: logical_plans.go LogicalJoin."""

    def __init__(self, tp: str, left: LogicalPlan, right: LogicalPlan):
        super().__init__()
        self.tp = tp
        self.children = [left, right]
        # semi/anti joins are FILTERS on the left side: they emit left
        # rows only (reference: LogicalJoin.SemiJoin schema = left)
        if tp in (JOIN_SEMI, JOIN_ANTI):
            self.schema = Schema(list(left.schema.columns))
        else:
            self.schema = left.schema.merge(right.schema)
        # CNF split of the ON/WHERE conditions by side
        self.eq_conditions: List[Tuple[Expression, Expression]] = []  # (lcol expr, rcol expr)
        self.left_conditions: List[Expression] = []
        self.right_conditions: List[Expression] = []
        self.other_conditions: List[Expression] = []
        # NOT IN anti joins carry three-valued NULL semantics: any NULL
        # build key kills every probe row, a NULL probe key only passes
        # an EMPTY build side (reference: null-aware anti join)
        self.null_aware = False


class LogicalSort(LogicalPlan):
    def __init__(self, by: List[Tuple[Expression, bool]], child: LogicalPlan):
        super().__init__()
        self.by = by  # (expr, desc)
        self.children = [child]
        self.schema = child.schema


class LogicalTopN(LogicalPlan):
    def __init__(self, by: List[Tuple[Expression, bool]], offset: int,
                 count: int, child: LogicalPlan):
        super().__init__()
        self.by = by
        self.offset = offset
        self.count = count
        self.children = [child]
        self.schema = child.schema


class LogicalLimit(LogicalPlan):
    def __init__(self, offset: int, count: int, child: LogicalPlan):
        super().__init__()
        self.offset = offset
        self.count = count
        self.children = [child]
        self.schema = child.schema


class LogicalMemTable(LogicalPlan):
    """Virtual INFORMATION_SCHEMA source (reference: infoschema mem-tables
    + planner MemTable plan)."""

    def __init__(self, db_name: str, table: str, columns: List[Column]):
        super().__init__()
        self.db_name = db_name
        self.table = table
        self.schema = Schema(columns)


class LogicalTableDual(LogicalPlan):
    """One-row (or zero-row) constant source (reference: TableDual)."""

    def __init__(self, schema: Optional[Schema] = None, row_count: int = 1):
        super().__init__()
        self.schema = schema or Schema([])
        self.row_count = row_count

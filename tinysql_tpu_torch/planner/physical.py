"""Physical plan operators + logical->physical conversion.

Capability parity with reference planner/core/physical_plans.go (367 L) and
the findBestTask machinery (find_best_task.go / task.go) — this module holds
the operator shapes; the cost-based search with the device enforcer lives in
optimizer.py.  Every physical node carries expressions already
resolve_indices-bound to its child schema, so executors evaluate by offset.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..catalog.model import IndexInfo, TableInfo
from ..expression import (AggFuncDesc, Column, Expression, Schema)
from ..mytypes import new_int_type
from .builder import HANDLE_COL_NAME
from .logical import (LogicalAggregation, LogicalDataSource, LogicalJoin,
                      LogicalLimit, LogicalPlan, LogicalProjection,
                      LogicalSelection, LogicalSort, LogicalTableDual,
                      LogicalTopN)


class PhysicalPlan:
    def __init__(self):
        self.children: List[PhysicalPlan] = []
        self.schema = Schema([])
        self.stats_row_count: float = 0.0

    def op_name(self) -> str:
        return type(self).__name__.replace("Physical", "")

    def explain_info(self) -> str:
        return ""

    def __repr__(self):  # pragma: no cover
        return f"{self.op_name()}"


class PhysicalTableScan(PhysicalPlan):
    """Full/ranged scan over a table's record keyspace — runs inside the
    'coprocessor' (storage side) like reference PhysicalTableScan."""

    def __init__(self, table_info: TableInfo, db_name: str, alias: str,
                 schema: Schema, with_handle: bool = False):
        super().__init__()
        self.table_info = table_info
        self.db_name = db_name
        self.alias = alias
        self.schema = schema
        self.with_handle = with_handle
        self.ranges: Optional[list] = None   # handle ranges; None = full
        self.filters: List[Expression] = []  # pushed-down, schema-bound
        # coprocessor-side executor chain (planner/cop.py push_to_cop)
        self.pushed_agg: Optional[dict] = None
        self.pushed_topn: Optional[dict] = None
        self.pushed_limit: Optional[int] = None


class PhysicalIndexScan(PhysicalPlan):
    def __init__(self, table_info: TableInfo, index: IndexInfo, db_name: str,
                 alias: str, schema: Schema, ranges=None):
        super().__init__()
        self.table_info = table_info
        self.index = index
        self.db_name = db_name
        self.alias = alias
        self.schema = schema   # index columns + handle
        self.ranges = ranges
        self.filters: List[Expression] = []
        self.desc = False
        # covering reads: per-schema-column source ("idx", i) | ("handle",)
        self.output_sources: List[tuple] = []


class PhysicalTableReader(PhysicalPlan):
    """Host-side reader driving coprocessor scans (reference:
    PhysicalTableReader)."""

    def __init__(self, scan: PhysicalTableScan):
        super().__init__()
        self.scan = scan
        self.schema = scan.schema


class PhysicalIndexReader(PhysicalPlan):
    def __init__(self, scan: PhysicalIndexScan):
        super().__init__()
        self.scan = scan
        self.schema = scan.schema


class PhysicalIndexLookUpReader(PhysicalPlan):
    """Double read: index keys -> handles -> table rows (reference:
    IndexLookUpExecutor 2-stage pipeline, distsql.go:237)."""

    def __init__(self, index_scan: PhysicalIndexScan,
                 table_scan: PhysicalTableScan):
        super().__init__()
        self.index_scan = index_scan
        self.table_scan = table_scan
        self.schema = table_scan.schema


class PhysicalMemTable(PhysicalPlan):
    def __init__(self, table: str, schema: Schema):
        super().__init__()
        self.table = table
        self.schema = schema


class PhysicalSelection(PhysicalPlan):
    def __init__(self, conditions: List[Expression], child: PhysicalPlan):
        super().__init__()
        self.conditions = conditions
        self.children = [child]
        self.schema = child.schema


class PhysicalProjection(PhysicalPlan):
    def __init__(self, exprs: List[Expression], schema: Schema,
                 child: PhysicalPlan):
        super().__init__()
        self.exprs = exprs
        self.schema = schema
        self.children = [child]


class PhysicalHashAgg(PhysicalPlan):
    def __init__(self, group_by: List[Expression], aggs: List[AggFuncDesc],
                 schema: Schema, child: PhysicalPlan,
                 gb_output_offsets: List[int]):
        super().__init__()
        self.group_by = group_by
        self.aggs = aggs
        self.schema = schema
        self.children = [child]
        # offsets in `schema` where each group-by value lands (after aggs)
        self.gb_output_offsets = gb_output_offsets
        self.use_tpu = False


class PhysicalStreamAgg(PhysicalHashAgg):
    """Sorted-input aggregation (reference: StreamAggExec)."""


class PhysicalHashJoin(PhysicalPlan):
    def __init__(self, tp: str, left: PhysicalPlan, right: PhysicalPlan,
                 schema: Schema):
        super().__init__()
        self.tp = tp
        self.children = [left, right]
        self.schema = schema
        self.left_keys: List[Expression] = []
        self.right_keys: List[Expression] = []
        self.other_conditions: List[Expression] = []
        self.build_side = 1  # 1 = right is build side
        self.use_tpu = False
        # NOT IN three-valued semantics on anti joins (decorrelate.py)
        self.null_aware = False


class PhysicalMergeJoin(PhysicalHashJoin):
    """Sorted-input merge join (reference: MergeJoinExec)."""


class PhysicalSort(PhysicalPlan):
    def __init__(self, by: List[Tuple[Expression, bool]], child: PhysicalPlan):
        super().__init__()
        self.by = by
        self.children = [child]
        self.schema = child.schema
        self.use_tpu = False


class PhysicalTopN(PhysicalPlan):
    def __init__(self, by: List[Tuple[Expression, bool]], offset: int,
                 count: int, child: PhysicalPlan):
        super().__init__()
        self.by = by
        self.offset = offset
        self.count = count
        self.children = [child]
        self.schema = child.schema
        self.use_tpu = False


class PhysicalLimit(PhysicalPlan):
    def __init__(self, offset: int, count: int, child: PhysicalPlan):
        super().__init__()
        self.offset = offset
        self.count = count
        self.children = [child]
        self.schema = child.schema


class PhysicalTableDual(PhysicalPlan):
    def __init__(self, schema: Schema, row_count: int = 1):
        super().__init__()
        self.schema = schema
        self.row_count = row_count

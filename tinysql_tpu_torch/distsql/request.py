"""Coprocessor DAG request model (reference: kv.Request + tipb.DAGRequest
built by distsql/request_builder.go:36-130 and executor/builder.go's
PB assembly).

The request carries everything the storage side needs to run the pushed
executor chain: scan column layout, snapshot ts, wire-form filter /
partial-aggregation / topn / limit nodes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ScanInfo:
    """Table scan column layout: ids, field types (wire form), defaults,
    and which output slot (if any) is the integer handle."""
    table_id: int
    col_ids: List[int]
    col_fts: List[dict]            # exprpb._ft_to_pb form
    col_defaults: List[object]
    handle_slots: List[int]        # output offsets filled with the handle
    pk_id: Optional[int] = None    # pk-as-handle column id (value == handle)


@dataclass
class DAGRequest:
    """reference: tipb.DAGRequest {TableScan, Selection, Aggregation, TopN,
    Limit} executor list."""
    start_ts: int
    scan: ScanInfo
    filters: Optional[List[dict]] = None      # exprpb trees over scan cols
    agg: Optional[dict] = None                # {"group_by": [pb], "aggs":
    #   [{"name","args":[pb],"distinct"}]} — PARTIAL1 on the cop side
    topn: Optional[dict] = None               # {"by": [(pb, desc)], "n": int}
    limit: Optional[int] = None
    analyze: bool = False                     # per-region stats partials
    resolved: Tuple[int, ...] = ()            # resolved-lock start_ts cache

"""Access-path selection: table scan vs index scan vs index lookup.

Capability parity with reference planner/core/find_best_task.go (the
DataSource task enumeration + skyline pruning stub :214 implemented for
real) and planner/util/path.go AccessPath.  Ranges come from ranger.py;
row-count estimates from statistics/table_stats.py (histograms + CMSketch
when ANALYZE ran, heuristic defaults otherwise).

Cost model (reference task.go GetCost, reduced): scanning N rows costs N;
a covering index scan costs 0.9N (narrower rows); an index lookup pays a
double-read penalty per matched row (task.go finishCopTask's network/seek
factor analogue).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..catalog.model import IndexInfo
from ..expression import Column, Expression
from .logical import LogicalDataSource
from .physical import (PhysicalIndexLookUpReader, PhysicalIndexReader,
                       PhysicalIndexScan, PhysicalPlan, PhysicalTableReader,
                       PhysicalTableScan)
from . import ranger

LOOKUP_FACTOR = 4.0     # random point-read penalty per matched row
COVER_FACTOR = 0.9      # narrower index rows scan cheaper
PSEUDO_ROWS = 10000.0   # row estimate when no stats exist


@dataclass
class AccessPath:
    """reference: planner/util/path.go"""
    index: Optional[IndexInfo]          # None = table (handle) path
    ranges: list
    access_conds: List[Expression]
    remaining: List[Expression]
    covering: bool
    est_rows: float
    cost: float = 0.0
    index_cols: List[Column] = field(default_factory=list)


def _schema_col(ds: LogicalDataSource, name: str) -> Optional[Column]:
    for c in ds.schema.columns:
        if c.name == name:
            return c
    return None


def _sort_cost(n: float) -> float:
    """Cost of materializing + sorting n rows, in scan-row units
    (reference: task.go sort GetCost rows*log(rows)*cpuFactor)."""
    import math
    n = max(n, 1.0)
    return n * math.log2(max(n, 2.0)) * 0.05


def choose_path(ds: LogicalDataSource, stats,
                order_names=None) -> AccessPath:
    """Enumerate paths, skyline-prune, pick min cost.  `order_names`
    (ascending column-name prefix required by a parent Sort/TopN) makes
    this ORDER-AWARE (reference: findBestTask enumerating under a
    required PhysicalProperty): an order-providing path wins when its
    cost beats the cheapest path PLUS the Sort enforcer it avoids."""
    conds = list(ds.pushed_conds)
    # live commit-time count deltas make row_count real even without
    # ANALYZE (stats_meta analogue); only a table we know NOTHING about
    # falls back to the pseudo default
    known = stats is not None and (stats.row_count > 0 or stats.columns
                                   or stats.modify_count > 0)
    total = float(max(stats.row_count, 1)) if known else PSEUDO_ROWS

    paths: List[AccessPath] = []
    order_paths: List[AccessPath] = []

    # ---- table path (clustered int pk -> handle ranges) ----------------
    pk = ds.table_info.get_pk_handle_col()
    pk_col = _schema_col(ds, pk.name) if pk is not None else None
    if pk_col is not None:
        hranges, access, remaining = ranger.build_handle_ranges(conds, pk_col)
    else:
        hranges, access, remaining = None, [], conds
    sel = _sel(stats, access, _handle_heuristic(hranges, total))
    paths.append(AccessPath(None, hranges, access, remaining, True,
                            total * (sel if access else 1.0)))

    # ---- index paths ----------------------------------------------------
    for idx in ds.possible_indices:
        icols = []
        for ic in idx.columns:
            if ic.length >= 0:
                break  # prefix-length column: truncated values can't seek
            c = _schema_col(ds, ic.name)
            if c is None:
                break  # index column pruned out of scope
            icols.append(c)
        if not icols:
            continue
        ranges, access, remaining = ranger.detach_conditions(conds, icols)
        covering = _covers(ds, idx, pk)
        idx_names = _order_idx_names(idx)
        order_ok = (order_names is not None and covering
                    and idx_names[:len(order_names)] == order_names)
        if not access and not order_ok:
            continue  # no seek advantage and no order to provide
        est = total * _sel(stats, access, _heuristic_sel(ranges, icols)
                           if access else 1.0)
        if not access:
            # order-only FULL scan: the whole keyspace INCLUDING the null
            # section (a comparison-derived MIN bound would skip NULLs,
            # but ORDER BY must emit them — first, like the key codec
            # sorts them); exempt from skyline (kept for its ORDER)
            ranges = [ranger.Range(low=(), high=())]
            order_paths.append(AccessPath(idx, ranges, access, remaining,
                                          covering, est, index_cols=icols))
        else:
            paths.append(AccessPath(idx, ranges, access, remaining,
                                    covering, est, index_cols=icols))

    paths = _skyline_prune(paths) + order_paths

    # a nonempty table never estimates below one row (reference pseudo
    # stats floor, planner/core/stats.go: pseudo estimates are fractions
    # of pseudoRowCount, never zero) — EQ_DEFAULT x a tiny row count would
    # otherwise render estRows 0.00 and feed the cost model garbage
    if total >= 1.0:
        for p in paths:
            p.est_rows = min(total, max(p.est_rows, 1.0))

    for p in paths:
        if p.index is None:
            p.cost = p.est_rows if p.access_conds else total
        elif p.covering:
            p.cost = p.est_rows * COVER_FACTOR
        else:
            p.cost = p.est_rows * (1.0 + LOOKUP_FACTOR)
    best = min(paths, key=lambda p: p.cost)
    if order_names is not None:
        sat = [p for p in paths if _path_provides(p, pk, order_names)]
        if sat:
            best_sat = min(sat, key=lambda p: p.cost)
            out_rows = best.est_rows * _residual_sel(stats, best.remaining)
            if best_sat.cost <= best.cost + _sort_cost(out_rows):
                return best_sat
    return best


def _order_idx_names(idx: IndexInfo):
    """Index columns usable for ORDER, stopping at the FIRST
    prefix-length column — a truncated key column breaks the emitted
    order for everything after it (shared by order_ok, _path_provides,
    and build_reader's order_col_uids so they can never disagree)."""
    out = []
    for ic in idx.columns:
        if ic.length >= 0:
            break
        out.append(ic.name)
    return out


def _path_provides(p: AccessPath, pk, order_names) -> bool:
    """Does this path emit `order_names` (ascending prefix)?"""
    if p.index is None:
        return pk is not None and order_names == [pk.name]
    if not p.covering:
        return False  # double-read does not preserve index order here
    return _order_idx_names(p.index)[:len(order_names)] == order_names


def _sel(stats, access_conds: List[Expression], fallback: float) -> float:
    if not access_conds:
        return 1.0
    if stats is not None and not stats.pseudo:
        return stats.selectivity(access_conds)
    return fallback


def _residual_sel(stats, remaining: List[Expression]) -> float:
    """Selectivity of the NON-access filters applied inside the scan: the
    reader's OUTPUT estimate is access-rows x this (reference: the cop
    Selection's own stats row)."""
    if not remaining:
        return 1.0
    if stats is not None and not stats.pseudo:
        return stats.selectivity(remaining)
    from ..statistics.table_stats import DEFAULT_SELECTIVITY
    return DEFAULT_SELECTIVITY ** len(remaining)  # selectionFactor/conjunct


def _handle_heuristic(hranges, total: float) -> float:
    """No stats: a pk point range is ~1 row; narrow ranges scale by width,
    unbounded ranges fall back to the range default 30%."""
    if not hranges:
        return 1.0
    rows = 0.0
    for lo, hi in hranges:
        width = hi - lo + 1
        rows += width if width < total else total * 0.3
    return min(1.0, rows / max(total, 1.0))


def _heuristic_sel(ranges: List[ranger.Range], icols) -> float:
    """No stats: each eq column ~10%, a range column ~30% (reference
    pseudo-stats fractions)."""
    if not ranges:
        return 0.0
    r = ranges[0]
    n_eq = len(r.low) - (0 if r.is_point() else 1)
    s = (0.1 ** max(n_eq, 0))
    if not r.is_point():
        s *= 0.3
    return min(1.0, s * max(len(ranges), 1) ** 0.5)


def _covers(ds: LogicalDataSource, idx: IndexInfo, pk) -> bool:
    """Index covers the query iff every needed schema column is an index
    column (full-length prefix) or the clustered pk handle."""
    idx_names = {ic.name for ic in idx.columns if ic.length < 0}
    for c in ds.schema.columns:
        if c.name in idx_names:
            continue
        if pk is not None and c.name == pk.name:
            continue  # handle rides along in the index entry
        return False
    return True


def _skyline_prune(paths: List[AccessPath]) -> List[AccessPath]:
    """reference find_best_task.go:214 compareCandidates: drop a path whose
    access-condition set is a subset of another's, which is not covering
    while the other is, and which matches no more ranges."""
    keep: List[AccessPath] = []
    for a in paths:
        dominated = False
        a_set = {e.key() for e in a.access_conds}
        for b in paths:
            if a is b:
                continue
            b_set = {e.key() for e in b.access_conds}
            if (a_set < b_set and b.covering >= a.covering) or \
               (a_set == b_set and not a.covering and b.covering):
                dominated = True
                break
        if not dominated:
            keep.append(a)
    return keep or paths



def _out_rows(path_rows: float, resid: float) -> float:
    """Reader output estimate: access rows x residual selectivity, floored
    at one row whenever the access estimate itself says rows exist."""
    v = path_rows * resid
    return max(v, 1.0) if path_rows >= 1.0 else v


# ===== physical construction ===============================================

def build_reader(ds: LogicalDataSource, stats, with_handle: bool,
                 order_hint=None) -> PhysicalPlan:
    """`order_hint`: [(unique_id, desc)] required above this reader —
    mapped to ascending column names for the order-aware path choice.
    The built scans always carry their PROVIDED order metadata
    (order_col_uid / order_col_uids) for props.provided_order."""
    from .optimizer import _bind  # late: avoid import cycle
    order_names = None
    if order_hint:
        by_uid = {c.unique_id: c.name for c in ds.schema.columns}
        if all(not desc and uid in by_uid for uid, desc in order_hint):
            order_names = [by_uid[uid] for uid, _ in order_hint]
    path = choose_path(ds, stats, order_names)
    pk = ds.table_info.get_pk_handle_col()
    pk_uid = None
    if pk is not None:
        sc = next((c for c in ds.schema.columns if c.name == pk.name), None)
        pk_uid = sc.unique_id if sc is not None else None
    if path.index is None:
        scan = PhysicalTableScan(ds.table_info, ds.db_name, ds.alias,
                                 ds.schema, with_handle)
        scan.ranges = path.ranges  # None = full scan
        scan.filters = _bind(path.remaining, ds.schema)
        scan.stats_row_count = path.est_rows
        scan.has_estimate = True
        scan.order_col_uid = pk_uid  # handle-ordered scan
        reader = PhysicalTableReader(scan)
        reader.stats_row_count = _out_rows(
            path.est_rows, _residual_sel(stats, path.remaining))
        reader.has_estimate = True
        return reader

    iscan = PhysicalIndexScan(ds.table_info, path.index, ds.db_name,
                              ds.alias, ds.schema, path.ranges)
    iscan.stats_row_count = path.est_rows
    iscan.has_estimate = True
    # index scans emit index-column order (the kv iteration is ordered);
    # record the uid prefix that maps onto in-scope schema columns
    uids = []
    by_name = {c.name: c.unique_id for c in ds.schema.columns}
    for name in _order_idx_names(path.index):
        if name not in by_name:
            break
        uids.append(by_name[name])
    iscan.order_col_uids = uids
    if path.covering:
        # output plan: ds.schema columns sourced from index values / handle
        pk = ds.table_info.get_pk_handle_col()
        sources = []
        idx_pos = {ic.name: i for i, ic in enumerate(path.index.columns)}
        for c in ds.schema.columns:
            if pk is not None and c.name == pk.name:
                sources.append(("handle",))
            else:
                sources.append(("idx", idx_pos[c.name]))
        iscan.output_sources = sources
        iscan.filters = _bind(path.remaining, ds.schema)
        reader = PhysicalIndexReader(iscan)
        reader.stats_row_count = _out_rows(
            path.est_rows, _residual_sel(stats, path.remaining))
        reader.has_estimate = True
        return reader

    tscan = PhysicalTableScan(ds.table_info, ds.db_name, ds.alias,
                              ds.schema, with_handle)
    tscan.filters = _bind(path.remaining, ds.schema)
    tscan.stats_row_count = _out_rows(
        path.est_rows, _residual_sel(stats, path.remaining))
    tscan.has_estimate = True
    reader = PhysicalIndexLookUpReader(iscan, tscan)
    reader.stats_row_count = tscan.stats_row_count
    reader.has_estimate = True
    return reader

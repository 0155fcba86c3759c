"""Per-table statistics + selectivity estimation + persistence.

Capability parity with reference statistics/table.go (HistColl),
statistics/selectivity.go:129-306 (combine expressions -> estimates),
statistics/handle.go (lifecycle: save after ANALYZE, cached load, feeds
the planner's DeriveStats).  Persisted as JSON in the meta keyspace
(reference persists in mysql.stats_* system tables; same contract —
survives restarts, versioned by update ts).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..expression import Column as ExprColumn, Constant, Expression, ScalarFunction
from ..kv.errors import KeyNotFound
from .histogram import Histogram
from .sketches import CMSketch

_STATS_PREFIX = b"m:stats:"  # m:stats:{table_id:08d} -> json

DEFAULT_SELECTIVITY = 0.8       # reference: selectionFactor
EQ_DEFAULT = 1.0 / 1000         # pseudo eq selectivity (pseudo table)
LT_DEFAULT = 1.0 / 3


@dataclass
class TableStats:
    table_id: int
    row_count: int = 0
    modify_count: int = 0
    version: int = 0
    columns: Dict[int, Histogram] = field(default_factory=dict)   # col_id
    cms: Dict[int, CMSketch] = field(default_factory=dict)
    indices: Dict[int, Histogram] = field(default_factory=dict)   # index_id

    @property
    def pseudo(self) -> bool:
        return self.row_count == 0 and not self.columns

    # ---- per-expression selectivity ------------------------------------
    def expr_selectivity(self, e: Expression) -> float:
        """Selectivity of one conjunct (reference: selectivity.go — reduced
        to per-conjunct independence; the disjoint-set cover over index
        prefixes lands with the index-path chooser)."""
        if self.row_count == 0:
            return DEFAULT_SELECTIVITY
        if isinstance(e, ScalarFunction):
            name = e.name
            if name in ("=", "<=>") and len(e.args) == 2:
                col, const = _col_const(e.args)
                if col is not None:
                    h = self.columns.get(col)
                    if h is not None and const is not None:
                        cms = self.cms.get(col)
                        cnt = (cms.query(const) if cms is not None
                               else h.equal_row_count(const))
                        return min(1.0, cnt / max(self.row_count, 1))
                    return EQ_DEFAULT
            if name in ("<", "<=", ">", ">=") and len(e.args) == 2:
                col, const = _col_const(e.args)
                if col is not None and const is not None:
                    h = self.columns.get(col)
                    if h is not None and h.total_count > 0:
                        less = h.less_row_count(const)
                        eq = h.equal_row_count(const)
                        flipped = isinstance(e.args[0], Constant)
                        op = name
                        if flipped:
                            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
                        if op == "<":
                            cnt = less
                        elif op == "<=":
                            cnt = less + eq
                        elif op == ">":
                            cnt = h.not_null_count() - less - eq
                        else:
                            cnt = h.not_null_count() - less
                        return min(1.0, max(cnt, 0) / max(self.row_count, 1))
                return LT_DEFAULT
            if name == "and":
                return (self.expr_selectivity(e.args[0])
                        * self.expr_selectivity(e.args[1]))
            if name == "or":
                a = self.expr_selectivity(e.args[0])
                b = self.expr_selectivity(e.args[1])
                return min(1.0, a + b - a * b)
            if name == "isnull" and isinstance(e.args[0], ExprColumn):
                h = self.columns.get(_col_id(e.args[0]))
                if h is not None and h.total_count > 0:
                    return h.null_count / h.total_count
                return EQ_DEFAULT
            if name == "in":
                col = _col_id(e.args[0])
                consts = [a.value for a in e.args[1:]
                          if isinstance(a, Constant)]
                if col is not None and len(consts) == len(e.args) - 1:
                    h = self.columns.get(col)
                    if h is not None:
                        cnt = sum(h.equal_row_count(c) for c in consts)
                        return min(1.0, cnt / max(self.row_count, 1))
                return min(1.0, EQ_DEFAULT * max(len(e.args) - 1, 1))
        return DEFAULT_SELECTIVITY

    def selectivity(self, conds: List[Expression]) -> float:
        """Combined selectivity with a per-column cover (reference:
        selectivity.go:129-306 greedy disjoint-set cover, reduced to the
        single-column case): ALL range/eq conjuncts on one histogrammed
        column merge into one interval estimate, so `a > 5 AND a < 10`
        stops multiplying as if independent.  Index-prefix covers are
        handled upstream by the access-path ranger; everything not
        claimed by a cover falls back to per-conjunct independence."""
        groups: dict = {}
        rest: List[Expression] = []
        for c in conds:
            col = self._range_cond_col(c)
            if col is not None and self.columns.get(col) is not None:
                groups.setdefault(col, []).append(c)
            else:
                rest.append(c)
        s = 1.0
        for col, cs in groups.items():
            if len(cs) == 1:
                s *= self.expr_selectivity(cs[0])
            else:
                try:
                    s *= self._interval_selectivity(col, cs)
                except TypeError:  # incomparable mixed-type constants
                    for c in cs:
                        s *= self.expr_selectivity(c)
        for c in rest:
            s *= self.expr_selectivity(c)
        return s

    @staticmethod
    def _range_cond_col(e: Expression) -> Optional[int]:
        """col id when `e` is a col-vs-const compare mergeable into an
        interval; None otherwise."""
        if isinstance(e, ScalarFunction) and e.name in ("=", "<", "<=",
                                                        ">", ">="):
            col, const = _col_const(e.args)
            if col is not None and const is not None:
                return col
        return None

    def _interval_selectivity(self, col: int,
                              cs: List[Expression]) -> float:
        """Intersect all compares on `col` into [lo, hi] and estimate one
        histogram range count."""
        h = self.columns[col]
        if h.total_count <= 0:
            return DEFAULT_SELECTIVITY
        lo, lo_open = None, False   # None = unbounded
        hi, hi_open = None, False
        for e in cs:
            c0, const = _col_const(e.args)
            op = e.name
            if isinstance(e.args[0], Constant):  # const OP col -> flip
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if op == "=":
                lo2, hi2, lo2o, hi2o = const, const, False, False
            elif op in (">", ">="):
                lo2, hi2, lo2o, hi2o = const, None, op == ">", False
            else:  # <, <=
                lo2, hi2, lo2o, hi2o = None, const, False, op == "<"
            if lo2 is not None and (lo is None or lo2 > lo
                                    or (lo2 == lo and lo2o)):
                lo, lo_open = lo2, lo2o
            if hi2 is not None and (hi is None or hi2 < hi
                                    or (hi2 == hi and hi2o)):
                hi, hi_open = hi2, hi2o
        if lo is not None and hi is not None and (
                lo > hi or (lo == hi and (lo_open or hi_open))):
            return 0.0  # contradictory range
        cnt = float(h.not_null_count())
        upper = (h.less_row_count(hi) + (0 if hi_open
                                         else h.equal_row_count(hi))
                 if hi is not None else cnt)
        lower = (h.less_row_count(lo) + (h.equal_row_count(lo)
                                         if lo_open else 0)
                 if lo is not None else 0.0)
        est = max(upper - lower, 0.0)
        return min(1.0, est / max(self.row_count, 1))

    # ---- persistence ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "table_id": self.table_id, "row_count": self.row_count,
            "modify_count": self.modify_count, "version": self.version,
            "columns": {str(k): h.to_dict() for k, h in self.columns.items()},
            "cms": {str(k): s.to_dict() for k, s in self.cms.items()},
            "indices": {str(k): h.to_dict() for k, h in self.indices.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "TableStats":
        d = json.loads(s)
        t = cls(d["table_id"], d["row_count"], d["modify_count"],
                d["version"])
        t.columns = {int(k): Histogram.from_dict(v)
                     for k, v in d["columns"].items()}
        t.cms = {int(k): CMSketch.from_dict(v) for k, v in d["cms"].items()}
        t.indices = {int(k): Histogram.from_dict(v)
                     for k, v in d["indices"].items()}
        return t


def _col_id(e: Expression) -> Optional[int]:
    return getattr(e, "stats_col_id", None)


def _col_const(args) -> tuple:
    a, b = args
    if isinstance(a, ExprColumn) and isinstance(b, Constant):
        return _col_id(a), b.value
    if isinstance(b, ExprColumn) and isinstance(a, Constant):
        return _col_id(b), a.value
    return None, None


# ---- handle (per-storage cache; reference: statistics/handle.go) ----------

def save_stats(storage, stats: TableStats) -> None:
    with _stats_write_lock:
        stats.version = storage.current_version()
        txn = storage.begin()
        txn.set(_STATS_PREFIX + b"%08d" % stats.table_id,
                stats.to_json().encode())
        txn.commit()
        _cache_of(storage)[stats.table_id] = stats


import threading

# serializes read-modify-write of the shared stats record across
# concurrently committing sessions and ANALYZE (reference: the stats
# Handle owns all stats_meta writes behind one collector); RLock because
# update_count_delta calls save_stats under the same lock
_stats_write_lock = threading.RLock()


def update_count_delta(storage, table_id: int, delta: int) -> None:
    """Live row-count maintenance without ANALYZE (reference:
    mysql.stats_meta count/modify_count deltas flushed at commit by the
    session stats collector, picked up by handle.Update) — feeds the
    planner real table sizes so e.g. the TPU row-gate never routes a
    3-row table to an XLA compile."""
    if delta == 0:
        return
    with _stats_write_lock:
        stats = load_stats(storage, table_id)
        if stats is None:
            stats = TableStats(table_id)
        stats.row_count = max(0, stats.row_count + delta)
        stats.modify_count += abs(delta)
        try:
            save_stats(storage, stats)
        except Exception:
            # stats are advisory: a conflicting concurrent writer must
            # never surface an error AFTER the data commit succeeded
            _cache_of(storage).pop(table_id, None)


def set_count(storage, table_id: int, n: int) -> None:
    """Absolute row-count set (bulk loads REPLACE a table's contents);
    one atomic read-modify-write under the stats lock."""
    with _stats_write_lock:
        stats = load_stats(storage, table_id)
        if stats is None:
            stats = TableStats(table_id)
        stats.row_count = max(0, int(n))
        stats.modify_count += 1
        try:
            save_stats(storage, stats)
        except Exception:
            _cache_of(storage).pop(table_id, None)


def drop_stats(storage, table_id: int) -> None:
    """Forget a table's stats (DROP/TRUNCATE TABLE)."""
    txn = storage.begin()
    txn.delete(_STATS_PREFIX + b"%08d" % table_id)
    txn.commit()
    _cache_of(storage).pop(table_id, None)


def load_stats(storage, table_id: int) -> Optional[TableStats]:
    cache = _cache_of(storage)
    hit = cache.get(table_id)
    if hit is not None:
        return hit
    txn = storage.begin()
    try:
        raw = txn.get(_STATS_PREFIX + b"%08d" % table_id)
    except KeyNotFound:
        return None
    finally:
        txn.rollback()
    stats = TableStats.from_json(raw.decode())
    cache[table_id] = stats
    return stats


def _cache_of(storage) -> dict:
    c = getattr(storage, "_stats_cache", None)
    if c is None:
        c = storage._stats_cache = {}
    return c

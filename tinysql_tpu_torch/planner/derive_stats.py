"""Row-estimate derivation over the physical tree.

Capability parity with reference planner/core/stats.go DeriveStats +
explain.go's estRows column: every physical operator carries a row
estimate, derived bottom-up from the access-path estimates the readers
already carry.  These estimates feed (a) the four-column EXPLAIN output
and (b) the device enforcer's row gate (a tiny input never pays an XLA
compile — reference task.go's whole point is that placement is COST
based, not capability based).

Heuristics when histograms can't answer (reference pseudo-stats factors):
selection keeps 0.8 per conjunct (selectionFactor), a group-by column
keeps 0.8 of input NDV-wise, an equi-join yields max(|L|,|R|) rows.
"""
from __future__ import annotations

from .physical import (PhysicalHashAgg, PhysicalHashJoin,
                       PhysicalIndexLookUpReader, PhysicalIndexReader,
                       PhysicalLimit, PhysicalMemTable, PhysicalMergeJoin,
                       PhysicalPlan, PhysicalProjection, PhysicalSelection,
                       PhysicalSort, PhysicalTableDual, PhysicalTableReader,
                       PhysicalTopN)

# single source for the reference's selectionFactor tuning constant
from ..statistics.table_stats import DEFAULT_SELECTIVITY as SELECTION_FACTOR

GROUP_NDV_FACTOR = 0.8   # pseudo NDV of one group-by column
MEMTABLE_ROWS = 100.0    # virtual INFORMATION_SCHEMA tables are tiny


def _set(p: PhysicalPlan, rows: float) -> None:
    p.stats_row_count = max(float(rows), 0.0)
    p.has_estimate = True


def derive_stats(p: PhysicalPlan) -> PhysicalPlan:
    """Bottom-up estimate fill.  Readers keep their access-path estimates
    (set in access.py with residual-filter selectivity applied)."""
    for c in p.children:
        derive_stats(c)
    if isinstance(p, (PhysicalTableReader, PhysicalIndexReader,
                      PhysicalIndexLookUpReader)):
        return p  # already estimated from the chosen access path
    if isinstance(p, PhysicalTableDual):
        _set(p, p.row_count)
        return p
    if isinstance(p, PhysicalMemTable):
        _set(p, MEMTABLE_ROWS)
        return p
    child = p.children[0].stats_row_count if p.children else 0.0
    if isinstance(p, PhysicalSelection):
        _set(p, child * (SELECTION_FACTOR ** max(len(p.conditions), 1)))
    elif isinstance(p, PhysicalProjection):
        _set(p, child)
    elif isinstance(p, PhysicalHashAgg):
        if not p.group_by:
            _set(p, 1.0)
        else:
            # pseudo NDV product, capped by input size
            _set(p, min(child, max(1.0,
                                   child * (GROUP_NDV_FACTOR
                                            ** len(p.group_by)))))
    elif isinstance(p, (PhysicalHashJoin, PhysicalMergeJoin)):
        left = p.children[0].stats_row_count
        right = p.children[1].stats_row_count
        if p.tp in ("semi", "anti"):
            # semi/anti joins filter the left side: output <= left rows
            # (reference stats.go semi-join selectionFactor)
            frac = SELECTION_FACTOR if p.tp == "semi" \
                else 1.0 - SELECTION_FACTOR
            _set(p, left * frac)
            return p
        if getattr(p, "left_keys", None):
            rows = max(left, right)
        else:
            rows = left * right  # cross join
        n_other = len(getattr(p, "other_conditions", []) or [])
        rows *= SELECTION_FACTOR ** n_other
        if p.tp == "left":
            rows = max(rows, left)  # every outer row survives
        _set(p, rows)
    elif isinstance(p, PhysicalSort):
        _set(p, child)
    elif isinstance(p, (PhysicalTopN, PhysicalLimit)):
        _set(p, min(child, float(p.count)))
    else:
        _set(p, child)
    return p

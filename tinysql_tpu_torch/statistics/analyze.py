"""ANALYZE TABLE: collect per-column histograms, CMSketch, FMSketch NDV.

Capability parity with reference executor/analyze.go (:44-470 — column
pushdown tasks, result merge) + statistics/builder.go, redesigned
columnar-first: when the columnar replica is available the whole column is
sampled vectorized; otherwise per-region analyze tasks run through the
coprocessor (reservoir samples + CMSketch + FMSketch partials, merged at
root with live-count weighting).  Results persist through
statistics/table_stats.py (the mysql.stats_* analogue).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..catalog.model import TableInfo
from ..mytypes import EvalType
from .histogram import Histogram
from .sketches import CMSketch, ReservoirSampler
from .table_stats import TableStats, load_stats, save_stats

SAMPLE_CAP = 100_000
MAX_BUCKETS = 64


def analyze_table(session, info: TableInfo) -> TableStats:
    storage = session.storage
    from ..columnar.store import replica_for_read
    txn = storage.begin()
    try:
        rep = replica_for_read(storage, txn, info.id)
        if rep is not None:
            stats = _analyze_columnar(info, rep)
        else:
            stats = _analyze_distributed(storage, info, txn)
    finally:
        txn.rollback()
    save_stats(storage, stats)
    return stats


def _analyze_distributed(storage, info: TableInfo, txn) -> TableStats:
    """Per-region analyze tasks merged at root (reference:
    executor/analyze.go pushdown builders :171,318 + result merge
    :251-316; region partials carry samples + CMSketch + FMSketch)."""
    from ..codec import tablecodec
    from ..distsql import DAGRequest, ScanInfo, select
    from ..distsql.exprpb import _ft_to_pb
    cols = info.public_columns()
    req = DAGRequest(
        start_ts=txn.start_ts,
        scan=ScanInfo(
            table_id=info.id,
            col_ids=[c.id for c in cols],
            col_fts=[_ft_to_pb(c.ft) for c in cols],
            col_defaults=[c.default for c in cols],
            handle_slots=[],
            pk_id=(info.get_pk_handle_col().id
                   if info.get_pk_handle_col() else None)),
        analyze=True)
    stats = TableStats(info.id, row_count=0)
    # keep PER-REGION partials: regions of different sizes contribute to
    # the final sample proportionally to their live counts (reference:
    # statistics.MergeSampleCollector's weighted merge), otherwise a
    # 10k-row region would weigh as much as a 1M-row one
    parts: Dict[int, list] = {}
    for batch in select(storage, req,
                        [tablecodec.record_range(info.id)]):
        for part in batch:
            stats.row_count += part["rows"]
            for cid, p in part["cols"].items():
                parts.setdefault(cid, []).append(p)
    rng = np.random.default_rng(0)
    for cid, plist in parts.items():
        live = sum(p["live"] for p in plist)
        nulls = sum(p["nulls"] for p in plist)
        target = min(SAMPLE_CAP, live)
        samples: list = []
        for p in plist:
            if live == 0 or not p["samples"]:
                continue
            want = max(1, round(target * p["live"] / live))
            src = p["samples"]
            if want >= len(src):
                samples.extend(src)
            else:
                idx = rng.choice(len(src), want, replace=False)
                samples.extend(src[i] for i in idx)
        cms = plist[0]["cms"]
        fm = plist[0]["fm"]
        for p in plist[1:]:
            cms.merge(p["cms"])
            fm.merge(p["fm"])
        scale = max(1.0, live / max(len(samples), 1))
        h = Histogram.build(cid, samples, null_count=nulls,
                            max_buckets=MAX_BUCKETS)
        _scale_histogram(h, scale, live + nulls, nulls)
        h.ndv = max(h.ndv, fm.ndv() if scale > 1 else h.ndv)
        stats.columns[cid] = h
        stats.cms[cid] = cms
    return stats


def _analyze_columnar(info: TableInfo, rep) -> TableStats:
    stats = TableStats(info.id, row_count=rep.n_rows)
    rng = np.random.default_rng(0)
    for c in info.public_columns():
        if c.id not in rep.columns:
            continue
        v, m = rep.columns[c.id]
        n = len(v)
        null_count = int(m.sum())
        if n > SAMPLE_CAP:
            idx = rng.choice(n, SAMPLE_CAP, replace=False)
            sv, sm = v[idx], m[idx]
            scale = n / SAMPLE_CAP
        else:
            sv, sm = v, m
            scale = 1.0
        uns = c.ft.eval_type is EvalType.INT and c.ft.is_unsigned
        vals = []
        for i in range(len(sv)):
            if sm[i]:
                continue
            x = sv[i].item() if hasattr(sv[i], "item") else sv[i]
            if uns and isinstance(x, int) and x < 0:
                x += 1 << 64  # unwrap wrapped uint64: match the row path's
                # decoded semantic values so both ANALYZE paths agree
            vals.append(x)
        if c.ft.eval_type is EvalType.STRING:
            vals = [str(x) for x in vals]
        h = Histogram.build(c.id, vals,
                            null_count=int(null_count / max(scale, 1)),
                            max_buckets=MAX_BUCKETS)
        _scale_histogram(h, scale, n, null_count)
        stats.columns[c.id] = h
        cms = CMSketch()
        for x in vals:
            cms.insert(x)
        if scale > 1:
            cms.table = (cms.table.astype(np.float64) * scale).astype(np.uint32)
            cms.count = int(cms.count * scale)
        stats.cms[c.id] = cms
    return stats


def _scale_histogram(h: Histogram, scale: float, total: int,
                     null_count: int) -> None:
    if scale <= 1.0:
        return
    for b in h.buckets:
        b.count = int(b.count * scale)
        b.repeat = max(1, int(b.repeat * scale))
    h.ndv = min(int(h.ndv * scale), total)
    h.total_count = total
    h.null_count = null_count


def table_row_count(storage, table_id: int) -> int:
    s = load_stats(storage, table_id)
    return s.row_count if s else 0

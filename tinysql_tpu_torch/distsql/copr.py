"""Storage-side coprocessor interpreter (reference:
mocktikv/cop_handler_dag.go:49-160 + executor.go/aggregate.go/topn.go —
the row-at-a-time reference interpreter, here chunk-vectorized: the scan
decodes into a Chunk and the pushed chain runs the same numpy builtins the
root executor uses).

Installed on the RPC client as `cop_handler`; one call = one region's worth
of one DAGRequest.  Lock conflicts surface as KeyIsLocked and are resolved
by the client (store/tikv semantics).
"""
from __future__ import annotations

from typing import List, Optional

from ..chunk import Chunk
from ..codec import rowcodec, tablecodec
from ..expression import vectorized_filter
from ..expression.aggregation import AggFuncDesc, AggMode
from ..mytypes import FieldType
from .exprpb import _ft_from_pb, pb_to_expr
from .request import DAGRequest


def make_cop_handler(mvcc):
    def handle(region, task) -> list:
        req: DAGRequest = task["req"]
        start, end = task["range"]
        s = max(start, region.start)
        e = min(end, region.end) if region.end else end
        pairs = mvcc.scan(s, e, req.start_ts, 0, req.resolved)
        return run_dag(req, _decode_chunk(req, pairs))
    return handle


def _decode_chunk(req: DAGRequest, pairs) -> Chunk:
    scan = req.scan
    fts = [_ft_from_pb(d) for d in scan.col_fts]
    chk = Chunk(fts, cap=max(len(pairs), 1))
    for k, v in pairs:
        if not tablecodec.is_record_key(k):
            continue
        _, handle = tablecodec.decode_record_key(k)
        row = rowcodec.decode_row_to_datums(
            v, scan.col_ids, fts, defaults=scan.col_defaults)
        for slot in scan.handle_slots:
            row[slot] = handle
        if scan.pk_id is not None:
            for i, cid in enumerate(scan.col_ids):
                if cid == scan.pk_id:
                    row[i] = handle
        chk.append_row(row)
    return chk


def run_dag(req: DAGRequest, chk: Chunk) -> list:
    """Execute the pushed chain over decoded rows; returns output rows as
    plain value lists (the 'tipb.SelectResponse chunk' analogue)."""
    import numpy as np
    if req.analyze:
        return _analyze_partial(req, chk)
    if req.filters:
        conds = [pb_to_expr(d) for d in req.filters]
        if chk.num_rows():
            mask = vectorized_filter(conds, chk)
            chk.set_sel(np.nonzero(mask)[0])
            chk = chk.compact()
    if req.agg is not None:
        return _partial_agg(req.agg, chk)
    rows = [list(chk.get_row(i)) for i in range(chk.num_rows())]
    if req.topn is not None:
        rows = _topn(req.topn, chk, rows)
    if req.limit is not None:
        rows = rows[:req.limit]
    return rows


ANALYZE_REGION_SAMPLES = 10_000


def _analyze_partial(req: DAGRequest, chk: Chunk) -> list:
    """Per-region ANALYZE task (reference: tipb.AnalyzeReq handled by
    mocktikv/analyze.go): per scan column, one ReservoirSampler pass
    producing the bounded uniform sample + null count + CMSketch +
    FMSketch partials for the root's weighted merge."""
    from ..statistics.sketches import ReservoirSampler
    n = chk.num_rows()
    out_cols = {}
    for cid, col in zip(req.scan.col_ids, chk.columns):
        rs = ReservoirSampler(ANALYZE_REGION_SAMPLES)
        null = col.null_mask()
        for i in range(n):
            rs.collect(None if null[i] else col.get(i))
        out_cols[cid] = {
            "nulls": rs.null_count,
            "live": rs.seen,
            "samples": rs.samples,
            "cms": rs.cms,
            "fm": rs.fm,
        }
    return [{"rows": n, "cols": out_cols}]


def _parse_agg_pb(agg_pb: dict):
    gb = [pb_to_expr(d) for d in agg_pb["group_by"]]
    descs = [AggFuncDesc(a["name"], [pb_to_expr(x) for x in a["args"]],
                         AggMode.PARTIAL1, a["distinct"],
                         _ft_from_pb(a["ret"]) if "ret" in a else None)
             for a in agg_pb["aggs"]]
    return gb, descs


def _partial_agg_pairs(agg_pb: dict, chk: Chunk):
    """Columnar per-region PARTIAL1 aggregation: factorize group keys,
    bincount/reduce-at per aggregate.  Returns (pairs, uns_flags) where
    pairs = [(np values, np null)] per output column (group keys then
    partial-state columns, RAW int64 representation for wrapped unsigned)
    and uns_flags marks which columns hold wrapped unsigned ints — or
    None for shapes numpy cannot reduce (DISTINCT, string min/max)."""
    import numpy as np
    gb, descs = _parse_agg_pb(agg_pb)
    n = chk.num_rows()
    if n == 0:
        return [], []
    if any(d.distinct for d in descs):
        return None

    # ---- factorize the group keys -------------------------------------
    codes = np.zeros(n, dtype=np.int64)
    key_cols = []
    total = 1
    for e in gb:
        v, null = e.vec_eval(chk)
        raw = v
        if v.dtype == object:
            v = np.where(null, "", v).astype(str)
        kc, inv = np.unique(v, return_inverse=True)
        # null gets its own code (one extra bin)
        inv = np.where(null, len(kc), inv)
        total *= len(kc) + 1
        if total > (1 << 62):  # composite code would overflow int64
            return None
        codes = codes * (len(kc) + 1) + inv
        key_cols.append((raw, null))
    uniq, gid, counts = np.unique(codes, return_inverse=True,
                                  return_counts=True)
    ng = len(uniq)
    first_idx = np.full(ng, n, dtype=np.int64)
    np.minimum.at(first_idx, gid, np.arange(n))

    pairs = []
    uns_flags = []
    for v, null in key_cols:
        pairs.append((v[first_idx], null[first_idx]))
        uns_flags.append(False)
    for d in descs:
        cols = _vector_partial(d, chk, gid, ng, first_idx)
        if cols is None:
            return None
        for v, nl, uns in cols:
            pairs.append((v, nl))
            uns_flags.append(uns)
    return pairs, uns_flags


def _partial_agg(agg_pb: dict, chk: Chunk) -> list:
    """Per-region PARTIAL1 aggregation as rows (the wire-path shape,
    reference mocktikv/aggregate.go); row-at-a-time only for shapes
    numpy cannot reduce."""
    import numpy as np
    got = _partial_agg_pairs(agg_pb, chk)
    if got is None:
        gb, descs = _parse_agg_pb(agg_pb)
        return _partial_agg_rows(gb, descs, chk)
    pairs, uns_flags = got
    if not pairs:
        return []
    cols_py = []
    for (v, nl), uns in zip(pairs, uns_flags):
        lst = v.tolist()
        if uns:
            lst = [x + (1 << 64) if x < 0 else x for x in lst]
        for i in np.nonzero(nl)[0]:
            lst[i] = None
        cols_py.append(lst)
    return [list(t) for t in zip(*cols_py)]


def partial_agg_chunk(agg_pb: dict, chk: Chunk,
                      fts: List[FieldType]) -> Optional[Chunk]:
    """Columnar partial aggregation straight into a Chunk — the
    in-process replica fast path (no per-row marshalling).  Wrapped
    unsigned values stay raw; `fts` carries the unsigned flags.  Falls
    back to the row interpreter for unsupported shapes."""
    from ..chunk import Column as CCol
    got = _partial_agg_pairs(agg_pb, chk)
    if got is None:
        rows = _partial_agg(agg_pb, chk)
        out = Chunk(fts, cap=max(len(rows), 1))
        for r in rows:
            out.append_row(r)
        return out
    pairs, _uns = got
    if not pairs:
        return Chunk(fts, cap=1)
    return Chunk.from_columns(
        [CCol.from_numpy(ft, v, nl) for ft, (v, nl) in zip(fts, pairs)])


def _vector_partial(d: AggFuncDesc, chk: Chunk, gid, ng, first_idx):
    """Vectorized partial state columns for one descriptor as
    [(values, null, is_wrapped_unsigned)], or None when the shape needs
    the row fallback."""
    import numpy as np
    from ..expression import Constant
    name = d.name
    if name == "count":
        a = d.args[0]
        if isinstance(a, Constant):
            live = np.ones(len(gid), dtype=bool) if a.value is not None \
                else np.zeros(len(gid), dtype=bool)
        else:
            v, null = a.vec_eval(chk)
            live = ~null
        cnt = np.bincount(gid, weights=live.astype(np.float64),
                          minlength=ng).astype(np.int64)
        return [(cnt, np.zeros(ng, dtype=bool), False)]
    if name == "sum":
        v, null = d.args[0].vec_eval(chk)
        if v.dtype == object or v.dtype.kind == "U":
            return None
        uns = d.args[0].ret_type.is_unsigned and v.dtype == np.int64
        is_real = d.ret_type.eval_type.name == "REAL"
        live = ~null
        cnt = np.bincount(gid, weights=live.astype(np.float64),
                          minlength=ng).astype(np.int64)
        if is_real:
            w = np.where(live, v.astype(np.float64), 0.0)
            if uns:
                w = np.where(live & (v < 0), w + 2.0**64, w)
            s = np.bincount(gid, weights=w, minlength=ng)
            return [(s, cnt == 0, False)]
        # int sums: exact mod-2^64 accumulation via int64 reduce-at
        s = np.zeros(ng, dtype=np.int64)
        with np.errstate(over="ignore"):
            np.add.at(s, gid[live], v[live])
        return [(s, cnt == 0, uns)]
    if name in ("max", "min"):
        v, null = d.args[0].vec_eval(chk)
        if v.dtype == object or v.dtype.kind == "U":
            return None  # string min/max: row fallback
        uns = d.args[0].ret_type.is_unsigned and v.dtype == np.int64
        work = v ^ np.int64(-2**63) if uns else v
        live = ~null
        if v.dtype == np.int64:
            fill = np.iinfo(np.int64).max if name == "min" \
                else np.iinfo(np.int64).min
        else:
            fill = np.inf if name == "min" else -np.inf
        acc = np.full(ng, fill, dtype=work.dtype)
        op = np.minimum if name == "min" else np.maximum
        op.at(acc, gid[live], work[live])
        cnt = np.bincount(gid, weights=live.astype(np.float64),
                          minlength=ng).astype(np.int64)
        if uns:
            acc = acc ^ np.int64(-2**63)  # back to the raw wrapped form
        return [(acc, cnt == 0, uns)]
    if name == "first_row":
        v, null = d.args[0].vec_eval(chk)
        return [(v[first_idx], null[first_idx], False)]
    return None  # avg never appears: split() emits sum+count partials


def _partial_agg_rows(gb, descs, chk: Chunk) -> list:
    """Row-at-a-time fallback (the mocktikv-style interpreter)."""
    from ..executor.aggfuncs import new_state
    n = chk.num_rows()
    groups = {}
    order = []
    rows = [chk.get_row(i) for i in range(n)]
    for i in range(n):
        key = tuple(_sem(v) for v in (e.eval(rows[i]) for e in gb))
        st = groups.get(key)
        if st is None:
            st = groups[key] = [new_state(d) for d in descs]
            order.append(key)
        for j, d in enumerate(descs):
            st[j].update([a.eval(rows[i]) for a in d.args])
    out = []
    for key in order:
        row = list(key)
        for st in groups[key]:
            row.extend(st.partial())
        out.append(row)
    return out


def _sem(v):
    return v.item() if hasattr(v, "item") else v


def _topn(topn_pb: dict, chk: Chunk, rows: list) -> list:
    from ..mytypes import sort_key
    by = [(pb_to_expr(d), desc) for d, desc in topn_pb["by"]]

    def key_fn(row):
        ks = []
        for e, desc in by:
            v = e.eval(row)
            if v is None:
                ks.append((0 if not desc else 2, 0))
            else:
                sk = sort_key(v)
                ks.append((1, _Rev(sk) if desc else sk))
        return ks
    rows = sorted(rows, key=key_fn)
    return rows[:topn_pb["n"]]


class _Rev:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v
